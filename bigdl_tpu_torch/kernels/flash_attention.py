"""Flash attention (counterpart of bigdl_tpu/kernels/flash_attention.py).

`flash_attention` launches the hand-written CUDA kernel
`csrc/flash_attention.cu` for CUDA tensors and takes the plain dense
version `flash_attention_plain` for CPU tensors; on any other device it
raises. The kernel runs both of its products on the tensor cores in
3xTF32 (each fp32 operand split into two TF32 parts, three TF32
products), which keeps fp32 accuracy (FLASH_TOL in the tests) and never
reads PyTorch's TF32 flags; it takes any head dim. It is
differentiable: a `torch.autograd.Function` whose forward
is that call and whose backward recomputes the attention under autograd
and returns its vector-Jacobian product, as the reference's custom_vjp
does (bigdl_tpu/kernels/flash_attention.py `_fwd`/`_bwd`). That backward
is plain jnp in the reference, not a Pallas kernel, so it is plain
PyTorch here too: the kernel runs forward only. The reference recomputes
through blockwise attention, which under jit keeps O(Tq * block) memory;
eager autograd would keep every block's intermediates, so the port
recomputes through the dense `flash_attention_plain` (the same function;
only the summation order differs).

Semantics shared by both versions: q (B, H, Tq, d), k/v (B, H, Tk, d),
fp32; default scale 1/sqrt(d); causal masking is bottom-right aligned
(query i sits at key position Tk - Tq + i); Tq and Tk need not divide
any block size. A query row that sees no key at all (only possible when
causal and Tq > Tk) yields zeros, the `acc / max(l, 1e-30)` rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from bigdl_tpu_torch.kernels import _native
from bigdl_tpu_torch.nn.attention import causal_mask

NEG_INF = -1e30


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None):
    """Dense fp32 softmax attention with the kernel's masking rules."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sc
    if not causal:
        w = torch.softmax(s, dim=-1)
    else:
        mask = causal_mask(q.shape[2], k.shape[2], device=q.device)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        # rows with no visible key are zeroed, as the kernel's l == 0 rows
        w = torch.softmax(s, dim=-1) * mask.any(-1, keepdim=True)
    return torch.matmul(w, v.float()).to(q.dtype)


def _fn(name, argtypes):
    fn = getattr(_native.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _fn("bigdl_flash_attention_fwd_f32",
               [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p])


def kernel_usage(d: int) -> dict:
    """Registers and local (spilled) bytes a thread, dynamic shared
    memory bytes a block, and the columns of d a slice holds, of the
    kernel's body for head dim d (CUDA only)."""
    fn = _fn("bigdl_flash_attention_usage",
             [ctypes.c_int] + [ctypes.c_void_p] * 4)
    vals = [ctypes.c_int() for _ in range(4)]
    _native.check(fn(d, *map(ctypes.byref, vals)), "flash_attention usage")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "cols"),
                    (v.value for v in vals)))


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Fused attention: q (B, H, Tq, d), k/v (B, H, Tk, d) -> (B, H, Tq, d),
    differentiable in q, k and v (recompute backward, see the module
    docstring).

    CUDA tensors must be contiguous fp32; d may be any size."""
    return _FlashAttentionFn.apply(q, k, v, causal, scale)


def _forward(q, k, v, causal, scale):
    """The forward alone: the kernel for CUDA tensors, the plain version
    for CPU tensors. Counts a launch only where it launches."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants 4-D (B, H, T, d) tensors, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, H, Tk, d) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("the CUDA flash_attention kernel takes fp32 q/k/v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA flash_attention kernel takes contiguous "
                         "q/k/v")
    out = torch.empty_like(q)
    if b * h * tq * d == 0:
        return out
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, tq, k.shape[2], d, sc, int(bool(causal)),
                *_native.device_and_stream(q.device))
    _native.check(rc, "flash_attention")
    flash_attention.launches.add()
    return out


def _recompute_vjp(q, k, v, g, causal, scale):
    """(dq, dk, dv) of attention at (q, k, v) against the output
    cotangent `g`: autograd through the dense plain version."""
    with torch.enable_grad():
        qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
        out = flash_attention_plain(qd, kd, vd, causal, scale)
        return torch.autograd.grad(out, (qd, kd, vd), g)


class _FlashAttentionFn(torch.autograd.Function):
    """Forward through the kernel (or its plain version on the CPU);
    backward by the dense recompute. Saves q, k, v, the residuals
    of the reference's `_fwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _recompute_vjp(q, k, v, g, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


flash_attention.launches = _native.LaunchCounter()


class FlashAttention:
    """Callable `attn_impl` for MultiHeadAttention:
    `MultiHeadAttention(d, h, attn_impl=FlashAttention())` (counterpart
    of PallasFlashAttention). causal= only; no masks."""

    def __call__(self, q, k, v, *, mask=None, causal=False):
        if mask is not None:
            raise ValueError("FlashAttention supports causal= only")
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)
