"""int8 GEMM with a fused dequantizing epilogue (counterpart of
bigdl_tpu/kernels/quantized_matmul.py).

`int8_matmul` launches the hand-written CUDA kernel
`csrc/quantized_matmul.cu` (int8 tensor-core MMAs) for CUDA tensors and
takes the plain version `int8_matmul_plain` for CPU tensors; on any
other device it raises.
Both compute ``(float(xq @ wq) * x_scale) * w_scale`` with the integer
sum exact, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.kernels import _native


def _scale_vector(s, n: int, device) -> torch.Tensor:
    """A scalar or broadcastable scale as a contiguous fp32 (n,) vector."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    return torch.broadcast_to(s.reshape(-1) if s.ndim else s,
                              (n,)).contiguous()


def int8_matmul_plain(xq, wq, x_scale, w_scale) -> torch.Tensor:
    """The plain version. On the CPU the sum runs in int32; CUDA has no
    int32 matmul, so there it runs in float64, which is exact here
    (|sum| <= 127^2 * K < 2^53 for any K below 5e11) and rounds to fp32
    exactly as the int32 -> fp32 conversion does."""
    m, n = xq.shape[0], wq.shape[1]
    if xq.device.type == "cuda":
        acc = (xq.double() @ wq.double()).float()
    else:
        acc = (xq.int() @ wq.int()).float()
    sx = _scale_vector(x_scale, m, xq.device)[:, None]
    sw = _scale_vector(w_scale, n, xq.device)[None, :]
    return acc * sx * sw


def _lib():
    lib = _native.load("quantized_matmul")
    fn = lib.bigdl_int8_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(xq, wt) -> bool:
    """Whether the cp.async body takes these operands: K a multiple of
    16 and both 16-byte aligned. Otherwise the byte-loading body runs;
    both feed the same tensor-core MMAs."""
    return (xq.shape[1] % 16 == 0 and xq.data_ptr() % 16 == 0
            and wt.data_ptr() % 16 == 0)


def kernel_body(xq, wt) -> str:
    """Which body `int8_matmul` launches for xq (M, K) and wt (N, K)."""
    return "mma.sync s8, cp.async ring" if _aligned(xq, wt) else \
        "mma.sync s8, byte loads"


def kernel_usage(xq, wt) -> dict:
    """Registers and local (spilled) bytes a thread, and dynamic shared
    memory a block, of the body `int8_matmul` launches for these
    operands (CUDA only)."""
    fn = _native.load("quantized_matmul").bigdl_int8_matmul_usage
    vals = [ctypes.c_int() for _ in range(3)]
    _native.check(fn(int(_aligned(xq, wt)), *map(ctypes.byref, vals)),
                  "int8_matmul usage")
    return dict(zip(("registers", "local_bytes", "shared_bytes"),
                    (v.value for v in vals)))


def int8_matmul(xq, wq, x_scale, w_scale, *, wq_t=None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) fp32, dequantized by `x_scale`
    (M, 1) and `w_scale` (1, N) fp32 (scalars broadcast).

    The CUDA kernel reads the weight K-contiguous, as `wq_t` (N, K). The
    serving path passes the copy QuantizedLinear keeps; without one the
    transpose is made here, per call."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_matmul wants (M, K) @ (K, N), got "
                         f"{tuple(xq.shape)} @ {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {xq.dtype} "
                        f"and {wq.dtype}")
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq, x_scale, w_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {xq.device}")
    m, k = xq.shape
    n = wq.shape[1]
    wt = wq.t().contiguous() if wq_t is None else wq_t
    if wt.shape != (n, k) or wt.dtype != torch.int8:
        raise ValueError(f"wq_t must be int8 (N, K) = ({n}, {k}), got "
                         f"{wt.dtype} {tuple(wt.shape)}")
    if wt.device != xq.device or wq.device != xq.device:
        raise ValueError("int8_matmul operands must lie on one device")
    if not (xq.is_contiguous() and wt.is_contiguous()):
        raise ValueError("the CUDA int8_matmul kernel takes contiguous "
                         "operands")
    sx = _scale_vector(x_scale, m, xq.device)
    sw = _scale_vector(w_scale, n, xq.device)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return out
    rc = _lib()(xq.data_ptr(), wt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                out.data_ptr(), m, n, k, int(_aligned(xq, wt)),
                *_native.device_and_stream(xq.device))
    _native.check(rc, "int8_matmul")
    int8_matmul.launches.add()
    return out


int8_matmul.launches = _native.LaunchCounter()


def quantized_linear_forward(x, weight_q, weight_scale, bias=None,
                             input_scale=None, *, weight_q_t=None):
    """Dynamic-or-calibrated int8 linear through `int8_matmul`.

    x (..., K) float; weight_q (K, N) int8; weight_scale broadcastable
    to (1, N); `weight_q_t` the optional (N, K) copy for the kernel.
    Returns (..., N) in x's dtype."""
    # one quantization scheme with the module (scale floor, clip range)
    from bigdl_tpu_torch.nn.quantized import _dynamic_input_scale
    orig_dtype = x.dtype
    lead = x.shape[:-1]
    k = x.shape[-1]
    xf = x.float().reshape(-1, k)
    if input_scale is not None:
        sx = torch.full((xf.shape[0], 1), float(input_scale),
                        dtype=torch.float32, device=xf.device)
    else:
        sx = _dynamic_input_scale(xf, sample_axes=(-1,))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    sw = weight_scale.float().reshape(1, -1)
    y = int8_matmul(xq, weight_q, sx, sw, wq_t=weight_q_t)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, y.shape[-1]).to(orig_dtype)
