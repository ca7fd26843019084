"""Cut cross-entropy (counterpart of bigdl_tpu/kernels/cut_cross_entropy.py):
the per-row LM loss of a tied head, lse(h . w^T) - h . w[label], without
the (N, V) logits in device memory.

`cut_cross_entropy(h, w, labels)` is a `torch.autograd.Function` whose
forward launches K3a (`cce_lse`, the per-row logsumexp) and whose
backward launches K3b (`cce_dh`) and K3c (`cce_dw`), the hand-written
CUDA kernels of `csrc/cut_cross_entropy.cu`. All three run their
products on the tensor cores in 3xTF32 (each fp32 operand split into two
TF32 parts, three TF32 products), which keeps fp32 accuracy (LSE_TOL and
CCE_TOL in the tests) and never reads PyTorch's TF32 flags. K3a is a
GEMM tile with an online-logsumexp epilogue; K3b and K3c are one body
with the roles of h and w swapped. They take any D >= 1.
The label terms stay outside the kernels, as in the reference: the
gather-dot `h . w[labels]` in the forward, `dh -= g w[labels]` and the
scatter-add `dw[labels] -= g h` in the backward.

Each kernel wrapper launches its kernel for CUDA tensors, takes its plain
PyTorch version (`cce_lse_plain`, `cce_dh_plain`, `cce_dw_plain`, which
hold the dense (N, V) probabilities) for CPU tensors, and raises on any
other device. `cut_cross_entropy_plain` is the whole loss computed
densely, differentiable by autograd: the oracle of the tests and of
chip_smoke.py.

`block_n`/`block_v` are the reference's Pallas tile sizes (default 128
and 512, its autotune defaults). The CUDA kernels choose their own tiles;
`block_n` keeps the reference's contract that N is a multiple of
min(block_n, N), which the pipelined LM meets by padding its rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from bigdl_tpu_torch.kernels import _native

BLOCK_N, BLOCK_V = 128, 512
# the kernels' tiles (csrc/cut_cross_entropy.cu): K3a computes S for 128
# h rows x 128 vocab rows a block and walks the vocab in 128-row tiles;
# K3b owns 32 h rows (16 when D > 768) and walks the vocab in 32-row
# tiles, one block per SM (K3c the same with the roles of h and w
# swapped); past D = 1024 a grid axis cuts K3b's and K3c's gradient
# into 1024-column chunks (the bodies report their rows and chunks:
# dh_kernel_usage)
LSE_ROWS, LSE_VOCAB_TILE = 128, 128
DH_VOCAB_TILE = 32
# blocks a K3a launch aims for, per SM (one is resident at a time, so
# this many waves), when it splits the vocab walk
LSE_BLOCKS_PER_SM = 4


def _probs(h, w, lse, g):
    return torch.exp(h @ w.T - lse[:, None]) * g[:, None]


def cce_lse_plain(h, w):
    """(N,) logsumexp over the vocab of h @ w.T."""
    return torch.logsumexp(h @ w.T, dim=-1)


def cce_dh_plain(h, w, lse, g):
    """(N, D): sum_v exp(h . w_v - lse) g w_v."""
    return _probs(h, w, lse, g) @ w


def cce_dw_plain(h, w, lse, g):
    """(V, D): sum_n exp(h_n . w - lse_n) g_n h_n."""
    return _probs(h, w, lse, g).T @ h


def _label_logit(h, w, labels):
    return torch.sum(h * w[labels], dim=-1)


def cut_cross_entropy_plain(h, w, labels):
    """The same loss with the dense (N, V) logits, differentiable by
    autograd."""
    return cce_lse_plain(h, w) - _label_logit(h, w, labels)


def _fn(name, argtypes):
    fn = getattr(_native.load("cut_cross_entropy"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(h, w, *vectors):
    if h.device.type != "cuda":
        raise ValueError(f"cut_cross_entropy runs on cuda or cpu, not "
                         f"{h.device}")
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"cut_cross_entropy wants h (N, D) and w (V, D); "
                         f"got {tuple(h.shape)}, {tuple(w.shape)}")
    for t in (h, w, *vectors):
        if t.device != h.device:
            raise ValueError("cut_cross_entropy's tensors must lie on one "
                             "device")
        if t.dtype != torch.float32:
            raise TypeError("the CUDA cut cross-entropy kernels take fp32")
        if not t.is_contiguous():
            raise ValueError("the CUDA cut cross-entropy kernels take "
                             "contiguous tensors")
    for t in vectors:
        if t.shape != (h.shape[0],):
            raise ValueError(f"lse and g must be ({h.shape[0]},), got "
                             f"{tuple(t.shape)}")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lse_splits(n, v, device):
    """How many chunks to cut K3a's vocab walk into so that the launch
    has about LSE_BLOCKS_PER_SM blocks per SM (at most one chunk per
    tile): 33 at N = 2048, V = 50257 on 132 SMs, 4 waves of 132."""
    row_tiles = -(-n // LSE_ROWS)
    return max(1, min(-(-v // LSE_VOCAB_TILE),
                      -(-LSE_BLOCKS_PER_SM * _sms(device) // row_tiles)))


def dh_splits(n, v, d, sms):
    """How many chunks to cut K3b's vocab walk into. A block fills an SM
    (its shared memory), so as many chunks as one wave of `sms` blocks
    holds whole (at least one, at most one a vocab tile). The body for d
    gives its rows a block and its blocks along D (CUDA only)."""
    use = dh_kernel_usage(d)
    blocks = -(-n // use["rows"]) * use["d_chunks"]
    return max(1, min(-(-v // DH_VOCAB_TILE), sms // blocks))


def cce_lse(h, w):
    """K3a: (N,) logsumexp of h @ w.T over the vocab."""
    if h.device.type == "cpu":
        return cce_lse_plain(h, w)
    _check(h, w)
    n, d = h.shape
    v = w.shape[0]
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    if n == 0:
        return lse
    splits = _lse_splits(n, v, h.device)
    scratch = torch.empty(2 * splits * n, dtype=torch.float32,
                          device=h.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    rc = _fn("bigdl_cce_lse_f32", [p, p, p, p, i, i, i, i, i, p])(
        h.data_ptr(), w.data_ptr(), lse.data_ptr(), scratch.data_ptr(), n, v,
        d, splits, *_native.device_and_stream(h.device))
    _native.check(rc, "cce_lse")
    cce_lse.launches.add()
    return lse


def cce_dh(h, w, lse, g):
    """K3b: (N, D) gradient of the softmax part w.r.t. h."""
    if h.device.type == "cpu":
        return cce_dh_plain(h, w, lse, g)
    _check(h, w, lse, g)
    n, d = h.shape
    v = w.shape[0]
    dh = torch.empty_like(h)
    if n == 0:
        return dh
    splits = dh_splits(n, v, d, _sms(h.device))
    scratch = torch.empty(splits * n * d, dtype=torch.float32,
                          device=h.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    rc = _fn("bigdl_cce_dh_f32", [p, p, p, p, p, p, i, i, i, i, i, p])(
        h.data_ptr(), w.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dh.data_ptr(), scratch.data_ptr(), n, v, d, splits,
        *_native.device_and_stream(h.device))
    _native.check(rc, "cce_dh")
    cce_dh.launches.add()
    return dh


@functools.lru_cache(maxsize=None)
def _usage_values(name: str, d: int) -> tuple:
    fn = _fn(f"bigdl_{name}_usage", [ctypes.c_int] + [ctypes.c_void_p] * 5)
    vals = [ctypes.c_int() for _ in range(5)]
    _native.check(fn(d, *map(ctypes.byref, vals)), f"{name} usage")
    return tuple(v.value for v in vals)


def _usage(name: str, d: int) -> dict:
    return dict(zip(("registers", "local_bytes", "shared_bytes", "rows",
                     "d_chunks"), _usage_values(name, d)))


def lse_kernel_usage(d: int) -> dict:
    """Registers and local (spilled) bytes a thread, shared memory bytes
    (as the runtime reports them) and h rows a block, and blocks along D,
    of the K3a body for width d (CUDA only; one body serves every d)."""
    return _usage("cce_lse", d)


def dh_kernel_usage(d: int) -> dict:
    """Registers and local (spilled) bytes a thread, shared memory bytes
    (as the runtime reports them) and h rows a block, and blocks along D,
    of the K3b body for width d (CUDA only)."""
    return _usage("cce_dh", d)


def dw_kernel_usage(d: int) -> dict:
    """The same for the K3c body (its rows are w rows)."""
    return _usage("cce_dw", d)


def cce_dw(h, w, lse, g):
    """K3c: (V, D) gradient of the softmax part w.r.t. w."""
    if h.device.type == "cpu":
        return cce_dw_plain(h, w, lse, g)
    _check(h, w, lse, g)
    n, d = h.shape
    v = w.shape[0]
    dw = torch.empty_like(w)
    if v == 0:
        return dw
    p, i = ctypes.c_void_p, ctypes.c_int
    rc = _fn("bigdl_cce_dw_f32", [p, p, p, p, p, i, i, i, i, p])(
        h.data_ptr(), w.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dw.data_ptr(), n, v, d, *_native.device_and_stream(h.device))
    _native.check(rc, "cce_dw")
    cce_dw.launches.add()
    return dw


cce_lse.launches = _native.LaunchCounter()
cce_dh.launches = _native.LaunchCounter()
cce_dw.launches = _native.LaunchCounter()


class _CutCrossEntropyFn(torch.autograd.Function):
    """Forward K3a plus the label gather-dot; backward K3b and K3c plus
    the label terms. Saves h, w, labels and lse, the residuals of the
    reference's `_cce_fwd`."""

    @staticmethod
    def forward(ctx, h, w, labels):
        lse = cce_lse(h, w)
        ctx.save_for_backward(h, w, labels, lse)
        return lse - _label_logit(h, w, labels)

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = cce_dh(h, w, lse, g) - g[:, None] * w[labels]
        if ctx.needs_input_grad[1]:
            dw = cce_dw(h, w, lse, g)
            dw.index_add_(0, labels, -(g[:, None] * h))
        return dh, dw, None


def cut_cross_entropy(h, w, labels, block_n: Optional[int] = None,
                      block_v: Optional[int] = None):
    """Per-row negative log-likelihood of `labels` under the logits
    h @ w.T, without materializing them: h (N, D), w (V, D), labels (N,)
    integer -> (N,) fp32, differentiable in h and w. N must be a multiple
    of min(block_n, N) (block sizes default to 128 and 512); V and D need
    not divide anything, and any D >= 1 runs on CUDA."""
    block_n = BLOCK_N if block_n is None else block_n
    block_v = BLOCK_V if block_v is None else block_v
    if block_n < 1 or block_v < 1:
        raise ValueError(f"block sizes must be positive, got {block_n}, "
                         f"{block_v}")
    n = h.shape[0]
    bn = min(block_n, n)
    if bn and n % bn:
        raise ValueError(f"N={n} must be a multiple of block_n={bn}")
    return _CutCrossEntropyFn.apply(h, w, labels.to(torch.long))
