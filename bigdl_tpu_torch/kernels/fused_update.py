"""Fused optimizer update (counterpart of bigdl_tpu/kernels/fused_update.py):
the whole `OptimMethod.update` body (gradient weight decay, slot update,
parameter update) in one pass per element, and for CUDA tensors in ONE
kernel launch over the whole list of leaves.

`fused_update` launches the hand-written CUDA kernel
`csrc/fused_update.cu` (K1) for CUDA tensors and takes the plain version
`fused_update_plain` (`_math` op by op) for CPU tensors; on any other
device it raises. Either way it updates the parameters and slots IN
PLACE, as the reference's Pallas kernel does through
`input_output_aliases`. The kernel walks a device table of leaf
pointers: unlike the reference's flat layout it never concatenates the
leaves (the reference records that its concat/split cost more than it
saved).

`make_update_fn` hands every float leaf to `fused_update` in one call,
so the device of the tensors alone picks the kernel or the plain
version. The reference's flat/leaf layouts existed to avoid a concat on
the TPU; the kernel never concatenates, so there is one path.

Semantics: bit-identical to `method.update` (same elementwise
expressions in the same order, the same fp32 scalars; see
optim/method.py for the rounding of the scalars). Supported methods:
Adam, AdamW, SGD (any momentum/dampening/nesterov); anything else
returns None from `make_update_fn` and the trainer keeps
`method.update`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.kernels import _native
from bigdl_tpu_torch.optim.method import (as_lr, bias_correction,
                                          device_scalar)

_KINDS = {"adam": 0, "adamw": 1, "sgd": 2}


# ------------------------------------------------------------- descriptors
def describe(method) -> Optional[Tuple[str, Dict]]:
    """(kind, hyper) for a supported OptimMethod instance, else None.
    Exact type checks: a subclass overriding `update` must not be
    rerouted through the fused math."""
    from bigdl_tpu_torch.optim.method import SGD, Adam, AdamW
    t = type(method)
    if t is AdamW:
        return "adamw", {"b1": method.beta1, "b2": method.beta2,
                         "eps": method.epsilon, "wd": method.weight_decay}
    if t is Adam:
        return "adam", {"b1": method.beta1, "b2": method.beta2,
                        "eps": method.epsilon, "wd": method.weight_decay}
    if t is SGD:
        return "sgd", {"mu": method.momentum, "damp": method.dampening,
                       "nesterov": method.nesterov,
                       "wd": method.weight_decay}
    return None


def supports(method) -> bool:
    return describe(method) is not None


def enabled() -> bool:
    """BIGDL_TPU_FUSED_UPDATE: off for "", 0, false, off or no (the
    default is ""), on for anything else. The reference's 'flat' and
    'leaf' layout values turn it on like 1."""
    from bigdl_tpu_torch.utils import config
    raw = str(config.get("FUSED_UPDATE")).strip().lower()
    return raw not in ("", "0", "false", "off", "no")


def slot_names(kind: str, hyper: Dict) -> Tuple[str, ...]:
    if kind in ("adam", "adamw"):
        return ("m", "v")
    return ("velocity",) if hyper["mu"] != 0.0 else ()


# ------------------------------------------------------------------- math
def _bias_corrections(kind: str, hyper: Dict, step: int) -> Tuple[float, float]:
    """The step-dependent scalars, computed once per call on the host
    with the expression method.update uses (fp32 `1 - b ** (step+1)`),
    as exact fp32 values."""
    if kind in ("adam", "adamw"):
        t = step + 1
        return bias_correction(hyper["b1"], t), bias_correction(hyper["b2"], t)
    return 1.0, 1.0


def _math(kind: str, hyper: Dict, p, g, slots, lr, bc1: float, bc2: float):
    """One optimizer update of one leaf, elementwise, returning new
    tensors — the plain version of the kernel's body. Mirrors
    optim/method.py expression for expression. `lr` is a 0-dim fp32
    tensor; bc1/bc2 are exact fp32 values."""
    if kind in ("adam", "adamw"):
        b1, b2, eps, wd = (hyper["b1"], hyper["b2"], hyper["eps"],
                           hyper["wd"])
        m, v = slots
        if kind == "adam" and wd:
            g = g + wd * p
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        p_new = p - lr * (m / device_scalar(bc1, p)) / (
            torch.sqrt(v / device_scalar(bc2, p)) + eps)
        if kind == "adamw" and wd:
            p_new = p_new - lr * wd * p
        return p_new, (m, v)
    mu, damp, nesterov, wd = (hyper["mu"], hyper["damp"],
                              hyper["nesterov"], hyper["wd"])
    if wd:
        g = g + wd * p
    if not slots:                        # plain SGD — no state
        return p - lr * g, ()
    (v,) = slots
    v = mu * v + (1 - damp) * g
    upd = g + mu * v if nesterov else v
    return p - lr * upd, (v,)


def fused_update_plain(kind: str, hyper: Dict, params: Sequence, grads: Sequence,
                       slots: Sequence[Sequence], lr, bc1: float, bc2: float):
    """`_math` op by op over a list of leaves: (new params list, new
    slot lists), nothing updated in place. `slots` holds one list of
    leaves per slot name."""
    lr = as_lr(lr)
    new_p, new_s = [], [[] for _ in slots]
    for i, (p, g) in enumerate(zip(params, grads)):
        pn, sn = _math(kind, hyper, p, g, tuple(s[i] for s in slots), lr,
                       bc1, bc2)
        new_p.append(pn)
        for j, s in enumerate(sn):
            new_s[j].append(s)
    return new_p, new_s


# ----------------------------------------------------------- CUDA kernel
def _f32(x) -> float:
    """A Python float rounded to fp32, as torch rounds a Python scalar
    that meets an fp32 tensor."""
    return float(torch.tensor(x, dtype=torch.float32))


def _lib():
    lib = _native.load("fused_update")
    fn = lib.bigdl_fused_update_f32
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, ctypes.c_longlong, i, i, i] + [f] * 12 + [i, p]
        fn.restype = ctypes.c_int
    return fn


# elements one block of the kernel updates; a leaf spans
# ceil(n / CHUNK) blocks (must match CHUNK in csrc/fused_update.cu)
CHUNK = 4096


def _check_leaves(params, grads, slots):
    dev = params[0].device
    for i, p in enumerate(params):
        leaves = [p, grads[i]] + [s[i] for s in slots]
        if any(t.device != dev for t in leaves):
            raise ValueError("fused_update: every leaf must lie on one device")
        if any(t.dtype != torch.float32 for t in leaves):
            raise TypeError("the CUDA fused_update kernel takes fp32 "
                            "params, grads and slots")
        if any(t.shape != p.shape for t in leaves):
            raise ValueError(f"fused_update: leaf {i}: grad/slot shapes "
                             f"differ from the param's {tuple(p.shape)}")
        if not all(t.is_contiguous() for t in leaves):
            raise ValueError("the CUDA fused_update kernel takes contiguous "
                             "leaves")


def fused_update(kind: str, hyper: Dict, params: List[torch.Tensor],
                 grads: List[torch.Tensor], slots: List[List[torch.Tensor]],
                 lr, bc1: float, bc2: float) -> None:
    """One optimizer step over a list of leaves, params and slots
    updated IN PLACE. `slots`: one list of leaves per slot name of
    `slot_names(kind, hyper)`. CUDA tensors: one launch of K1 over the
    whole list; CPU tensors: the plain version, copied back."""
    if kind not in _KINDS:
        raise ValueError(f"unknown fused-update kind {kind!r}")
    if len(slots) != len(slot_names(kind, hyper)):
        raise ValueError(f"{kind} takes slots {slot_names(kind, hyper)}, "
                         f"got {len(slots)} lists")
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        new_p, new_s = fused_update_plain(kind, hyper, params, grads, slots,
                                          lr, bc1, bc2)
        with torch.no_grad():
            for dst, src in zip(params, new_p):
                dst.copy_(src)
            for dsts, srcs in zip(slots, new_s):
                for dst, src in zip(dsts, srcs):
                    dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_update runs on cuda or cpu, not {dev}")
    _check_leaves(params, grads, slots)
    # the leaf table: (p, g, slot0, slot1, n, first block) per leaf
    rows, blocks = [], 0
    for i, p in enumerate(params):
        n = p.numel()
        s = [sl[i].data_ptr() for sl in slots] + [0] * (2 - len(slots))
        rows.append([p.data_ptr(), grads[i].data_ptr(), *s, n, blocks])
        blocks += -(-n // CHUNK)
    if blocks == 0:
        return
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    lr32 = as_lr(lr)
    wd = float(hyper["wd"])
    b1, b2 = hyper.get("b1", 0.0), hyper.get("b2", 0.0)
    mu, damp = hyper.get("mu", 0.0), hyper.get("damp", 0.0)
    consts = [float(lr32), bc1, bc2,
              _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
              _f32(hyper.get("eps", 0.0)), _f32(wd), float(lr32 * wd),
              _f32(mu), _f32(1 - damp)]
    rc = _lib()(table.data_ptr(), len(params), blocks, _KINDS[kind],
                len(slots), int(bool(hyper.get("nesterov", False))),
                *consts, *_native.device_and_stream(dev))
    _native.check(rc, "fused_update")
    fused_update.launches.add()


fused_update.launches = _native.LaunchCounter()


# --------------------------------------------------------- tree-level API
def make_update_fn(method) -> Optional[Callable]:
    """A drop-in replacement for `method.update` (same ``(params, grads,
    slots, lr, step) -> (new_params, new_slots)`` signature over path
    dicts), or None when the method has no fused form. One `fused_update`
    call over every float leaf, which updates the params and slots in
    place and returns them: K1 for CUDA tensors, the plain version for
    CPU tensors."""
    desc = describe(method)
    if desc is None:
        return None
    kind, hyper = desc
    names = slot_names(kind, hyper)

    def update(params, grads, slots, lr, step):
        keys = [k for k, p in params.items() if p.is_floating_point()]
        if keys:
            bc1, bc2 = _bias_corrections(kind, hyper, step)
            fused_update(kind, hyper, [params[k] for k in keys],
                         [grads[k] for k in keys],
                         [[slots[nm][k] for k in keys] for nm in names],
                         lr, bc1, bc2)
        return params, slots

    update.__name__ = f"fused_{kind}_update"
    return update
