#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (bigdl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. build — nvcc compiles every kernel of the serving and training
     paths from bigdl_tpu_torch/kernels/csrc, one process per source, in
     parallel;
  2. kernels — each kernel's wrapper against its plain PyTorch version on
     the card, at the main paths' shapes and at ragged ones: flash
     attention within FLASH_TOL, the int8 GEMM and the fused optimizer
     update bit for bit, flash attention's gradients (dense recompute
     backward) within GRAD_TOL of autograd through the plain version, with
     the peak memory of each backward; with kernel,
     plain and library times (CUDA events) and the bound the card's
     peaks set;
  3. the slice — LlamaLM at the 125M width (vocab 32000, d 768, 12 heads,
     4 kv heads, d_ff 3072, 12 layers, tied head) with seeded random
     weights and FlashAttention, registered int8 on ServeEngine
     (max_batch 8); 3 client threads send 12 requests of 1-8 rows of 512
     token ids. Every reply is checked (shape, finite, and bit-identical
     to a direct forward of the same rows padded to the size of the batch
     that carried them, see match_direct), and the launch
     counters, zeroed just before the clients start, must read 12 flash
     and 36 int8 launches per served forward;
  4. card — nvidia-smi's name and power limit;
  5. LM training of the 125M LlamaLM (the same width, FlashAttention)
     through Optimizer(...).optimize() with Adam(3e-4) and
     BIGDL_TPU_FUSED_UPDATE=1 for TRAIN_STEPS steps on one fixed batch
     of 8 x 1024 tokens: every loss finite, the mean of the last 5 at
     least 0.5 below the first, exactly 12 flash and 1 fused-update
     launches per step, the first loss equal (1e-5 relative) to a step
     of the same weights with dense attention and the flag off, and the
     fused update bitwise equal to Adam.update on the trained state;
     with the step time (median), tokens/s and a split of one step.

The last lines are the kernel record (one JSON object), the card line,
and `{"ok": true, "device": {...}}`. Exits non-zero without printing a
result when no CUDA device is visible or the port is not beside it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ("flash_attention", "quantized_matmul", "fused_update")
# published H100 SXM peaks (dense): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores, int8 tensor-core OP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_INT8_S = 1979e12
# fp32 attention, kernel vs dense plain version: both sum in fp32 in
# different orders (online vs one-pass softmax); 2e-5 abs + 2e-5 rel is
# the reference's own flash-vs-dense tolerance (tests/test_kernels.py)
FLASH_TOL = 2e-5
# fp32 attention gradients, the recompute backward (autograd through the
# dense plain version) against autograd through the plain version: the
# same ops on the same inputs, expected bit for bit; the margin covers a
# GEMM algorithm chosen otherwise
GRAD_TOL = 1e-4
# the served model: 125M LLaMA width, depth kept
VOCAB, D, HEADS, KV_HEADS, D_FF, LAYERS, SEQ = 32000, 768, 12, 4, 3072, 12, 512
MAX_BATCH, CLIENTS, REQS_PER_CLIENT = 8, 3, 4
# the trained model: the same width, bench.py's training batch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 30, 3e-4


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


# ---------------------------------------------------------------- phase 2
def check_flash(dev, gen):
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    worst = 0.0
    for b, h, tq, tk, causal in ((2, 3, 77, 133, True), (2, 3, 133, 77, True),
                                 (1, 2, 50, 77, False),
                                 (MAX_BATCH, HEADS, SEQ, SEQ, True)):
        q, k, v = (torch.randn(b, h, t, D // HEADS, generator=gen, device=dev)
                   for t in (tq, tk, tk))
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs()
                   <= FLASH_TOL + FLASH_TOL * want.abs()).all())
        log(f"  flash_attention B={b} H={h} Tq={tq} Tk={tk} causal={causal}: "
            f"max|kernel-plain|={err:.3e} within {FLASH_TOL} abs+rel: {ok}")
        if not ok:
            raise SystemExit("flash_attention disagrees with its plain version")
        worst = max(worst, err)
    # timing at the serving shape (the last case above)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    plain = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))       # Tq == Tk: top-left == bottom-right
    b, h, t, d = q.shape
    nbytes = 4 * q.numel() * 4                      # q, k, v, o in fp32
    ops = b * h * (t * (t + 1) // 2) * 4 * d        # visible pairs x 4d
    bms, by = bound(nbytes, ops, PEAK_FP32_S)
    log(f"  flash_attention B={b} H={h} T={t} d={d} causal: kernel {ms:.4f} "
        f"ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms; bound {bms:.4f} ms "
        f"({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP fp32)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "bigdl_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "bigdl_tpu/kernels/flash_attention.py:156",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "shape": f"B={b} H={h} Tq=Tk={t} d={d} causal fp32"}


def check_int8(dev, gen):
    import torch
    from bigdl_tpu_torch.kernels.quantized_matmul import (int8_matmul,
                                                          int8_matmul_plain)

    def case(m, k, n):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand(m, 1, generator=gen, device=dev) / 100 + 1e-3
        sw = torch.rand(1, n, generator=gen, device=dev) / 100 + 1e-3
        return xq, wq, wq.t().contiguous(), sx, sw

    m = MAX_BATCH * SEQ
    block = [case(m, D, D_FF), case(m, D, D_FF), case(m, D_FF, D)]
    worst = 0.0
    for xq, wq, wt, sx, sw in block + [case(70, 96, 50), case(33, 42, 19)]:
        got = int8_matmul(xq, wq, sx, sw, wq_t=wt)
        want = int8_matmul_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        log(f"  int8_matmul M={xq.shape[0]} K={xq.shape[1]} N={wq.shape[1]}: "
            f"bitwise equal to plain: {same} (max diff {err:.3e})")
        if not same:
            raise SystemExit("int8_matmul is not bitwise equal to its plain "
                             "version")
        worst = max(worst, err)
    # one block's three GEMMs (gate, up, down) at the serving shape
    ms = cuda_ms(lambda: [int8_matmul(x, w, a, b, wq_t=t)
                          for x, w, t, a, b in block])
    plain = cuda_ms(lambda: [int8_matmul_plain(x, w, a, b)
                             for x, w, t, a, b in block], iters=5)
    # torch._int_mm is the int32 product alone, without the epilogue
    lib = cuda_ms(lambda: [torch._int_mm(x, t.t()) for x, w, t, a, b
                              in block])
    nbytes = sum(x.numel() + w.numel() + 4 * (x.shape[0] + w.shape[1])
                 + 4 * x.shape[0] * w.shape[1] for x, w, *_ in block)
    ops = sum(2 * x.shape[0] * x.shape[1] * w.shape[1] for x, w, *_ in block)
    bms, by = bound(nbytes, ops, PEAK_INT8_S)
    log(f"  int8_matmul gate+up+down M={m}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, _int_mm {lib:.4f} ms; bound {bms:.4f} ms ({by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G int8 ops)")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/kernels/csrc/quantized_matmul.cu",
            "replaces": "bigdl_tpu/kernels/quantized_matmul.py:119",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "shape": f"gate+up+down of one block: M={m}, "
                     f"KxN={D}x{D_FF},{D}x{D_FF},{D_FF}x{D}"}


def check_flash_backward(dev, gen):
    """Gradients through the K2 Function (kernel forward, dense
    recompute backward) against autograd through the plain version, at
    the training shape and a ragged one; the backward timed at the
    training shape beside the plain version's and SDPA's backward, with
    the peak memory of a forward and backward of each above the
    inputs."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    worst = 0.0
    for b, h, tq, tk in ((TRAIN_BATCH, HEADS, TRAIN_SEQ, TRAIN_SEQ),
                         (2, 3, 77, 133)):
        q, k, v = (torch.randn(b, h, t, D // HEADS, generator=gen,
                               device=dev).requires_grad_()
                   for t in (tq, tk, tk))
        g = torch.randn(b, h, tq, D // HEADS, generator=gen, device=dev)
        got = torch.autograd.grad(flash_attention(q, k, v, causal=True),
                                  (q, k, v), g)
        want = torch.autograd.grad(flash_attention_plain(q, k, v, causal=True),
                                   (q, k, v), g)
        torch.cuda.synchronize()
        for name, a, w in zip("qkv", got, want):
            err = (a - w).abs().max().item()
            ok = bool(((a - w).abs() <= GRAD_TOL + GRAD_TOL * w.abs()).all())
            log(f"  flash backward B={b} H={h} Tq={tq} Tk={tk} causal: "
                f"max|d{name} - plain autograd|={err:.3e} within "
                f"{GRAD_TOL} abs+rel: {ok}")
            if not ok:
                raise SystemExit("flash attention's gradients disagree with "
                                 "autograd through its plain version")
            worst = max(worst, err)
        del got, want
    # timing at the training shape (the first case): the backward alone,
    # the forward's graph kept
    q, k, v = (torch.randn(TRAIN_BATCH, HEADS, TRAIN_SEQ, D // HEADS,
                           generator=gen, device=dev).requires_grad_()
               for _ in range(3))
    g = torch.randn_like(q)
    fwd = cuda_ms(lambda: flash_attention(q.detach(), k.detach(), v.detach(),
                                          causal=True))

    def bwd(attn):
        """(backward ms, peak MiB of one forward and backward above the
        inputs)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = attn(q, k, v)
        torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        return cuda_ms(lambda: torch.autograd.grad(
            out, (q, k, v), g, retain_graph=True), iters=5, warmup=1), peak
    (ms, mib), (plain, plain_mib), (lib, lib_mib) = (
        bwd(lambda *a: flash_attention(*a, causal=True)),
        bwd(lambda *a: flash_attention_plain(*a, causal=True)),
        bwd(lambda *a: F.scaled_dot_product_attention(*a, is_causal=True)))
    log(f"  flash backward B={TRAIN_BATCH} H={HEADS} T={TRAIN_SEQ} d="
        f"{D // HEADS} causal: recompute {ms:.4f} ms (peak +{mib:.1f} MiB), "
        f"plain autograd {plain:.4f} ms (+{plain_mib:.1f} MiB), sdpa "
        f"backward {lib:.4f} ms (+{lib_mib:.1f} MiB); kernel forward at "
        f"this shape {fwd:.4f} ms")
    return {"backward_ms": ms, "backward_plain_ms": plain,
            "backward_library_ms": lib, "backward_max_abs_err": worst,
            "backward_peak_mib": mib, "backward_plain_peak_mib": plain_mib,
            "backward_library_peak_mib": lib_mib,
            "train_forward_ms": fwd,
            "backward_shape": f"B={TRAIN_BATCH} H={HEADS} Tq=Tk={TRAIN_SEQ} "
                              f"d={D // HEADS} causal fp32"}


def llama_leaf_shapes():
    """The shapes of the 125M LlamaLM's parameters, from its
    declarations (nothing allocated)."""
    from bigdl_tpu_torch.interop.huggingface import LlamaLM
    model = LlamaLM(VOCAB, D, HEADS, KV_HEADS, D_FF, LAYERS, tied=True)
    return [spec.shape for mod in model.modules()
            for spec in mod.param_specs().values()]


def check_fused_update(dev, gen):
    """K1 against the plain version, bit for bit, for every kind it
    takes, over leaf lists of odd sizes and (Adam) over the 125M
    LlamaLM's 110 leaves; timed there beside the plain version and
    torch._fused_adam_ (what torch.optim.Adam(fused=True) runs; timed
    only, its eps placement rounds differently)."""
    import torch
    from bigdl_tpu_torch.kernels import fused_update as fu
    from bigdl_tpu_torch.optim import method as pm

    def leaves(shapes, names):
        def r(s):
            return torch.randn(s, generator=gen, device=dev)
        ps = [r(s) for s in shapes]
        gs = [r(s) * 1e-2 for s in shapes]
        ss = [[r(s).abs() * 1e-3 for s in shapes] for _ in names]
        return ps, gs, ss

    odd = [(1,), (7,), (4097,), (33, 7), (0,), (70001,), (4096,), (5, 1023)]
    model = llama_leaf_shapes()
    n_model = sum(math.prod(s) for s in model)
    methods = [("adam", pm.Adam(TRAIN_LR)),
               ("adamw", pm.AdamW(TRAIN_LR, weight_decay=0.1)),
               ("sgd", pm.SGD(0.1)),
               ("sgd momentum+dampening", pm.SGD(0.1, momentum=0.9,
                                                 dampening=0.1,
                                                 weight_decay=1e-4)),
               ("sgd nesterov", pm.SGD(0.1, momentum=0.9, nesterov=True))]
    worst = 0.0
    for label, method in methods:
        kind, hyper = fu.describe(method)
        names = fu.slot_names(kind, hyper)
        bc1, bc2 = fu._bias_corrections(kind, hyper, 7)
        for shapes in [odd] + ([model] if kind == "adam" else []):
            ps, gs, ss = leaves(shapes, names)
            want_p, want_s = fu.fused_update_plain(kind, hyper, ps, gs, ss,
                                                   TRAIN_LR, bc1, bc2)
            fu.fused_update(kind, hyper, ps, gs, ss, TRAIN_LR, bc1, bc2)
            torch.cuda.synchronize()
            pairs = list(zip(ps, want_p)) + [
                ab for sa, sb in zip(ss, want_s) for ab in zip(sa, sb)]
            same = all(torch.equal(a, b) for a, b in pairs)
            err = max(((a - b).abs().max().item() for a, b in pairs
                       if a.numel()), default=0.0)
            worst = max(worst, err)
            log(f"  fused_update {label}: {len(shapes)} leaves, "
                f"{sum(math.prod(s) for s in shapes)} elements, bitwise "
                f"equal to plain: {same} (max diff {err:.3e})")
            if not same:
                raise SystemExit("fused_update is not bitwise equal to its "
                                 "plain version")
            del want_p, want_s, pairs
    # timing: Adam over the model's leaves, in place, repeatedly
    kind, hyper = fu.describe(pm.Adam(TRAIN_LR))
    ps, gs, (ms_, vs) = leaves(model, ("m", "v"))
    bc1, bc2 = fu._bias_corrections(kind, hyper, 7)
    ms = cuda_ms(lambda: fu.fused_update(kind, hyper, ps, gs, [ms_, vs],
                                         TRAIN_LR, bc1, bc2))
    plain = cuda_ms(lambda: fu.fused_update_plain(kind, hyper, ps, gs,
                                                  [ms_, vs], TRAIN_LR, bc1,
                                                  bc2), iters=5, warmup=1)
    steps = [torch.zeros((), device=dev) for _ in ps]
    lib = cuda_ms(lambda: torch._fused_adam_(
        ps, gs, ms_, vs, [], steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False))
    nbytes = 28 * n_model               # read p, g, m, v; write p, m, v
    ops = 14 * n_model                  # fp32 operations of one Adam step
    bms, by = bound(nbytes, ops, PEAK_FP32_S)
    log(f"  fused_update Adam over {len(model)} leaves, {n_model} params: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch._fused_adam_ "
        f"{lib:.4f} ms; bound {bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB, "
        f"{ops / 1e9:.3f} GFLOP fp32)")
    return {"name": "fused_update", "route": "cuda",
            "source": "bigdl_tpu_torch/kernels/csrc/fused_update.cu",
            "replaces": "bigdl_tpu/kernels/fused_update.py:202",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "shape": f"Adam over the 125M LlamaLM's {len(model)} fp32 "
                     f"leaves, {n_model} params"}


# ---------------------------------------------------------------- phase 3
def match_direct(qmodel, x, reply, buckets, dev):
    """Compare a reply with direct forwards of the same rows, zero-padded
    to each bucket size that could have carried them. Rows never interact
    (per-token GEMMs and quantization scales, per-sequence attention), so
    the forward at the bucket the batch ran in gives the same bits; the
    float GEMMs of other sizes may sum in another order, round apart and
    flip int8 roundings downstream. Returns (bucket that matched bit for
    bit or None, {bucket: max abs diff})."""
    import numpy as np
    import torch
    n = x.shape[0]
    got = torch.from_numpy(reply).to(dev)
    diffs = {}
    for b in (b for b in buckets if b >= n):
        xs = np.zeros((b,) + x.shape[1:], x.dtype)
        xs[:n] = x
        out = qmodel(torch.from_numpy(xs).to(dev))[:n]
        diffs[b] = (out - got).abs().max().item()
        if diffs[b] == 0.0:
            return b, diffs
    return None, diffs


def dispatch_breakdown(entry, xs):
    """Where one full-bucket dispatch spends its time: the device forward
    alone (CUDA events), the whole dispatch with the host fetch of the
    logits (host clock), and the device kernels by self time
    (torch.profiler)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    valid = np.ones((xs.shape[0],), bool)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: entry.forward(xs, valid), iters=3, warmup=1)
    t = time.monotonic()
    for _ in range(3):
        entry.dispatch(xs, xs.shape[0])
    disp_ms = (time.monotonic() - t) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        entry.dispatch(xs, xs.shape[0])
        torch.cuda.synchronize()
        prof_ms = (time.monotonic() - t) * 1e3
    # device-side records only (kernels, copies): the host-side aten ops
    # carry the same device time again
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.self_device_time_total, reverse=True)
    copy_ms = sum(e.self_device_time_total for e in events
                  if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3 - copy_ms
    log(f"  one dispatch of {xs.shape[0]}x{xs.shape[1]} tokens: device "
        f"forward {fwd_ms:.2f} ms, whole dispatch {disp_ms:.2f} ms (host "
        f"fetch of {xs.shape[0] * xs.shape[1] * VOCAB * 4 / 1e6:.0f} MB of "
        f"logits included); profiled dispatch {prof_ms:.2f} ms: kernels "
        f"{kernel_ms:.2f} ms, copies {copy_ms:.2f} ms, compute idle share "
        f"{1 - kernel_ms / prof_ms:.3f}")
    for e in events[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
            f"{e.key[:90]}")


def serve_slice(dev):
    import numpy as np
    import torch
    from bigdl_tpu_torch.interop.huggingface import LlamaLM
    from bigdl_tpu_torch.kernels.flash_attention import (FlashAttention,
                                                         flash_attention)
    from bigdl_tpu_torch.kernels.quantized_matmul import int8_matmul
    from bigdl_tpu_torch.serve import ServeEngine
    from bigdl_tpu_torch.utils.threads import spawn

    t0 = time.monotonic()
    model = LlamaLM(VOCAB, D, HEADS, KV_HEADS, D_FF, LAYERS, tied=True,
                    attn_impl=FlashAttention())
    model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    r = np.random.RandomState(0)
    reqs = [[r.randint(0, VOCAB, (int(r.randint(1, MAX_BATCH + 1)), SEQ))
             .astype(np.int32) for _ in range(REQS_PER_CLIENT)]
            for _ in range(CLIENTS)]
    replies = [[None] * REQS_PER_CLIENT for _ in range(CLIENTS)]
    lat_ms, errors = [], []

    with ServeEngine(device=dev) as eng:
        entry = eng.register("llama125m", model, int8=True,
                             max_batch=MAX_BATCH)
        qmodel = entry.model
        log(f"  LlamaLM {n_params / 1e6:.1f}M params, int8 registration, "
            f"buckets {entry.buckets}, set up in "
            f"{time.monotonic() - t0:.1f} s")
        eng.predict("llama125m", reqs[0][0][:1], timeout=600)   # warm-up

        def client(ci):
            try:
                for qi, x in enumerate(reqs[ci]):
                    ts = time.monotonic()
                    replies[ci][qi] = eng.predict("llama125m", x, timeout=600)
                    lat_ms.append((time.monotonic() - ts) * 1e3)
            except Exception as exc:       # noqa: BLE001 — fails the run below
                errors.append(f"client {ci}: {exc!r}")

        batches0 = eng.stats()["_totals"]["batches"]
        flash_attention.launches.reset()
        int8_matmul.launches.reset()
        t_run = time.monotonic()
        threads = [spawn(client, name=f"smoke-client-{ci}", args=(ci,))
                   for ci in range(CLIENTS)]
        for th in threads:
            th.join()
        wall = time.monotonic() - t_run
        n_flash = flash_attention.launches.value
        n_int8 = int8_matmul.launches.value
        st = eng.stats()
        forwards = int(st["_totals"]["batches"] - batches0)

    if errors:
        raise SystemExit(f"serving failed: {errors}")
    log(f"  served {CLIENTS * REQS_PER_CLIENT} requests in {forwards} "
        f"forwards; launches: flash_attention {n_flash}, int8_matmul "
        f"{n_int8} (want {LAYERS}x and {3 * LAYERS}x forwards)")
    if not (forwards > 0 and n_flash == LAYERS * forwards
            and n_int8 == 3 * LAYERS * forwards):
        raise SystemExit("the served forwards did not run through the "
                         "kernels as counted")

    rows = 0
    with torch.inference_mode():
        for ci in range(CLIENTS):
            for x, got in zip(reqs[ci], replies[ci]):
                rows += x.shape[0]
                if got.shape != (x.shape[0], SEQ, VOCAB):
                    raise SystemExit(f"reply shape {got.shape}")
                if not np.isfinite(got).all():
                    raise SystemExit("non-finite values in a reply")
                bucket, diffs = match_direct(qmodel, x, got, entry.buckets,
                                             dev)
                log(f"  reply of {x.shape[0]} rows: max|reply - direct "
                    f"forward| by padded size {diffs}; bit-identical at "
                    f"bucket {bucket}")
                if bucket is None:
                    raise SystemExit("a reply equals no direct forward of "
                                     "its rows")
    dispatch_breakdown(entry, np.concatenate(
        [x for c in reqs for x in c])[:MAX_BATCH])
    lat = sorted(lat_ms)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    log(f"  replies: shapes (n, {SEQ}, {VOCAB}), all finite, each bit-"
        f"identical to a direct forward of its rows")
    log(f"  latency p50 {p50:.1f} ms, p99 {p99:.1f} ms (client clock; engine "
        f"histogram p50<={st['llama125m']['p50_ms']} p99<="
        f"{st['llama125m']['p99_ms']} ms); {rows / wall:.2f} rows/s, "
        f"{rows * SEQ / wall:.0f} tokens/s over {wall:.2f} s; mean batch "
        f"fill {st['llama125m']['mean_batch_fill']}")
    return {"flash_attention": n_flash, "int8_matmul": n_int8}


# ---------------------------------------------------------------- phase 5
class _Losses:
    """Train summary keeping every step's loss."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(value)


def _trainer(model, x, y, steps, step_times=None):
    """Optimizer over one fixed batch, `steps` steps. With `step_times`,
    the batch iterator synchronizes the card before it hands out each
    batch and records the time, so consecutive records bracket one whole
    step (the caller records the end of the last one)."""
    import torch
    from bigdl_tpu_torch.dataset.core import IteratorDataSet, MiniBatch
    from bigdl_tpu_torch.nn.criterion import (CrossEntropyCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.optim.local import Optimizer
    from bigdl_tpu_torch.optim.method import Adam
    from bigdl_tpu_torch.optim.trigger import Trigger

    def epoch():
        for _ in range(steps):
            if step_times is not None:
                torch.cuda.synchronize()
                step_times.append(time.perf_counter())
            yield MiniBatch(x, y)

    crit = TimeDistributedCriterion(CrossEntropyCriterion(),
                                    size_average=True)
    opt = Optimizer(model, IteratorDataSet(epoch), crit, Adam(TRAIN_LR),
                    device=model.embed.device)
    summary = _Losses()
    opt.set_train_summary(summary).set_end_when(Trigger.max_iteration(steps))
    return opt, summary


def step_split(model, opt, x, y):
    """One training step of `model` taken apart the way the trainer
    runs it (forward, criterion, backward, fused update), CUDA events
    between the parts; then the same step under torch.profiler for the
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = model.embed.device
    xd, yd = (torch.from_numpy(a).to(dev) for a in (x, y))
    params = {k: p for k, p in model.named_parameters()}
    update = opt._resolve_update_fn()
    lr = torch.tensor(TRAIN_LR, dtype=torch.float32)

    def step(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        mark(0)
        out = model(xd)
        mark(1)
        loss = opt.criterion.forward(out, yd)
        mark(2)
        grads = torch.autograd.grad(loss, list(params.values()))
        mark(3)
        with torch.no_grad():
            update(params, dict(zip(params, grads)), opt.slots, lr,
                   opt.state["neval"])
        mark(4)

    step()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    step(ev)
    torch.cuda.synchronize()
    parts = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
             enumerate(("forward", "criterion", "backward", "update"))}
    log("  one step, CUDA events: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; total {ev[0].elapsed_time(ev[4]):.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t) * 1e3
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled step {wall_ms:.2f} ms (the profiler's host overhead "
        f"included): device busy {busy_ms:.2f} ms; kernels by device time:")
    for e in events[:10]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    return parts, busy_ms


def train_slice(dev):
    import os

    import numpy as np
    import torch
    from bigdl_tpu_torch.interop.huggingface import LlamaLM
    from bigdl_tpu_torch.kernels import fused_update as fu
    from bigdl_tpu_torch.kernels.flash_attention import (FlashAttention,
                                                         flash_attention)

    t0 = time.monotonic()
    r = np.random.RandomState(0)
    tokens = r.randint(0, VOCAB, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    model = LlamaLM(VOCAB, D, HEADS, KV_HEADS, D_FF, LAYERS, tied=True,
                    attn_impl=FlashAttention())
    model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    os.environ["BIGDL_TPU_FUSED_UPDATE"] = "1"
    step_times = []
    opt, summary = _trainer(model, x, y, TRAIN_STEPS, step_times)
    log(f"  LlamaLM {n_params} params in {len(initial)} leaves, batch "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}, Adam({TRAIN_LR}), "
        f"BIGDL_TPU_FUSED_UPDATE=1; set up in {time.monotonic() - t0:.1f} s")
    flash_attention.launches.reset()
    fu.fused_update.launches.reset()
    t_run = time.monotonic()
    opt.optimize()
    torch.cuda.synchronize()
    step_times.append(time.perf_counter())
    wall = time.monotonic() - t_run
    n_flash = flash_attention.launches.value
    n_fused = fu.fused_update.launches.value
    losses = summary.losses
    log(f"  {len(losses)} steps in {wall:.2f} s; losses "
        + " ".join(f"{v:.4f}" for v in losses))
    log(f"  launches: flash_attention {n_flash}, fused_update {n_fused} (want "
        f"{LAYERS * TRAIN_STEPS} and {TRAIN_STEPS}: {LAYERS} and 1 per step)")
    if not (n_flash == LAYERS * TRAIN_STEPS and n_fused == TRAIN_STEPS):
        raise SystemExit("the training steps did not run through the "
                         "kernels as counted")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise SystemExit("a training loss is missing or not finite")
    drop = losses[0] - sum(losses[-5:]) / 5
    log(f"  loss {losses[0]:.4f} -> mean of the last 5 "
        f"{sum(losses[-5:]) / 5:.4f} (drop {drop:.4f}, want >= 0.5)")
    if drop < 0.5:
        raise SystemExit("the loss did not fall by 0.5")
    gaps = sorted(b - a for a, b in zip(step_times[1:], step_times[2:]))
    med = gaps[len(gaps) // 2]
    log(f"  step time median {med * 1e3:.2f} ms over steps 2-{TRAIN_STEPS} "
        f"(host clock, the card synchronized at each step), "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; first step "
        f"{(step_times[1] - step_times[0]) * 1e3:.2f} ms")

    # the fused update against Adam.update on the trained state, fed the
    # same gradients
    params = {k: p.detach() for k, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for k, p in params.items()}
    want_p, want_s = opt.method.update(params, grads, opt.slots, TRAIN_LR,
                                       TRAIN_STEPS)
    got_p, got_s = fu.make_update_fn(opt.method)(
        {k: p.clone() for k, p in params.items()}, grads,
        {nm: {k: s.clone() for k, s in sl.items()}
         for nm, sl in opt.slots.items()}, TRAIN_LR, TRAIN_STEPS)
    torch.cuda.synchronize()
    same = (all(torch.equal(got_p[k], want_p[k]) for k in params)
            and all(torch.equal(got_s[nm][k], want_s[nm][k])
                    for nm in want_s for k in params))
    log(f"  fused update vs Adam.update on the trained state, same "
        f"gradients: params and slots bitwise equal: {same}")
    if not same:
        raise SystemExit("the fused update differs from Adam.update")
    del want_p, want_s, got_p, got_s, grads

    split, busy_ms = step_split(model, opt, x, y)
    idle = 1 - busy_ms / (med * 1e3)
    log(f"  device idle share of a step: 1 - {busy_ms:.2f} ms busy "
        f"(profiled) / {med * 1e3:.2f} ms median step = {idle:.3f}")

    # the first step again, from the same weights, dense attention and
    # the flag off
    del opt, model, params
    torch.cuda.empty_cache()
    os.environ["BIGDL_TPU_FUSED_UPDATE"] = "0"
    dense = LlamaLM(VOCAB, D, HEADS, KV_HEADS, D_FF, LAYERS, tied=True)
    dense.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    dense.load_state_dict(initial)
    opt_d, summ_d = _trainer(dense, x, y, 1)
    opt_d.optimize()
    rel = abs(summ_d.losses[0] - losses[0]) / abs(losses[0])
    log(f"  first loss, dense attention and the flag off: "
        f"{summ_d.losses[0]:.6f} vs {losses[0]:.6f} (relative {rel:.2e}, "
        f"want <= 1e-5)")
    if rel > 1e-5:
        raise SystemExit("the flash+fused step's loss differs from the "
                         "dense oracle step's")
    return ({"flash_attention": n_flash, "fused_update": n_fused},
            {"step_ms_median": med * 1e3,
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
             "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
             "split_ms": split, "device_busy_ms": busy_ms,
             "idle_share": idle})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bigdl_tpu_torch.kernels import _native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.monotonic()
    built = _native.build(KERNELS)
    for name, info in built.items():
        usage = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: {'cached' if info['cached'] else 'built'} "
            f"({info['seconds']:.1f} s) {' | '.join(usage)}")
    log(f"  build {time.monotonic() - t0:.1f} s")

    log("phase 2: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    flash = check_flash(dev, gen)
    flash.update(check_flash_backward(dev, gen))
    record = [flash, check_int8(dev, gen), check_fused_update(dev, gen)]
    torch.cuda.empty_cache()

    log("phase 3: int8 serving of the 125M LlamaLM")
    by_path = {"serve": serve_slice(dev)}
    torch.cuda.empty_cache()

    log("phase 4: card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  {card}")

    log("phase 5: LM training of the 125M LlamaLM")
    by_path["train"], train = train_slice(dev)
    log("  training " + json.dumps(train))
    for k in record:
        counts = {path: n[k["name"]] for path, n in by_path.items()
                  if k["name"] in n}
        k["launches"] = sum(counts.values())
        k["launches_by_path"] = counts
    print(json.dumps({"kernels": record}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
