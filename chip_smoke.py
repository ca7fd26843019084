#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (bigdl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. build — nvcc compiles every kernel of the serving and training
     paths from bigdl_tpu_torch/kernels/csrc, one process per source, in
     parallel;
  2. kernels — each kernel's wrapper against its plain PyTorch version on
     the card, at the main paths' shapes and at ragged ones: flash
     attention within FLASH_TOL (head dims 64, 97, 128, 200 and 256,
     rows that see no key, a TF32 dense attention shown to fail the
     tolerance), the int8 GEMM and the fused optimizer update bit for
     bit, flash attention's gradients (dense recompute backward) within
     GRAD_TOL of autograd through the plain version, with the peak
     memory of each backward; with kernel, plain and library times (CUDA
     events; flash attention at the serving and the training shape) and
     the bound the card's peaks set;
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
     with the step time (median), tokens/s and a split of one step;
  6. the pipelined LM at GPT-2-small width (PipelinedLM: vocab 50257,
     d 768, 12 heads, d_ff 3072, 12 layers, one stage, 4 microbatches,
     fused_loss) trained with Adam(3e-4) for TRAIN_STEPS steps on one
     fixed batch of 8 x 1024 tokens: every loss finite, the mean of the
     last 5 at least 0.5 below the first, exactly 4 launches of each cut
     cross-entropy kernel (K3a, K3b, K3c) per step and no flash-attention
     launch, the first loss equal (1e-5 relative) to a dense-loss step of
     the same weights, the embedding after one step within EMB_TOL_LR * lr
     of that step's, and the trained model's logits finite with a mean
     loss equal (1e-5 relative) to its fused loss; with the step time
     (median), tokens/s, a split of one step, the device idle share and
     the peak memory of both losses;
  7. the pipelined LM at GPT-2-large width (d 1280, 20 heads, d_ff 5120,
     cut to 2 layers, one stage, 2 microbatches of 1 x 1024 tokens,
     fused_loss), the width the cut cross-entropy kernels once refused,
     trained with Adam(3e-4) for LARGE_STEPS steps: every loss finite,
     exactly 2 launches of each cut cross-entropy kernel per step and no
     flash-attention launch, the first loss equal (1e-5 relative) to a
     dense-loss step of the same weights.

Phase 2 also holds the cut cross-entropy kernels (K3a/K3b/K3c) and the
autograd Function around them against the dense plain version (K3a's
lse within LSE_TOL, the rest within CCE_TOL), at the pipelined LM's
shape, at ragged shapes and at D past 1024, shows that TF32 products
would fail those tolerances, that the three kernels (3xTF32 on the
tensor cores) give the same bits on two launches and with PyTorch's TF32
switch on, and times them again at GPT-2 large's D = 1280. The int8
GEMM (K4, int8 tensor-core MMAs) is also held bit for bit at ragged M
and N, at K % 16 != 0 and on an unaligned operand, and timed beside its
library route (torch._int_mm and the dequantizing epilogue in PyTorch
ops: no single PyTorch call computes it). For K2, K4, K3a, K3b and K3c
it prints the body launched and its registers and shared memory; an
fp32 product kernel's bound is its operations as 3xTF32 on the tensor
cores, with the fp32-FMA figure beside it.

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
KERNELS = ("flash_attention", "quantized_matmul", "fused_update",
           "cut_cross_entropy")
# published H100 SXM peaks (dense): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores, TF32 and int8 tensor-core rates. An fp32 product at fp32
# accuracy costs at least three TF32 products (3xTF32: hi*hi + hi*lo +
# lo*hi), so the fp32 product kernels' operations bound is
# 3 * ops / PEAK_TF32_S; the fp32-FMA figure is printed beside it
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 494.7e12
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
# cut cross-entropy, kernel against the dense plain version in fp32:
# max|kernel - plain| <= CCE_TOL * max|plain|. Both sum in fp32 in other
# orders (~1e-6 of the largest value); a TF32 product (10-bit mantissa)
# moves dh and dw by ~1e-4 of theirs, which check_cut_cross_entropy
# shows fails it
CCE_TOL = 1e-5
# K3a's lse against the plain lse, both fp32: max|kernel - plain| <=
# LSE_TOL * max|plain|. The fp32 plain lse is ~8.5e-08 of its largest
# value from float64; a TF32 product moves lse by ~4.7e-06 (averaged
# under the softmax): CCE_TOL would pass it, LSE_TOL fails it, which
# check_cut_cross_entropy shows (tests/test_torch_kernels.py derives it)
LSE_TOL = 1e-6
# the embedding after one Adam step, fused against dense loss, within
# EMB_TOL_LR * lr: Adam's first step is lr * g / (|g| + eps), so where
# |g| >> eps it is +-lr whatever the rounding, and where |g| is near eps
# (the head's gradient of a row the batch barely touches) it scales a
# rounding difference of g by lr / eps. A tenth of the step allows that
# and fails a flipped step (2 lr) or a gradient wrong above rounding
EMB_TOL_LR = 0.1
# the served model: 125M LLaMA width, depth kept
VOCAB, D, HEADS, KV_HEADS, D_FF, LAYERS, SEQ = 32000, 768, 12, 4, 3072, 12, 512
MAX_BATCH, CLIENTS, REQS_PER_CLIENT = 8, 3, 4
# the trained model: the same width, bench.py's training batch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 30, 3e-4
# the pipelined LM: GPT-2 small's published widths (Hugging Face `gpt2`),
# one stage, 4 microbatches of 2 x 1024 tokens
GPT2_VOCAB, GPT2_D, GPT2_HEADS, GPT2_FF, GPT2_LAYERS = 50257, 768, 12, 3072, 12
PIPE_STAGES, PIPE_MICRO = 1, 4
# GPT-2 large's published widths (Hugging Face `gpt2-large`: n_embd 1280,
# n_head 20, n_inner 5120), cut to 2 layers, 2 microbatches of 1 x 1024
# tokens and 3 steps: the width the cut cross-entropy kernels once refused
LARGE_D, LARGE_HEADS, LARGE_FF, LARGE_LAYERS = 1280, 20, 5120, 2
LARGE_BATCH, LARGE_MICRO, LARGE_STEPS = 2, 2, 3


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


def fp32_bound(nbytes, flops):
    """(bound ms, by, the fp32-FMA bound ms) of an fp32 product kernel:
    its operations at fp32 accuracy on the tensor cores (3xTF32), and
    the same work on the FMA units for comparison."""
    bms, by = bound(nbytes, 3 * flops, PEAK_TF32_S)
    return bms, by, bound(nbytes, flops, PEAK_FP32_S)[0]


# ---------------------------------------------------------------- phase 2
def check_flash(dev, gen):
    """K2 against its plain version within FLASH_TOL at the main paths'
    shapes and at ragged ones (Tq, Tk and d; rows that see no key; d past
    128), and a TF32 dense attention held to the same tolerance must fail
    it. Times the kernel at the serving and the training shape, and its
    d > 128 body at d = 256, beside the plain version, SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, kernel_usage)
    hd = D // HEADS

    def qkv(b, h, tq, tk, d):
        return tuple(torch.randn(b, h, t, d, generator=gen, device=dev)
                     for t in (tq, tk, tk))

    def within(got, want):
        return bool(((got - want).abs()
                     <= FLASH_TOL + FLASH_TOL * want.abs()).all())

    worst = 0.0
    for b, h, tq, tk, causal, d in (
            (2, 3, 77, 133, True, hd), (2, 3, 133, 77, True, hd),
            (1, 2, 50, 77, False, hd), (2, 3, 77, 133, True, 128),
            (2, 3, 133, 77, True, 256),      # d > 128, rows without keys
            (1, 2, 50, 77, False, 97),       # ragged d: 4-byte copies
            (1, 2, 130, 70, False, 200),     # ragged d past 128
            (TRAIN_BATCH, HEADS, TRAIN_SEQ, TRAIN_SEQ, True, hd),
            (MAX_BATCH, HEADS, SEQ, SEQ, True, hd)):
        q, k, v = qkv(b, h, tq, tk, d)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = within(got, want)
        log(f"  flash_attention B={b} H={h} Tq={tq} Tk={tk} d={d} causal="
            f"{causal}: max|kernel-plain|={err:.3e} within {FLASH_TOL} "
            f"abs+rel: {ok}")
        if not ok:
            raise SystemExit("flash_attention disagrees with its plain version")
        worst = max(worst, err)

    # the tolerance has teeth: the dense attention with TF32 products, at
    # the serving shape (the last case above)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = (tf32 - want).abs().max().item()
    log(f"  TF32 dense attention at the serving shape: max|tf32 - plain|="
        f"{tf32_err:.3e}; within {FLASH_TOL} abs+rel: {within(tf32, want)} "
        f"(must fail)")
    if within(tf32, want):
        raise SystemExit("FLASH_TOL would pass a TF32 product; tighten it")
    del tf32, want, got

    def timed(q, k, v):
        """(kernel, plain, sdpa ms; bound ms, by, fp32-FMA bound ms; MB,
        GFLOP) of causal attention on these inputs."""
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
        plain = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        iters=5, warmup=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))   # Tq == Tk: top-left == bottom-right
        b, h, t, d = q.shape
        nbytes = 4 * q.numel() * 4                      # q, k, v, o in fp32
        ops = b * h * (t * (t + 1) // 2) * 4 * d        # visible pairs x 4d
        bms, by, fma_ms = fp32_bound(nbytes, ops)
        log(f"  flash_attention B={b} H={h} T={t} d={d} causal: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms; bound "
            f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
            f"GFLOP fp32 as 3xTF32; on fp32 FMAs {fma_ms:.4f} ms)")
        return ms, plain, lib, bms, by

    ms, plain, lib, bms, by = timed(q, k, v)
    del q, k, v
    t_ms, t_plain, t_lib, _, _ = timed(*qkv(TRAIN_BATCH, HEADS, TRAIN_SEQ,
                                            TRAIN_SEQ, hd))
    # the d > 128 body, on no path: logged only
    timed(*qkv(2, HEADS, SEQ, SEQ, 256))
    usage = kernel_usage(hd)
    body = (f"3xTF32 mma.sync m16n8k8, d <= {usage['cols']}: Q tile "
            f"resident, O whole in registers" if hd <= usage["cols"] else
            f"3xTF32 mma.sync m16n8k8, d in {usage['cols']}-column slices")
    log(f"  flash_attention body at d={hd}: {body}; {usage['registers']} "
        f"registers and {usage['local_bytes']} B local a thread, "
        f"{usage['shared_bytes']} B shared a block")
    return {"name": "flash_attention", "route": "cuda",
            "source": "bigdl_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "bigdl_tpu/kernels/flash_attention.py:156",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "body": body, "registers": usage["registers"],
            "shape": f"B={MAX_BATCH} H={HEADS} Tq=Tk={SEQ} d={hd} causal "
                     f"fp32",
            "train_ms": t_ms, "train_plain_ms": t_plain,
            "train_library_ms": t_lib,
            "train_shape": f"B={TRAIN_BATCH} H={HEADS} Tq=Tk={TRAIN_SEQ} "
                           f"d={hd} causal fp32"}


def check_int8(dev, gen):
    import torch
    from bigdl_tpu_torch.kernels.quantized_matmul import (
        int8_matmul, int8_matmul_plain, kernel_body, kernel_usage)

    def case(m, k, n, offset=0):
        """Operands of an (m, k) @ (k, n) product; with `offset`, xq is a
        contiguous view `offset` bytes into its storage (not 16-byte
        aligned)."""
        xq = torch.randint(-127, 128, (m * k + offset,), generator=gen,
                           device=dev, dtype=torch.int8)[offset:].view(m, k)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand(m, 1, generator=gen, device=dev) / 100 + 1e-3
        sw = torch.rand(1, n, generator=gen, device=dev) / 100 + 1e-3
        return xq, wq, wq.t().contiguous(), sx, sw

    m = MAX_BATCH * SEQ
    block = [case(m, D, D_FF), case(m, D, D_FF), case(m, D_FF, D)]
    # ragged: M, N past a tile edge; K % 16 != 0; an unaligned xq
    ragged = [case(70, 96, 50), case(33, 42, 19), case(4095, D, D_FF - 1),
              case(257, 40, 129), case(300, D, 200, offset=1)]
    worst = 0.0
    for xq, wq, wt, sx, sw in block + ragged:
        got = int8_matmul(xq, wq, sx, sw, wq_t=wt)
        want = int8_matmul_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        log(f"  int8_matmul M={xq.shape[0]} K={xq.shape[1]} N={wq.shape[1]}"
            f"{' (xq 1 byte off alignment)' if xq.data_ptr() % 16 else ''}"
            f" [{kernel_body(xq, wt)}]: bitwise equal to plain: {same} "
            f"(max diff {err:.3e})")
        if not same:
            raise SystemExit("int8_matmul is not bitwise equal to its plain "
                             "version")
        worst = max(worst, err)
    # one block's three GEMMs (gate, up, down) at the serving shape
    ms = cuda_ms(lambda: [int8_matmul(x, w, a, b, wq_t=t)
                          for x, w, t, a, b in block])
    plain = cuda_ms(lambda: [int8_matmul_plain(x, w, a, b)
                             for x, w, t, a, b in block], iters=5)
    # no single PyTorch call computes K4's function: its library route is
    # torch._int_mm (the int32 product) and the dequantizing epilogue in
    # PyTorch ops, timed beside _int_mm alone
    def library_route(x, t, a, b):
        return torch._int_mm(x, t.t()).float() * a * b

    lib = cuda_ms(lambda: [library_route(x, t, a, b) for x, w, t, a, b
                           in block])
    int_mm = cuda_ms(lambda: [torch._int_mm(x, t.t()) for x, w, t, a, b
                              in block])
    lib_same = all(torch.equal(library_route(x, t, a, b),
                               int8_matmul_plain(x, w, a, b))
                   for x, w, t, a, b in block)
    nbytes = sum(x.numel() + w.numel() + 4 * (x.shape[0] + w.shape[1])
                 + 4 * x.shape[0] * w.shape[1] for x, w, *_ in block)
    ops = sum(2 * x.shape[0] * x.shape[1] * w.shape[1] for x, w, *_ in block)
    bms, by = bound(nbytes, ops, PEAK_INT8_S)
    body = kernel_body(block[0][0], block[0][2])
    usage = kernel_usage(block[0][0], block[0][2])
    log(f"  int8_matmul gate+up+down M={m}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, library route (_int_mm + epilogue, bitwise equal "
        f"to plain: {lib_same}) {lib:.4f} ms, _int_mm alone {int_mm:.4f} ms; "
        f"bound {bms:.4f} ms ({by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G int8 ops); body at the "
        f"serving shapes: {body}, {usage['registers']} registers and "
        f"{usage['local_bytes']} B local a thread, {usage['shared_bytes']} B "
        f"shared a block")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/kernels/csrc/quantized_matmul.cu",
            "replaces": "bigdl_tpu/kernels/quantized_matmul.py:119",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_route_ms": lib, "library_route":
                "torch._int_mm + .float() * x_scale * w_scale (no single "
                "PyTorch call computes the function)",
            "int_mm_ms": int_mm,
            "body": body, "registers": usage["registers"],
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
        f"backward {lib:.4f} ms (+{lib_mib:.1f} MiB)")
    return {"backward_ms": ms, "backward_plain_ms": plain,
            "backward_library_ms": lib, "backward_max_abs_err": worst,
            "backward_peak_mib": mib, "backward_plain_peak_mib": plain_mib,
            "backward_library_peak_mib": lib_mib,
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


def check_cut_cross_entropy(dev, gen):
    """K3a/K3b/K3c against their plain versions (the same lse and g; K3c's
    evaluated in float64; K3a within LSE_TOL, the others CCE_TOL), and
    the Function's loss and gradients against autograd through the dense
    plain version, at the pipelined LM's microbatch (N = 2 x 1024 rows,
    D = 768, V = 50257), at ragged shapes and past D = 1024; a TF32 dense
    product held to the same tolerances must fail them. Times each kernel
    at the path's shape beside its plain version, the dense route's
    forward or backward (matmul + F.cross_entropy, timed only) and its
    bound, with the peak memory of a forward and backward of both
    routes, and again at GPT-2 large's D = 1280."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels import cut_cross_entropy as cce

    def inputs(n, v, d):
        h = torch.randn(n, d, generator=gen, device=dev)
        w = torch.randn(v, d, generator=gen, device=dev) * d ** -0.5
        labels = torch.randint(0, v, (n,), generator=gen, device=dev)
        return h, w, labels

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    def abs_err(a, b):
        return (a - b).abs().max().item()

    tols = {"cce_lse": LSE_TOL, "cce_dh": CCE_TOL, "cce_dw": CCE_TOL,
            "loss": CCE_TOL, "dh": CCE_TOL, "dw": CCE_TOL}
    worst = {"cce_lse": 0.0, "cce_dh": 0.0, "cce_dw": 0.0}
    n_path = TRAIN_BATCH // PIPE_MICRO * TRAIN_SEQ
    # the path's shape, N past K3b's 32-row tile, ragged small ones, and
    # widths past 1024 (K3b and K3c cut D over a grid axis there)
    shapes = [(n_path, GPT2_VOCAB, GPT2_D), (n_path - 1, GPT2_VOCAB, GPT2_D),
              (333, 1029, 96), (130, 777, 100), (256, 1029, 1025),
              (130, 777, LARGE_D), (77, 515, 2049)]
    def kernel_errs(h, w, lse_p, g):
        """max|kernel - plain| / max|plain| of K3a, K3b and K3c on these
        inputs; worst keeps the largest absolute error of each."""
        pairs = {"cce_lse": (cce.cce_lse(h, w), lse_p),
                 "cce_dh": (cce.cce_dh(h, w, lse_p, g),
                            cce.cce_dh_plain(h, w, lse_p, g)),
                 # K3c against the plain dw in float64: the fp32 one is
                 # itself 3-4.5e-6 of its largest value away from it
                 "cce_dw": (cce.cce_dw(h, w, lse_p, g),
                            cce.cce_dw_plain(h.double(), w.double(),
                                             lse_p.double(), g.double()))}
        for k, ab in pairs.items():
            worst[k] = max(worst[k], abs_err(*ab))
        return {k: rel(*ab) for k, ab in pairs.items()}

    for n, v, d in shapes:
        h, w, labels = inputs(n, v, d)
        g = torch.full((n,), 1.0 / n, device=dev)
        lse_p = cce.cce_lse_plain(h, w)
        errs = kernel_errs(h, w, lse_p, g)
        hr, wr = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = cce.cut_cross_entropy(hr, wr, labels) if n % 128 == 0 else \
            cce.cut_cross_entropy(hr, wr, labels, block_n=n)
        gh, gw = torch.autograd.grad(loss.mean(), (hr, wr))
        want = cce.cut_cross_entropy_plain(hr, wr, labels)
        wh, ww = torch.autograd.grad(want.mean(), (hr, wr))
        torch.cuda.synchronize()
        fn_errs = {"loss": rel(loss, want), "dh": rel(gh, wh),
                   "dw": rel(gw, ww)}
        ok = all(e <= tols[k] for k, e in [*errs.items(), *fn_errs.items()])
        log(f"  cut cross-entropy N={n} V={v} D={d}: max|kernel - plain| / "
            f"max|plain|: " + ", ".join(f"{k} {e:.3e}" for k, e in
                                        errs.items())
            + "; through the Function: " + ", ".join(
                f"{k} {e:.3e}" for k, e in fn_errs.items())
            + f"; lse within {LSE_TOL}, the rest within {CCE_TOL}: {ok}")
        if not ok:
            raise SystemExit("the cut cross-entropy kernels disagree with "
                             "their plain versions")
        del hr, wr, loss, gh, gw, want, wh, ww

    # the tolerances have teeth: the plain lse, dh and dw with TF32 products
    h, w, labels = inputs(n_path, GPT2_VOCAB, GPT2_D)
    g = torch.full((n_path,), 1.0 / n_path, device=dev)
    lse_p = cce.cce_lse_plain(h, w)
    exact = (lse_p, cce.cce_dh_plain(h, w, lse_p, g),
             cce.cce_dw_plain(h, w, lse_p, g))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = (cce.cce_lse_plain(h, w), cce.cce_dh_plain(h, w, lse_p, g),
                cce.cce_dw_plain(h, w, lse_p, g))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_errs = [rel(a, b) for a, b in zip(tf32, exact)]
    fails = (tf32_errs[0] > LSE_TOL, min(tf32_errs[1:]) > CCE_TOL)
    log(f"  TF32 dense products at the path's shape: lse {tf32_errs[0]:.3e} "
        f"(LSE_TOL {LSE_TOL}: fails it: {fails[0]}), dh {tf32_errs[1]:.3e}, "
        f"dw {tf32_errs[2]:.3e} of the largest value (CCE_TOL {CCE_TOL}: "
        f"fails it: {fails[1]})")
    if not all(fails):
        raise SystemExit("LSE_TOL or CCE_TOL would pass a TF32 product; "
                         "tighten it")
    del exact, tf32

    # K3a's and K3b's chunk merges are in index order, K3c's blocks walk
    # the h rows in order, and no kernel reads the TF32 switch: two
    # launches, and one with the switch on, agree bit for bit
    for name, fn in (("cce_lse", lambda: cce.cce_lse(h, w)),
                     ("cce_dh", lambda: cce.cce_dh(h, w, lse_p, g)),
                     ("cce_dw", lambda: cce.cce_dw(h, w, lse_p, g))):
        first = fn()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            flag = fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        again = fn()
        torch.cuda.synchronize()
        same = torch.equal(first, again) and torch.equal(first, flag)
        log(f"  {name} at the path's shape: two launches and one with "
            f"allow_tf32 on bitwise equal: {same}")
        if not same:
            raise SystemExit(f"{name} is not deterministic or reads the TF32 "
                             "switch")
        del first, again, flag

    def dense_route(h, w, labels):
        """Leaves hr, wr and the dense route's forward on them (matmul +
        F.cross_entropy)."""
        hr, wr = h.clone().requires_grad_(), w.clone().requires_grad_()

        def fwd():
            return F.cross_entropy(torch.matmul(hr, wr.T), labels,
                                   reduction="none")
        return hr, wr, fwd

    def timed(h, w, hr, wr, dense_fwd):
        """Holds K3a, K3b and K3c to their plain versions on the inputs
        they are timed on (as in the loop above), then (kernel, plain,
        dense route) ms of each."""
        n, v, d = h.shape[0], w.shape[0], h.shape[1]
        g = torch.full((n,), 1.0 / n, device=dev)
        lse_p = cce.cce_lse_plain(h, w)
        errs = kernel_errs(h, w, lse_p, g)
        ok = all(e <= tols[k] for k, e in errs.items())
        log(f"  timed inputs N={n} V={v} D={d}: max|kernel - plain| / "
            f"max|plain|: " + ", ".join(f"{k} {e:.3e}" for k, e in
                                        errs.items())
            + f"; lse within {LSE_TOL}, the rest within {CCE_TOL}: {ok}")
        if not ok:
            raise SystemExit("the cut cross-entropy kernels disagree with "
                             "their plain versions")
        lib_fwd = cuda_ms(dense_fwd, iters=5, warmup=1)
        out = dense_fwd()
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            out.mean(), (hr, wr), retain_graph=True), iters=5, warmup=1)
        del out
        return {"cce_lse": (cuda_ms(lambda: cce.cce_lse(h, w), iters=10),
                            cuda_ms(lambda: cce.cce_lse_plain(h, w), iters=5,
                                    warmup=1), lib_fwd),
                "cce_dh": (cuda_ms(lambda: cce.cce_dh(h, w, lse_p, g),
                                   iters=10),
                           cuda_ms(lambda: cce.cce_dh_plain(h, w, lse_p, g),
                                   iters=5, warmup=1), lib_bwd),
                "cce_dw": (cuda_ms(lambda: cce.cce_dw(h, w, lse_p, g),
                                   iters=10),
                           cuda_ms(lambda: cce.cce_dw_plain(h, w, lse_p, g),
                                   iters=5, warmup=1), lib_bwd)}

    # timing at the path's shape
    n, v, d = n_path, GPT2_VOCAB, GPT2_D
    hr, wr, dense_fwd = dense_route(h, w, labels)
    times = timed(h, w, hr, wr, dense_fwd)

    def peak(route):
        """Peak MiB above the inputs of one forward and backward."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(route().mean(), (hr, wr))
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    fused_mib = peak(lambda: cce.cut_cross_entropy(hr, wr, labels))
    dense_mib = peak(dense_fwd)
    fused_ms = cuda_ms(lambda: torch.autograd.grad(
        cce.cut_cross_entropy(hr, wr, labels).mean(), (hr, wr)), iters=5,
        warmup=1)
    dense_ms = cuda_ms(lambda: torch.autograd.grad(
        dense_fwd().mean(), (hr, wr)), iters=5, warmup=1)
    log(f"  whole loss, forward and backward, N={n} V={v} D={d}: cut "
        f"cross-entropy {fused_ms:.4f} ms (peak +{fused_mib:.1f} MiB), dense "
        f"matmul + F.cross_entropy {dense_ms:.4f} ms (+{dense_mib:.1f} MiB)")
    del hr, wr, h, w, labels, g, lse_p
    gemm = 2 * n * v * d                          # one N x V x D product
    io = 4 * (n * d + v * d)                      # h and w read once
    rows = []
    for name, line, ops, nbytes in (
            ("cce_lse", 75, gemm, io + 4 * n),
            ("cce_dh", 119, 2 * gemm, io + 8 * n + 4 * n * d),
            ("cce_dw", 166, 2 * gemm, io + 8 * n + 4 * v * d)):
        ms, plain, lib = times[name]
        bms, by, fma_ms = fp32_bound(nbytes, ops)
        route = "forward" if name == "cce_lse" else "backward"
        log(f"  {name} N={n} V={v} D={d}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, dense route {route} {lib:.4f} ms; bound "
            f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} "
            f"GFLOP fp32 as 3xTF32; on fp32 FMAs {fma_ms:.4f} ms)")
        rows.append({"name": name, "route": "cuda",
                     "source": "bigdl_tpu_torch/kernels/csrc/"
                               "cut_cross_entropy.cu",
                     "replaces": f"bigdl_tpu/kernels/cut_cross_entropy.py:"
                                 f"{line}",
                     "max_abs_err": worst[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib,
                     "peak_mib": fused_mib, "library_peak_mib": dense_mib,
                     "shape": f"N={n} V={v} D={d} fp32"})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lse_use = cce.lse_kernel_usage(d)
    dh_use, dw_use = cce.dh_kernel_usage(d), cce.dw_kernel_usage(d)
    for row, usage, body in (
            (rows[0], lse_use, f"{lse_use['rows']} h rows x "
             f"{cce.LSE_VOCAB_TILE} vocab rows a block, 3-stage cp.async "
             f"ring over 64-deep slices of D, S promoted every 32 columns, "
             f"{cce._lse_splits(n, v, dev)} vocab chunks"),
            (rows[1], dh_use, f"{dh_use['rows']} h rows a block, "
             f"{cce.dh_splits(n, v, d, sms)} vocab chunks"),
            (rows[2], dw_use, f"{dw_use['rows']} w rows a block, "
             f"{-(-v // dw_use['rows'])} blocks")):
        body = "3xTF32 mma.sync m16n8k8, " + body
        log(f"  {row['name']} body at the path's shape: {body}; "
            f"{usage['registers']} registers and {usage['local_bytes']} B "
            f"local a thread, {usage['shared_bytes']} B shared a block")
        row.update(body=body, registers=usage["registers"],
                   local_bytes=usage["local_bytes"],
                   shared_bytes=usage["shared_bytes"])

    # GPT-2 large's width: K3a streams D; K3b and K3c take the wide body
    torch.cuda.empty_cache()
    h, w, labels = inputs(n_path, GPT2_VOCAB, LARGE_D)
    wide = timed(h, w, *dense_route(h, w, labels))
    use = cce.dh_kernel_usage(LARGE_D)
    log(f"  at GPT-2 large's D={LARGE_D} (N={n_path} V={GPT2_VOCAB}): "
        + "; ".join(f"{k} kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, dense "
                    f"route {'forward' if k == 'cce_lse' else 'backward'} "
                    f"{t[2]:.4f} ms" for k, t in wide.items())
        + f"; the K3b/K3c body there: {use['rows']} rows a block, "
        f"{use['d_chunks']} chunks of D, "
        f"{use['registers']} registers, {use['local_bytes']} B local, "
        f"{use['shared_bytes']} B shared")
    for row in rows:
        ms, plain, lib = wide[row["name"]]
        row.update(d1280_ms=ms, d1280_plain_ms=plain, d1280_library_ms=lib)
    del h, w, labels
    torch.cuda.empty_cache()
    return rows


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


# ---------------------------------------------------------------- phase 6
def pipelined_step_split(lm, x, y, method, slots):
    """One real train_step of the pipelined LM with CUDA events around
    its parts: the embedding's forward, the stages' forward and the loss
    of each microbatch, and the update (each summed over its calls); the
    backward is the rest of the step (the autograd passes through the
    loss and the stages, and the embedding's backward). Then the same
    step under torch.profiler for the kernels by device time. Returns
    ({part: ms}, device busy ms, slots)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.models import pipelined_lm as plm
    marks = []

    def timed(name, fn):
        def run(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            marks.append((name, e0, e1))
            return out
        return run

    loss_fn, update = lm.loss_fn(), plm.apply_update
    lm._embed = timed("embedding", lm._embed)
    lm.pipe._stages = timed("forward", lm.pipe._stages)
    lm.loss_fn = lambda: timed("loss", loss_fn)
    plm.apply_update = timed("update", update)
    try:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        _, slots = lm.train_step(x, y, method=method, slots=slots)
        end.record()
        end.synchronize()
    finally:
        del lm._embed, lm.pipe._stages, lm.loss_fn
        plm.apply_update = update
    parts = dict.fromkeys(("embedding", "forward", "loss", "update"), 0.0)
    for name, e0, e1 in marks:
        parts[name] += e0.elapsed_time(e1)
    total = start.elapsed_time(end)
    parts["backward"] = total - sum(parts.values())
    log("  one step, CUDA events (summed over the "
        f"{lm.pipe.n_microbatches} microbatches): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; total {total:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        _, slots = lm.train_step(x, y, method=method, slots=slots)
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
    return parts, busy_ms, slots


def pipelined_slice(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels import cut_cross_entropy as cce
    from bigdl_tpu_torch.kernels.flash_attention import flash_attention
    from bigdl_tpu_torch.models.pipelined_lm import PipelinedLM
    from bigdl_tpu_torch.optim.method import Adam, init_update_slots

    def build(fused):
        return PipelinedLM(GPT2_VOCAB, d_model=GPT2_D, num_heads=GPT2_HEADS,
                           d_ff=GPT2_FF, num_layers=GPT2_LAYERS,
                           n_stages=PIPE_STAGES, n_microbatches=PIPE_MICRO,
                           max_len=TRAIN_SEQ, fused_loss=fused, device=dev)

    def step_peak_mib(model, slots):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = model.train_step(x, y, method=adam, slots=slots)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() / 2**20

    t0 = time.monotonic()
    r = np.random.RandomState(0)
    tokens = r.randint(0, GPT2_VOCAB, (TRAIN_BATCH, TRAIN_SEQ + 1))
    x, y = tokens[:, :-1], tokens[:, 1:]
    lm = build(True)
    lm.init(torch.Generator(device=dev).manual_seed(0))
    initial = {k: v.detach().clone() for k, v in lm.named_parameters()}
    n_params = sum(p.numel() for p in initial.values())
    adam = Adam(TRAIN_LR)
    slots = init_update_slots(adam, lm.param_tree())
    log(f"  PipelinedLM {n_params} params in {len(initial)} leaves "
        f"({PIPE_STAGES} stage, {PIPE_MICRO} microbatches of "
        f"{TRAIN_BATCH // PIPE_MICRO}x{TRAIN_SEQ}), fused_loss, "
        f"Adam({TRAIN_LR}); set up in {time.monotonic() - t0:.1f} s")
    counters = (cce.cce_lse, cce.cce_dh, cce.cce_dw, flash_attention)
    for c in counters:
        c.launches.reset()
    losses, times, per_step, emb1 = [], [], set(), None
    torch.cuda.synchronize()
    t_run = time.monotonic()
    for i in range(TRAIN_STEPS):
        before = [c.launches.value for c in counters]
        ts = time.perf_counter()
        loss, slots = lm.train_step(x, y, method=adam, slots=slots)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        per_step.add(tuple(c.launches.value - b
                           for c, b in zip(counters, before)))
        losses.append(loss)
        if i == 0:
            emb1 = lm.emb.detach().clone()
    wall = time.monotonic() - t_run
    counts = {c.__name__: c.launches.value for c in counters}
    log(f"  {len(losses)} steps in {wall:.2f} s; losses "
        + " ".join(f"{v:.4f}" for v in losses))
    want = (PIPE_MICRO, PIPE_MICRO, PIPE_MICRO, 0)
    log(f"  launches: {counts}; (K3a, K3b, K3c, K2) per step: "
        f"{sorted(per_step)} (want {want} in every step)")
    if per_step != {want}:
        raise SystemExit("the pipelined LM's steps did not run through the "
                         "kernels as counted")
    if not all(map(math.isfinite, losses)):
        raise SystemExit("a pipelined LM loss is not finite")
    drop = losses[0] - sum(losses[-5:]) / 5
    log(f"  loss {losses[0]:.4f} -> mean of the last 5 "
        f"{sum(losses[-5:]) / 5:.4f} (drop {drop:.4f}, want >= 0.5)")
    if drop < 0.5:
        raise SystemExit("the pipelined LM's loss did not fall by 0.5")
    med = sorted(times[1:])[len(times[1:]) // 2]
    log(f"  step time median {med * 1e3:.2f} ms over steps 2-{TRAIN_STEPS} "
        f"(host clock, the card synchronized at each step), "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; first step "
        f"{times[0] * 1e3:.2f} ms")

    # the forward path: logits of the trained model, and their dense loss
    # against the fused loss of the same hidden states
    with torch.no_grad():
        xd, yd = lm._tokens(x), lm._tokens(y)
        logits = lm(xd)
        dense_now = F.cross_entropy(logits.reshape(-1, GPT2_VOCAB),
                                    yd.reshape(-1)).item()
        ok_logits = (tuple(logits.shape) == (TRAIN_BATCH, TRAIN_SEQ,
                                             GPT2_VOCAB)
                     and bool(torch.isfinite(logits).all()))
        del logits
        lp = {"emb": lm.emb, "ln.weight": lm.ln.weight,
              "ln.bias": lm.ln.bias}
        h = lm.pipe(lm._embed(lm.emb, xd))
        fused_now = sum(lm.loss_fn()(hm, ym, lp).item() for hm, ym in zip(
            lm.pipe._microbatches(h), lm.pipe._microbatches(yd))) / PIPE_MICRO
        del h
    rel_now = abs(fused_now - dense_now) / abs(dense_now)
    log(f"  trained model: logits {TRAIN_BATCH}x{TRAIN_SEQ}x{GPT2_VOCAB} "
        f"finite: {ok_logits}; their mean loss {dense_now:.6f} vs the fused "
        f"loss {fused_now:.6f} (relative {rel_now:.2e}, want <= 1e-5)")
    if not ok_logits or rel_now > 1e-5:
        raise SystemExit("the trained pipelined LM's forward is wrong")

    split, busy_ms, slots = pipelined_step_split(lm, x, y, adam, slots)
    idle = 1 - busy_ms / (med * 1e3)
    log(f"  device idle share of a step: 1 - {busy_ms:.2f} ms busy "
        f"(profiled) / {med * 1e3:.2f} ms median step = {idle:.3f}")
    (_, slots), fused_mib = step_peak_mib(lm, slots)
    del lm, slots
    torch.cuda.empty_cache()

    # the first step again from the same weights with the dense loss
    dense = build(False)
    for k, v in initial.items():
        mod, _, leaf = k.rpartition(".")
        (dense.get_submodule(mod) if mod else dense).set_param(leaf, v)
    (loss_d, _), dense_mib = step_peak_mib(
        dense, init_update_slots(adam, dense.param_tree()))
    rel = abs(loss_d - losses[0]) / abs(losses[0])
    diff = (dense.emb.detach() - emb1).abs()
    emb_err = diff.max().item()
    log(f"  first loss, dense loss: {loss_d:.6f} vs fused {losses[0]:.6f} "
        f"(relative {rel:.2e}, want <= 1e-5); embedding after one step: "
        f"max|dense - fused| {emb_err:.3e} (want <= "
        f"{EMB_TOL_LR * TRAIN_LR:.1e}), {int((diff > 1e-3 * TRAIN_LR).sum())}"
        f" of {diff.numel()} elements above {1e-3 * TRAIN_LR:.1e}; peak "
        f"memory of a step: fused loss {fused_mib:.0f} MiB, dense loss "
        f"{dense_mib:.0f} MiB")
    if rel > 1e-5:
        raise SystemExit("the fused loss differs from the dense loss")
    if emb_err > EMB_TOL_LR * TRAIN_LR:
        raise SystemExit("the fused step's embedding differs from the "
                         "dense step's")
    return ({"cce_lse": counts["cce_lse"], "cce_dh": counts["cce_dh"],
             "cce_dw": counts["cce_dw"]},
            {"step_ms_median": med * 1e3,
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
             "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
             "split_ms": split, "device_busy_ms": busy_ms,
             "idle_share": idle, "peak_mib_fused": fused_mib,
             "peak_mib_dense": dense_mib, "emb_max_abs_diff": emb_err})


def pipelined_large_slice(dev):
    """PipelinedLM at GPT-2 large's width (LARGE_*), fused loss, a few
    Adam steps: the entry point whose loss once refused D > 1024. Every
    loss finite, exactly LARGE_MICRO launches of each cut cross-entropy
    kernel per step and no flash launch, the first loss within 1e-5
    (relative) of a dense-loss step of the same weights."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.kernels import cut_cross_entropy as cce
    from bigdl_tpu_torch.kernels.flash_attention import flash_attention
    from bigdl_tpu_torch.models.pipelined_lm import PipelinedLM
    from bigdl_tpu_torch.optim.method import Adam, init_update_slots

    def build(fused):
        return PipelinedLM(GPT2_VOCAB, d_model=LARGE_D, num_heads=LARGE_HEADS,
                           d_ff=LARGE_FF, num_layers=LARGE_LAYERS,
                           n_stages=1, n_microbatches=LARGE_MICRO,
                           max_len=TRAIN_SEQ, fused_loss=fused, device=dev)

    r = np.random.RandomState(1)
    tokens = r.randint(0, GPT2_VOCAB, (LARGE_BATCH, TRAIN_SEQ + 1))
    x, y = tokens[:, :-1], tokens[:, 1:]
    lm = build(True)
    lm.init(torch.Generator(device=dev).manual_seed(0))
    initial = {k: v.detach().clone() for k, v in lm.named_parameters()}
    adam = Adam(TRAIN_LR)
    slots = init_update_slots(adam, lm.param_tree())
    log(f"  PipelinedLM d_model {LARGE_D}, {LARGE_HEADS} heads, d_ff "
        f"{LARGE_FF}, {LARGE_LAYERS} layers, "
        f"{sum(p.numel() for p in initial.values())} params (1 stage, "
        f"{LARGE_MICRO} microbatches of {LARGE_BATCH // LARGE_MICRO}x"
        f"{TRAIN_SEQ}), fused_loss, Adam({TRAIN_LR})")
    counters = (cce.cce_lse, cce.cce_dh, cce.cce_dw, flash_attention)
    for c in counters:
        c.launches.reset()
    losses, times, per_step = [], [], set()
    for _ in range(LARGE_STEPS):
        before = [c.launches.value for c in counters]
        torch.cuda.synchronize()
        ts = time.perf_counter()
        loss, slots = lm.train_step(x, y, method=adam, slots=slots)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        per_step.add(tuple(c.launches.value - b
                           for c, b in zip(counters, before)))
        losses.append(loss)
    counts = {c.__name__: c.launches.value for c in counters}
    want = (LARGE_MICRO, LARGE_MICRO, LARGE_MICRO, 0)
    log(f"  {LARGE_STEPS} steps, losses " + " ".join(f"{v:.4f}" for v in
                                                   losses)
        + f", step ms " + " ".join(f"{t * 1e3:.2f}" for t in times)
        + f"; launches: {counts}; (K3a, K3b, K3c, K2) per step: "
        f"{sorted(per_step)} (want {want} in every step)")
    if per_step != {want}:
        raise SystemExit("the GPT-2-large-width LM's steps did not run "
                         "through the kernels as counted")
    if not all(map(math.isfinite, losses)):
        raise SystemExit("a GPT-2-large-width LM loss is not finite")
    del lm, slots
    torch.cuda.empty_cache()
    dense = build(False)
    for k, v in initial.items():
        mod, _, leaf = k.rpartition(".")
        (dense.get_submodule(mod) if mod else dense).set_param(leaf, v)
    loss_d, _ = dense.train_step(x, y, method=adam,
                                 slots=init_update_slots(adam,
                                                         dense.param_tree()))
    rel = abs(loss_d - losses[0]) / abs(losses[0])
    log(f"  first loss, dense loss: {loss_d:.6f} vs fused {losses[0]:.6f} "
        f"(relative {rel:.2e}, want <= 1e-5)")
    if rel > 1e-5:
        raise SystemExit("the GPT-2-large-width fused loss differs from the "
                         "dense loss")
    del dense, initial
    torch.cuda.empty_cache()
    return ({"cce_lse": counts["cce_lse"], "cce_dh": counts["cce_dh"],
             "cce_dw": counts["cce_dw"]},
            {"losses": losses, "loss_first_dense": loss_d,
             "loss_first_rel": rel,
             "step_ms": [t * 1e3 for t in times]})


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
    record = [flash, check_int8(dev, gen), check_fused_update(dev, gen),
              *check_cut_cross_entropy(dev, gen)]
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
    torch.cuda.empty_cache()

    log("phase 6: the pipelined LM at GPT-2-small width, fused loss")
    by_path["pipelined"], pipelined = pipelined_slice(dev)
    log("  pipelined " + json.dumps(pipelined))
    torch.cuda.empty_cache()

    log("phase 7: the pipelined LM at GPT-2-large width, fused loss")
    by_path["pipelined_large"], large = pipelined_large_slice(dev)
    log("  pipelined_large " + json.dumps(large))
    for k in record:
        counts = {path: n.get(k["name"], 0) for path, n in by_path.items()}
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
