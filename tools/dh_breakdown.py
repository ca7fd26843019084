"""Where the time and the error of the cut cross-entropy kernels go: K3a
(lse) and K3b and K3c (dh and dw, one tensor-core body with the roles of
h and w swapped).

    python tools/dh_breakdown.py

A development tool, not part of the package. Rebuilds
bigdl_tpu_torch/kernels/csrc/cut_cross_entropy.cu with one part of the
bodies' work taken out or changed at a time, and times the kernels each
variant changes on the card at the pipelined LM's shape (N = 2048, V =
50257, D = 768, g = 1/N, CUDA events, 10 launches after 2), with each
one's error against the fp32 plain version and against the plain version
evaluated in float64 (max |x - ref| / max |ref|):

  kernel        the source as it is (lse, dh, dw);
  no_refill     the walker tile is never refilled (the time without the
                copies; the results are wrong);
  no_split      operands go to the MMAs unsplit, lo = hi (the time
                without the hi/lo split; the results are wrong; lse,
                dh, dw);
  one_mma       one TF32 MMA where 3xTF32 takes three (single-TF32
                error; lse, dh, dw);
  no_promote    the P.w product accumulates in the MMAs over the whole
                walk instead of being summed per tile and added in fp32
                (the arithmetic is right: the error shows what the
                tensor cores' truncating accumulation costs);
  s_every_step  S is added in fp32 after every 8-deep step of D instead
                of every SK (4);
  s_unpromoted  each warp's share of S accumulates in the MMAs over all
                of its columns;
  lse_s_unpromoted  K3a's S accumulates in the MMAs over all of D
                instead of being summed from zero per 32 columns and
                added in fp32;
  lse_no_epilogue  K3a with one online-logsumexp step at the end instead
                of one per vocab tile (the time of the product alone;
                the results are wrong).

Each variant is a text edit of the kernel's source or of the header it
shares with K2 (csrc/tf32x3.cuh); an edit that does not match exactly
one place in them stops the tool with the text it looked for. Each
variant is compiled by nvcc into bigdl_tpu_torch/_build/dh_breakdown/,
all at once.
CUDA only; prints one line per variant and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bigdl_tpu_torch.kernels import _native  # noqa: E402

SPLIT = ("  hi = __float_as_uint(x) & TF32_MASK;\n"
         "  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));")
SPLIT_EXACT = ("  hi = __float_as_uint(x) & TF32_MASK;\n"
               "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));")
UNSPLIT = "  hi = __float_as_uint(x);\n  lo = hi;"
MMA3 = ("  mma_tf32(c, al, bh0, bh1);\n"
        "  mma_tf32(c, ah, bl0, bl1);\n")
DH_MMA = "mma3(tmp[mt][i], ah[mt], al[mt], bh0, bh1, bl0, bl1);"

SK = "constexpr int SK = 4; "

ALL, GRAD = ("lse", "dh", "dw"), ("dh", "dw")
# name: (edits, the kernels the edits change and the tool times)
VARIANTS = {
    "kernel": ([], ALL),
    "no_refill": ([("if (ng + 4 == NTW) refill(kb);", "")], GRAD),
    "no_split": ([(SPLIT, UNSPLIT), (SPLIT_EXACT, UNSPLIT)], ALL),
    "one_mma": ([(MMA3, "")], ALL),
    # tmp stays zero, so the promotion adds nothing
    "no_promote": ([(DH_MMA, DH_MMA.replace("tmp[mt][i]",
                                            "acc[mt][ng + i]"))], GRAD),
    "s_every_step": ([(SK, SK.replace("4", "1"))], GRAD),
    # one group of all NTW steps
    "s_unpromoted": ([("kg < NTW; kg += SK", "kg < 1; kg += SK"),
                      ("ks < kg + SK; ++ks", "ks < NTW; ++ks")], GRAD),
    # sk stays zero, so adding it to S adds nothing
    "lse_s_unpromoted": ([("mma3(sk[mt]", "mma3(s[mt]")], ("lse",)),
    # one epilogue, at the end, over the sum of every tile's S: the
    # products stay live
    "lse_no_epilogue": ([("if ((it + 1) % nks) continue;",
                          "if (it + 1 < total) continue;")], ("lse",)),
}
SHAPE = (2048, 50257, 768)


def build(name: str, sources: dict):
    """Compile one variant of `sources` ({file name: text}); returns
    (name, library path, nvcc's log)."""
    sources = dict(sources)
    for old, new in VARIANTS[name][0]:
        hits = [f for f, text in sources.items() if old in text]
        if len(hits) != 1 or sources[hits[0]].count(old) != 1:
            raise RuntimeError(f"{name}: the edit no longer matches the "
                               f"source: {old!r}")
        sources[hits[0]] = sources[hits[0]].replace(old, new)
    out = _native.BUILD_DIR / "dh_breakdown" / name
    out.mkdir(parents=True, exist_ok=True)
    for f, text in sources.items():
        (out / f).write_text(text)
    src, lib = out / "cut_cross_entropy.cu", out / f"{name}.so"
    res = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    return name, lib, res.stdout + res.stderr


def usage(log: str, kernel: str) -> str:
    """ptxas's register line for the body whose mangled name contains
    `kernel`."""
    entry = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "registers" in ln and kernel in entry:
            return ln.split(":")[-1].strip()
    return "not found"


# the K3a body and the K3b body at SHAPE's width (768)
BODIES = {"lse": "cce_lse_kernel", "dh": "cce_grad_kernelILi2ELi12ELb0E"}


def main() -> int:
    import torch
    from bigdl_tpu_torch.kernels import cut_cross_entropy as cce
    if not torch.cuda.is_available():
        print("dh_breakdown: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {f: (_native.CSRC / f).read_text()
               for f in ("cut_cross_entropy.cu", "tf32x3.cuh")}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda v: build(v, sources), VARIANTS))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, v, d = SHAPE
    h = torch.randn(n, d, generator=gen, device=dev)
    w = torch.randn(v, d, generator=gen, device=dev) * d ** -0.5
    g = torch.full((n,), 1.0 / n, device=dev)
    lse = cce.cce_lse_plain(h, w)
    plain = {"lse": lse, "dh": cce.cce_dh_plain(h, w, lse, g),
             "dw": cce.cce_dw_plain(h, w, lse, g)}
    p64 = cce._probs(h.double(), w.double(), lse.double(), g.double())
    exact = {"lse": cce.cce_lse_plain(h.double(), w.double()),
             "dh": p64 @ w.double(), "dw": p64.T @ h.double()}
    del p64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = cce.dh_splits(n, v, d, sms)
    lse_splits = cce._lse_splits(n, v, dev)
    out = {"lse": torch.empty_like(lse), "dh": torch.empty_like(h),
           "dw": torch.empty_like(w)}
    scratch = torch.empty(splits * n * d, device=dev)
    lse_scratch = torch.empty(2 * lse_splits * n, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int

    def rel(x, ref):
        return ((x.double() - ref.double()).abs().max()
                / ref.abs().max()).item()

    print(f"K3a, K3b and K3c at N={n} V={v} D={d}, g = 1/N, K3a in "
          f"{lse_splits} and K3b in {splits} vocab chunks; the plain fp32 "
          f"versions against float64: lse {rel(plain['lse'], exact['lse']):.3e}"
          f", dh {rel(plain['dh'], exact['dh']):.3e}, dw "
          f"{rel(plain['dw'], exact['dw']):.3e}", flush=True)
    for name, lib, log in built:
        lib_ = ctypes.CDLL(str(lib))
        flse = lib_.bigdl_cce_lse_f32
        fdh, fdw = lib_.bigdl_cce_dh_f32, lib_.bigdl_cce_dw_f32
        flse.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fdh.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fdw.argtypes = [p, p, p, p, p, i, i, i, i, p]
        flse.restype = fdh.restype = fdw.restype = ctypes.c_int
        runs = {
            "lse": lambda: _native.check(flse(
                h.data_ptr(), w.data_ptr(), out["lse"].data_ptr(),
                lse_scratch.data_ptr(), n, v, d, lse_splits,
                *_native.device_and_stream(dev)), name),
            "dh": lambda: _native.check(fdh(
                h.data_ptr(), w.data_ptr(), lse.data_ptr(), g.data_ptr(),
                out["dh"].data_ptr(), scratch.data_ptr(), n, v, d, splits,
                *_native.device_and_stream(dev)), name),
            "dw": lambda: _native.check(fdw(
                h.data_ptr(), w.data_ptr(), lse.data_ptr(), g.data_ptr(),
                out["dw"].data_ptr(), n, v, d,
                *_native.device_and_stream(dev)), name)}
        parts = []
        for k in VARIANTS[name][1]:
            run = runs[k]
            for _ in range(2):
                run()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(10):
                run()
            t1.record()
            t1.synchronize()
            parts.append(f"{k} {t0.elapsed_time(t1) / 10:.4f} ms, of max "
                         f"vs plain {rel(out[k], plain[k]):.3e}, vs float64 "
                         f"{rel(out[k], exact[k]):.3e}")
        regs = "; ".join(f"{k} {usage(log, BODIES[k])}" for k in BODIES
                         if k in VARIANTS[name][1])
        print(f"  {name:16s} {'; '.join(parts)}; ptxas: {regs}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
