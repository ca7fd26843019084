"""Where the time of K3b (cut cross-entropy's dh kernel) goes.

    python tools/dh_breakdown.py

A development tool, not part of the package. Rebuilds
bigdl_tpu_torch/kernels/csrc/cut_cross_entropy.cu with one part of K3b's work taken out
at a time, and times each build on the card at the pipelined LM's shape
(N = 2048, V = 50257, D = 768, CUDA events, 10 launches after 2) with
its error against the plain version:

  kernel      the source as it is;
  no_refill   the w tile is never refilled (the time without the copies;
              dh is wrong);
  no_split    operands go to the MMAs unsplit, lo = hi (the time without
              the hi/lo split; dh is wrong);
  one_mma     one TF32 MMA where 3xTF32 takes three (dh has single-TF32
              error);
  no_promote  the P.w product accumulates in the MMAs over the whole vocab
              chunk instead of being summed per tile and added in fp32
              (the arithmetic is right: the error shows what the tensor
              cores' truncating accumulation costs).

Each variant is a text edit of the kernel's source; an edit that no
longer matches it stops the tool with the text it looked for. Each
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

VARIANTS = {
    "kernel": [],
    "no_refill": [("if (ng + 4 == NTW && t + 1 < t1) {", "if (false) {")],
    "no_split": [(SPLIT, UNSPLIT), (SPLIT_EXACT, UNSPLIT)],
    "one_mma": [(MMA3, "")],
    # tmp stays zero, so the promotion adds nothing
    "no_promote": [(DH_MMA, DH_MMA.replace("tmp[mt][i]", "acc[mt][ng + i]"))],
}
SHAPE = (2048, 50257, 768)


def build(name: str, source: str):
    """Compile one variant; returns (name, library path, nvcc's log)."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"{name}: the edit no longer matches the "
                               f"source: {old!r}")
        source = source.replace(old, new)
    out = _native.BUILD_DIR / "dh_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"{name}.so"
    src.write_text(source)
    res = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    return name, lib, res.stdout + res.stderr


def usage(log: str) -> str:
    """ptxas's register line for the K3b body at SHAPE's width (768)."""
    entry = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "registers" in ln and "cce_dh_kernelILi2ELi12E" in entry:
            return ln.split(":")[-1].strip()
    return "not found"


def main() -> int:
    import torch
    from bigdl_tpu_torch.kernels import cut_cross_entropy as cce
    if not torch.cuda.is_available():
        print("dh_breakdown: no CUDA device is visible", file=sys.stderr)
        return 2
    source = (_native.CSRC / "cut_cross_entropy.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda v: build(v, source), VARIANTS))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, v, d = SHAPE
    h = torch.randn(n, d, generator=gen, device=dev)
    w = torch.randn(v, d, generator=gen, device=dev) * d ** -0.5
    g = torch.full((n,), 1.0 / n, device=dev)
    lse = cce.cce_lse_plain(h, w)
    want = cce.cce_dh_plain(h, w, lse, g)
    splits = cce.dh_splits(n, v, d, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    dh = torch.empty_like(h)
    scratch = torch.empty(splits * n * d, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    print(f"K3b at N={n} V={v} D={d}, {splits} vocab chunks", flush=True)
    for name, lib, log in built:
        fn = ctypes.CDLL(str(lib)).bigdl_cce_dh_f32
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int

        def run():
            _native.check(fn(h.data_ptr(), w.data_ptr(), lse.data_ptr(),
                             g.data_ptr(), dh.data_ptr(), scratch.data_ptr(),
                             n, v, d, splits,
                             *_native.device_and_stream(dev)), name)
        for _ in range(2):
            run()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(10):
            run()
        t1.record()
        t1.synchronize()
        err = ((dh - want).abs().max() / want.abs().max()).item()
        print(f"  {name:10s} {t0.elapsed_time(t1) / 10:.4f} ms  max|dh - "
              f"plain| / max|plain| {err:.3e}  ptxas: {usage(log)}",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
