"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.kernels import fused_update as fu
from bigdl_tpu_torch.kernels.cut_cross_entropy import (
    cce_dh, cce_dh_plain, cce_dw, cce_dw_plain, cce_lse, cce_lse_plain,
    cut_cross_entropy, cut_cross_entropy_plain, dh_kernel_usage,
    dw_kernel_usage, lse_kernel_usage)
from bigdl_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain, kernel_usage as flash_usage)
from bigdl_tpu_torch.kernels.quantized_matmul import (
    int8_matmul, int8_matmul_plain, kernel_body, kernel_usage)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.quantized import QuantizedLinear
from bigdl_tpu_torch.optim import method as pm

# fp32 attention: online vs one-pass softmax sum in different orders;
# the reference's own flash-vs-dense tolerance (tests/test_kernels.py)
FLASH_TOL = 2e-5

# gradients through the recompute backward against autograd through the
# dense plain version: the same fp32 ops on the same inputs (expected bit
# for bit); the margin covers a GEMM algorithm chosen otherwise
GRAD_TOL = 1e-4

# cut cross-entropy, kernel against the dense plain version, both fp32:
# max|kernel - plain| <= CCE_TOL * max|plain|. The sums run in other
# orders (~1e-6 of the largest value); a TF32 product (10-bit mantissa,
# ~5e-4 relative per logit) moves dh and dw by ~1e-4 of their largest
# value and fails it
CCE_TOL = 1e-5

# K3a's lse against the plain lse, both fp32: max|kernel - plain| <=
# LSE_TOL * max|plain|. The fp32 plain lse is ~8.5e-08 of its largest
# value from float64; a TF32 product moves lse by ~4.7e-06 (averaged
# under the softmax), which CCE_TOL would pass and LSE_TOL fails
# (tests/test_torch_kernels.py derives it, chip_smoke.py shows it)
LSE_TOL = 1e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(cuda, *shape, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=cuda)


@pytest.mark.parametrize("b,h,tq,tk,causal,d", [
    (8, 12, 512, 512, True, 64),       # the serving shape
    (2, 2, 37, 91, False, 64), (2, 2, 50, 77, True, 32),
    (1, 3, 64, 60, False, 128), (2, 2, 40, 24, True, 64),   # rows w/o keys
    (1, 1, 1, 200, True, 16), (1, 2, 130, 130, False, 100),
    (8, 12, 1024, 1024, True, 64),     # the training shape
    (2, 3, 77, 133, True, 8), (2, 2, 70, 90, False, 97),    # d % 4 != 0
    (1, 2, 64, 130, True, 136),        # d > 128: slices and column chunks
    (2, 2, 130, 77, False, 256), (1, 2, 50, 77, True, 512),
    (2, 2, 133, 77, True, 256)])       # rows without keys at d = 256
def test_flash_kernel_matches_plain(cuda, b, h, tq, tk, causal, d):
    q = _rand(cuda, b, h, tq, d, seed=1)
    k = _rand(cuda, b, h, tk, d, seed=2)
    v = _rand(cuda, b, h, tk, d, seed=3)
    n0 = flash_attention.launches.value
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches.value == n0 + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    # any head dim runs: d = 136 takes the sliced body
    q = _rand(cuda, 1, 1, 8, 136)
    torch.testing.assert_close(flash_attention(q, q, q),
                               flash_attention_plain(q, q, q),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    q = _rand(cuda, 1, 8, 2, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="fp32"):
        flash_attention(q.contiguous().half(), q.contiguous().half(),
                        q.contiguous().half())


@pytest.mark.parametrize("d", [8, 64, 100, 128, 256, 512])
def test_flash_kernel_usage(cuda, d):
    use = flash_usage(d)
    assert use["local_bytes"] == 0 and 0 < use["registers"] <= 255
    assert use["cols"] == (64 if d <= 64 else 128)
    assert use["shared_bytes"] <= 227 * 1024


@pytest.mark.parametrize("m,k,n", [(4096, 768, 3072), (4096, 3072, 768),
                                   (70, 96, 50), (33, 42, 19), (1, 8, 1)])
def test_int8_kernel_bitwise_equals_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    sx = torch.rand(m, 1, generator=g, device=cuda) / 100 + 1e-3
    sw = torch.rand(1, n, generator=g, device=cuda) / 100 + 1e-3
    n0 = int8_matmul.launches.value
    got = int8_matmul(xq, wq, sx, sw, wq_t=wq.t().contiguous())
    torch.cuda.synchronize()
    assert int8_matmul.launches.value == n0 + 1
    assert torch.equal(got, int8_matmul_plain(xq, wq, sx, sw))
    # scalar scales and the per-call transpose give the same numbers
    assert torch.equal(int8_matmul(xq, wq, 0.02, 0.01),
                       int8_matmul_plain(xq, wq, 0.02, 0.01))


def _int8_operands(cuda, m, k, n, offset=0, seed=0):
    """(xq, wq, wq_t, sx, sw); with `offset`, xq is a contiguous view
    `offset` bytes into its storage (its data pointer not 16-byte
    aligned)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xq = torch.randint(-127, 128, (m * k + offset,), generator=g,
                       device=cuda, dtype=torch.int8)[offset:].view(m, k)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    sx = torch.rand(m, 1, generator=g, device=cuda) / 100 + 1e-3
    sw = torch.rand(1, n, generator=g, device=cuda) / 100 + 1e-3
    return xq, wq, wq.t().contiguous(), sx, sw


@pytest.mark.parametrize("m,k,n,offset,body", [
    (4096, 768, 3072, 0, "cp.async"),      # serving: gate and up
    (4096, 3072, 768, 0, "cp.async"),      # serving: down
    (4095, 768, 3071, 0, "cp.async"),      # M, N not tile multiples
    (257, 40, 129, 0, "byte loads"),       # K % 16 != 0
    (64, 776, 96, 0, "byte loads"),        # K % 16 == 8
    (300, 768, 200, 1, "byte loads"),      # xq 1 byte off alignment
    (300, 768, 200, 768, "cp.async"),      # one row in: still aligned
])
def test_int8_tensor_core_bodies_bitwise_equal_plain(cuda, m, k, n, offset,
                                                     body):
    """K4's two bodies (cp.async ring; byte loads) are picked by shape and
    alignment, never by failure, and both are bit for bit the plain
    version; the serving shapes take the cp.async body."""
    xq, wq, wt, sx, sw = _int8_operands(cuda, m, k, n, offset, seed=m + n)
    assert body in kernel_body(xq, wt)
    n0 = int8_matmul.launches.value
    got = int8_matmul(xq, wq, sx, sw, wq_t=wt)
    torch.cuda.synchronize()
    assert int8_matmul.launches.value == n0 + 1
    assert torch.equal(got, int8_matmul_plain(xq, wq, sx, sw))


def test_int8_kernel_row_slice_operand(cuda):
    """A contiguous row slice of a K % 16 != 0 matrix: its pointer is
    K bytes into the storage."""
    xq, wq, wt, sx, sw = _int8_operands(cuda, 65, 42, 33, seed=3)
    xs, ss = xq[1:], sx[1:]
    assert xs.is_contiguous() and xs.data_ptr() % 16
    got = int8_matmul(xs, wq, ss, sw, wq_t=wt)
    assert torch.equal(got, int8_matmul_plain(xs, wq, ss, sw))


def test_int8_kernel_usage(cuda):
    xq, _, wt, _, _ = _int8_operands(cuda, 128, 768, 128)
    use = kernel_usage(xq, wt)
    assert use["local_bytes"] == 0 and 0 < use["registers"] <= 128
    assert use["shared_bytes"] <= 227 * 1024


def test_quantized_linear_runs_the_kernel(cuda):
    lin = Linear(96, 40).init(torch.Generator().manual_seed(0), device=cuda)
    q = QuantizedLinear.from_float(lin)
    x = _rand(cuda, 3, 7, 96)
    n0 = int8_matmul.launches.value
    with torch.no_grad():
        got = q(x)
        cpu = QuantizedLinear.from_float(lin.to("cpu"))(x.cpu())
    assert int8_matmul.launches.value == n0 + 1
    assert got.shape == (3, 7, 40)
    # the same quantization on both devices; the int32 sums are exact,
    # the division x / sx and the bias add may differ by an ulp
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,tq,tk,causal", [
    (2, 3, 256, 256, True), (2, 2, 37, 91, False), (1, 2, 50, 77, True)])
def test_flash_function_gradients_match_plain_autograd(cuda, b, h, tq, tk,
                                                       causal):
    q = _rand(cuda, b, h, tq, 64, seed=4).requires_grad_()
    k = _rand(cuda, b, h, tk, 64, seed=5).requires_grad_()
    v = _rand(cuda, b, h, tk, 64, seed=6).requires_grad_()
    g = _rand(cuda, b, h, tq, 64, seed=7)
    n0 = flash_attention.launches.value
    got = torch.autograd.grad(flash_attention(q, k, v, causal=causal), (q, k, v),
                              g)
    assert flash_attention.launches.value == n0 + 1
    want = torch.autograd.grad(flash_attention_plain(q, k, v, causal=causal),
                               (q, k, v), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=GRAD_TOL, rtol=GRAD_TOL)


FUSED_METHODS = [pm.Adam(1e-3), pm.Adam(1e-3, weight_decay=0.01),
                 pm.AdamW(1e-3, weight_decay=0.05), pm.SGD(0.1),
                 pm.SGD(0.1, momentum=0.5, dampening=0.1, weight_decay=0.02),
                 pm.SGD(0.1, momentum=0.9, nesterov=True)]


@pytest.mark.parametrize("method", FUSED_METHODS, ids=[
    "adam", "adam-wd", "adamw", "sgd", "sgd-mom-damp-wd", "sgd-nesterov"])
def test_fused_update_kernel_bitwise_equals_plain(cuda, method):
    """K1, one launch over leaves of odd sizes (and one 2-D leaf, one
    empty), from a non-zero state, bit for bit against the plain version
    and against method.update."""
    kind, hyper = fu.describe(method)
    names = fu.slot_names(kind, hyper)
    sizes = [(1,), (7,), (4097,), (33, 7), (0,), (70001,), (4096,)]
    params = {f"p{i}": _rand(cuda, *s, seed=i) for i, s in enumerate(sizes)}
    grads = {k: _rand(cuda, *p.shape, seed=50 + i)
             for i, (k, p) in enumerate(params.items())}
    slots = {nm: {k: _rand(cuda, *p.shape, seed=90 + i).abs()
                  for i, (k, p) in enumerate(params.items())}
             for nm in names}
    want_p, want_s = method.update(params, grads, slots, 5e-3, 7)
    bc1, bc2 = fu._bias_corrections(kind, hyper, 7)
    keys = list(params)
    plain_p, plain_s = fu.fused_update_plain(
        kind, hyper, [params[k] for k in keys], [grads[k] for k in keys],
        [[slots[nm][k] for k in keys] for nm in names], 5e-3, bc1, bc2)
    got_p = {k: p.clone() for k, p in params.items()}
    got_s = {nm: {k: s.clone() for k, s in sl.items()}
             for nm, sl in slots.items()}
    n0 = fu.fused_update.launches.value
    fu.make_update_fn(method)(got_p, grads, got_s, 5e-3, 7)
    torch.cuda.synchronize()
    assert fu.fused_update.launches.value == n0 + 1
    for j, k in enumerate(keys):
        assert torch.equal(got_p[k], plain_p[j]), k
        assert torch.equal(got_p[k], want_p[k]), k
        for i, nm in enumerate(names):
            assert torch.equal(got_s[nm][k], plain_s[i][j]), (nm, k)
            assert torch.equal(got_s[nm][k], want_s[nm][k]), (nm, k)


def test_fused_update_kernel_refuses_what_it_cannot_take(cuda):
    kind, hyper = fu.describe(pm.SGD(0.1))
    p = _rand(cuda, 8)
    with pytest.raises(TypeError, match="fp32"):
        fu.fused_update(kind, hyper, [p.half()], [p.half()], [], 0.1, 1., 1.)
    with pytest.raises(ValueError, match="contiguous"):
        q = _rand(cuda, 4, 4).t()
        fu.fused_update(kind, hyper, [q], [q], [], 0.1, 1., 1.)
    with pytest.raises(ValueError, match="shapes"):
        fu.fused_update(kind, hyper, [p], [p[:4]], [], 0.1, 1., 1.)


def _cce_inputs(cuda, n, v, d, seed=0):
    """Activations like a LayerNorm's output and a head drawn like the
    pipelined LM's embedding (normal * d ** -0.5): logits ~ N(0, 1)."""
    h = _rand(cuda, n, d, seed=seed)
    w = _rand(cuda, v, d, seed=seed + 1) * d ** -0.5
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    labels = torch.randint(0, v, (n,), generator=gen, device=cuda)
    return h, w, labels


def _assert_cce_close(got, want, tol=CCE_TOL):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def _dw_float64(h, w, lse, g):
    """The plain dw on the same inputs evaluated in float64. The fp32
    plain dw is itself 3-4.5e-6 of its largest value from it at the
    path's shape, most of CCE_TOL, so K3c is held against this one."""
    return cce_dw_plain(h.double(), w.double(), lse.double(), g.double())


CCE_SHAPES = [(2048, 50257, 768),     # the pipelined LM's microbatch
              (333, 1029, 96), (77, 515, 32),
              (130, 777, 100),         # D % 4 != 0: 4-byte copies
              (64, 300, 1000),         # D > 768: 16 rows a block
              # past 1024 columns: K3b and K3c cut D over a grid axis
              (256, 1029, 1025), (130, 777, 1280), (200, 515, 1600),
              (64, 777, 2048), (77, 1029, 2049),
              # GPT-2 large's width at the path's N and V: the wide body's
              # vocab walk in one chunk of 1571 tiles
              (2048, 50257, 1280)]


@pytest.mark.parametrize("n,v,d", CCE_SHAPES)
def test_cce_kernels_match_plain(cuda, n, v, d):
    h, w, _ = _cce_inputs(cuda, n, v, d)
    g = _rand(cuda, n, seed=7)
    counts = [k.launches.value for k in (cce_lse, cce_dh, cce_dw)]
    lse = cce_lse(h, w)
    want_lse = cce_lse_plain(h, w)
    dh = cce_dh(h, w, want_lse, g)
    dw = cce_dw(h, w, want_lse, g)
    torch.cuda.synchronize()
    assert [k.launches.value for k in (cce_lse, cce_dh, cce_dw)] == [
        c + 1 for c in counts]
    _assert_cce_close(lse, want_lse, LSE_TOL)
    _assert_cce_close(dh, cce_dh_plain(h, w, want_lse, g))
    _assert_cce_close(dw, _dw_float64(h, w, want_lse, g))


@pytest.mark.parametrize("n,v,d", CCE_SHAPES + [(2047, 50257, 768),
                                   (2047, 777, 96), (130, 1029, 1600)])
def test_cce_lse_tensor_core_matches_plain(cuda, n, v, d):
    """K3a (3xTF32 on the tensor cores, D streamed in 64-deep slices)
    within LSE_TOL of the fp32 plain version, at every shape, at N and V
    that are not multiples of its 128-row tiles and at any D."""
    h, w, _ = _cce_inputs(cuda, n, v, d, seed=51)
    n0 = cce_lse.launches.value
    got = cce_lse(h, w)
    torch.cuda.synchronize()
    assert cce_lse.launches.value == n0 + 1
    _assert_cce_close(got, cce_lse_plain(h, w), LSE_TOL)


@pytest.mark.parametrize("n,v,d", [(2048, 50257, 768), (333, 1029, 96),
                                   (130, 777, 1280)])
def test_cce_lse_is_deterministic_and_ignores_the_tf32_switch(cuda, n, v, d):
    """The vocab chunks merge in index order and the warps sharing rows
    in warp order, so two launches give the same bits; the TF32 switch is
    never read."""
    h, w, _ = _cce_inputs(cuda, n, v, d, seed=61)
    first = cce_lse(h, w)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        flag_on = cce_lse(h, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    again = cce_lse(h, w)
    assert torch.equal(first, again)
    assert torch.equal(first, flag_on)


@pytest.mark.parametrize("d", [96, 768, 2049])
def test_cce_lse_kernel_usage(cuda, d):
    use = lse_kernel_usage(d)
    assert use["rows"] == 128 and use["local_bytes"] == 0
    assert use["d_chunks"] == 1
    assert 0 < use["registers"] <= 255
    assert use["shared_bytes"] <= 227 * 1024


@pytest.mark.parametrize("n,v,d", CCE_SHAPES + [(2047, 50257, 768)])
def test_cce_dh_tensor_core_matches_plain(cuda, n, v, d):
    """K3b (3xTF32 on the tensor cores) within CCE_TOL of the fp32 plain
    version, at every shape and at an N that is not a multiple of its
    32-row tile."""
    h, w, _ = _cce_inputs(cuda, n, v, d, seed=11)
    g = _rand(cuda, n, seed=12)
    lse = cce_lse_plain(h, w)
    n0 = cce_dh.launches.value
    got = cce_dh(h, w, lse, g)
    torch.cuda.synchronize()
    assert cce_dh.launches.value == n0 + 1
    _assert_cce_close(got, cce_dh_plain(h, w, lse, g))


@pytest.mark.parametrize("n,v,d", [(2048, 50257, 768), (333, 1029, 96),
                                   (130, 777, 1280)])
def test_cce_dh_is_deterministic_and_ignores_the_tf32_switch(cuda, n, v, d):
    """The chunks merge in index order, so two launches give the same
    bits; the kernel picks 3xTF32 itself and never reads PyTorch's TF32
    switch."""
    h, w, _ = _cce_inputs(cuda, n, v, d, seed=21)
    g = _rand(cuda, n, seed=22)
    lse = cce_lse_plain(h, w)
    first = cce_dh(h, w, lse, g)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        flag_on = cce_dh(h, w, lse, g)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    again = cce_dh(h, w, lse, g)
    assert torch.equal(first, again)
    assert torch.equal(first, flag_on)


@pytest.mark.parametrize("d,rows", [(96, 32), (512, 32), (768, 32),
                                    (1000, 16), (1280, 16), (2049, 16)])
def test_cce_dh_kernel_usage(cuda, d, rows):
    use = dh_kernel_usage(d)
    assert use["rows"] == rows and use["local_bytes"] == 0
    # one block along D up to 1024 columns, one a 1024-column chunk past
    assert use["d_chunks"] == max(1, -(-d // 1024))
    assert use["shared_bytes"] <= 227 * 1024


@pytest.mark.parametrize("n,v,d", CCE_SHAPES + [(2047, 50257, 768)])
def test_cce_dw_tensor_core_matches_plain(cuda, n, v, d):
    """K3c (K3b's 3xTF32 body with the roles of h and w swapped) within
    CCE_TOL of the plain version in float64, at every shape and at an N
    that is not a multiple of its 32-row walker tile."""
    h, w, _ = _cce_inputs(cuda, n, v, d, seed=31)
    g = _rand(cuda, n, seed=32)
    lse = cce_lse_plain(h, w)
    n0 = cce_dw.launches.value
    got = cce_dw(h, w, lse, g)
    torch.cuda.synchronize()
    assert cce_dw.launches.value == n0 + 1
    _assert_cce_close(got, _dw_float64(h, w, lse, g))


@pytest.mark.parametrize("n,v,d", [(2048, 50257, 768), (333, 1029, 96),
                                   (130, 777, 1280)])
def test_cce_dw_is_deterministic_and_ignores_the_tf32_switch(cuda, n, v, d):
    """One block per vocab tile walks the h rows in order, so two
    launches give the same bits; the TF32 switch is never read."""
    h, w, _ = _cce_inputs(cuda, n, v, d, seed=41)
    g = _rand(cuda, n, seed=42)
    lse = cce_lse_plain(h, w)
    first = cce_dw(h, w, lse, g)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        flag_on = cce_dw(h, w, lse, g)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    again = cce_dw(h, w, lse, g)
    assert torch.equal(first, again)
    assert torch.equal(first, flag_on)


@pytest.mark.parametrize("d,rows", [(96, 32), (512, 32), (768, 32),
                                    (1000, 16), (1280, 16), (2049, 16)])
def test_cce_dw_kernel_usage(cuda, d, rows):
    use = dw_kernel_usage(d)
    assert use["rows"] == rows and use["local_bytes"] == 0
    assert use["d_chunks"] == max(1, -(-d // 1024))
    assert use["shared_bytes"] <= 227 * 1024


@pytest.mark.parametrize("n,v,d", [(2048, 50257, 768), (256, 1000, 96),
                                   (256, 1000, 1280)])
def test_cut_cross_entropy_gradients_match_plain_autograd(cuda, n, v, d):
    h, w, labels = _cce_inputs(cuda, n, v, d, seed=3)
    h.requires_grad_()
    w.requires_grad_()
    got = cut_cross_entropy(h, w, labels)
    want = cut_cross_entropy_plain(h, w, labels)
    _assert_cce_close(got, want)
    # the pipelined LM's cotangent: a mean over the rows
    gh, gw = torch.autograd.grad(got.mean(), (h, w))
    wh, ww = torch.autograd.grad(want.mean(), (h, w))
    _assert_cce_close(gh, wh)
    _assert_cce_close(gw, ww)


def test_cce_kernels_refuse_what_they_cannot_take(cuda):
    h, w, _ = _cce_inputs(cuda, 8, 16, 32)
    with pytest.raises(TypeError, match="fp32"):
        cce_lse(h.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        cce_lse(h, w.t().contiguous().t())
    with pytest.raises(ValueError, match=r"\(8,\)"):
        cce_dh(h, w, _rand(cuda, 8), _rand(cuda, 4))
