"""The port's kernel modules against the JAX reference kernels.

On the CPU the port's wrappers take their plain PyTorch versions; those
are held here against the Pallas kernels run in interpret mode, on the
cases of tests/test_kernels.py. The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py holds them against these plain
versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels.flash_attention import flash_attention as jax_flash
from bigdl_tpu.kernels.quantized_matmul import (
    int8_matmul as jax_int8_matmul,
    quantized_linear_forward as jax_qlinear)
from bigdl_tpu_torch.kernels.flash_attention import (
    NEG_INF, flash_attention, flash_attention_plain)
from bigdl_tpu_torch.kernels.quantized_matmul import (
    int8_matmul, quantized_linear_forward)
from bigdl_tpu_torch.nn.attention import causal_mask
from torch_parity import t

# fp32 attention: the Pallas online softmax and the dense plain version
# sum in different orders; 2e-5 is the reference's own kernel-vs-dense
# tolerance (tests/test_kernels.py)
FLASH_TOL = 2e-5


def _qkv(b=2, h=2, tq=64, tk=64, d=32, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, h, tq, d).astype(np.float32),
            r.randn(b, h, tk, d).astype(np.float32),
            r.randn(b, h, tk, d).astype(np.float32))


# ------------------------------------------------------ flash attention
@pytest.mark.parametrize("tq,tk,causal", [
    (64, 64, False), (64, 64, True),          # dense / causal
    (32, 64, True),                           # Tq < Tk, bottom-right
    (32, 128, False),                         # cross-attention lengths
    (60, 60, False), (60, 60, True), (37, 91, False), (50, 77, True),
    (64, 60, False),                          # ragged
])
def test_flash_plain_matches_pallas(tq, tk, causal):
    q, k, v = _qkv(tq=tq, tk=tk)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     32, 32, causal, None, True)
    got = flash_attention(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_plain_rows_without_keys_are_zero():
    """Causal with Tq > Tk: the first Tq - Tk query rows see no key and
    yield 0 (acc / max(l, 1e-30)); the rest is ordinary attention."""
    q, k, v = _qkv(tq=40, tk=24)
    out = flash_attention_plain(t(q), t(k), t(v), causal=True).numpy()
    np.testing.assert_array_equal(out[:, :, :16], 0.0)
    want = flash_attention_plain(t(q[:, :, 16:]), t(k), t(v), causal=True)
    np.testing.assert_allclose(out[:, :, 16:], want.numpy(), atol=1e-6)


def test_flash_cpu_takes_plain_path_without_launch():
    q, k, v = _qkv(tq=16, tk=16, d=8)
    flash_attention.launches.reset()
    out = flash_attention(t(q), t(k), t(v), causal=True)
    assert out.shape == (2, 2, 16, 8)
    assert flash_attention.launches.value == 0


def test_flash_rejects_other_devices_and_shapes():
    q = torch.empty((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(torch.zeros(4, 8), torch.zeros(4, 8),
                        torch.zeros(4, 8))


# ------------------------------------------------------------ int8 GEMM
def _int8_case(m, k, n, seed):
    r = np.random.RandomState(seed)
    xq = r.randint(-127, 128, (m, k)).astype(np.int8)
    wq = r.randint(-127, 128, (k, n)).astype(np.int8)
    sx = ((r.rand(m, 1) + 0.5) / 100).astype(np.float32)
    sw = ((r.rand(1, n) + 0.5) / 100).astype(np.float32)
    return xq, wq, sx, sw


@pytest.mark.parametrize("m,k,n,blocks", [
    (70, 96, 50, dict(block_m=32, block_n=32, block_k=32)),   # unaligned
    (6, 40, 24, {}),                                          # tile-padded
])
def test_int8_plain_matches_pallas(m, k, n, blocks):
    xq, wq, sx, sw = _int8_case(m, k, n, seed=m)
    # the int32 sum, seen through unit scales (|sum| < 2^24, so the fp32
    # conversion is exact): bitwise equal
    ones_x, ones_w = np.ones_like(sx), np.ones_like(sw)
    want_acc = jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(ones_x), jnp.asarray(ones_w),
                               interpret=True, **blocks)
    got_acc = int8_matmul(t(xq), t(wq), t(ones_x), t(ones_w))
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    # the dequantized fp32 output: the same two roundings in the same
    # order, allowed 1 ulp for XLA's freedom to fuse
    want = jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx),
                           jnp.asarray(sw), interpret=True, **blocks)
    got = int8_matmul(t(xq), t(wq), t(sx), t(sw))
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def test_int8_plain_scalar_scales_match_pallas():
    xq, wq, _, _ = _int8_case(4, 16, 8, seed=5)
    want = jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq), 0.02, 0.01,
                           interpret=True)
    got = int8_matmul(t(xq), t(wq), 0.02, 0.01)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


@pytest.mark.parametrize("shape,bias,input_scale", [
    ((6, 40), True, None),        # 2-D, dynamic per-row scale
    ((2, 5, 16), False, None),    # 3-D: leading dims flatten
    ((3, 4, 24), True, 0.03),     # static calibrated scale
])
def test_quantized_linear_forward_matches_pallas(shape, bias, input_scale):
    r = np.random.RandomState(len(shape) + shape[-1])
    k, n = shape[-1], 12
    x = r.randn(*shape).astype(np.float32)
    wq = r.randint(-127, 128, (k, n)).astype(np.int8)
    sw = ((r.rand(1, n) + 0.5) / 50).astype(np.float32)
    b = r.randn(n).astype(np.float32) if bias else None
    want = jax_qlinear(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
                       bias=None if b is None else jnp.asarray(b),
                       input_scale=input_scale, interpret=True)
    got = quantized_linear_forward(t(x), t(wq), t(sw),
                                   bias=None if b is None else t(b),
                                   input_scale=input_scale)
    assert got.shape == shape[:-1] + (n,)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def test_int8_cpu_takes_plain_path_without_launch():
    xq, wq, sx, sw = _int8_case(5, 8, 3, seed=1)
    int8_matmul.launches.reset()
    int8_matmul(t(xq), t(wq), t(sx), t(sw))
    assert int8_matmul.launches.value == 0
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(t(xq).float(), t(wq), t(sx), t(sw))
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        int8_matmul(t(xq), t(wq).T.contiguous(), t(sx), t(sw))


# ----------------------------------------------- cut cross-entropy's dh
# The CUDA dh kernel (K3b) runs both of its fp32 products on the tensor
# cores in 3xTF32: each operand a = hi + lo, both TF32, and a b ~ hi hi'
# + hi lo' + lo hi'. The kernel splits as CUTLASS's FastF32 does (hi =
# a rounded toward zero, lo = a - hi rounded to nearest); the split with
# hi rounded to nearest is the textbook one. This emulates both splits on
# the CPU to pin why the split meets the tolerance the card tests hold
# the kernel to, and why a single TF32 product does not. The sums here
# are float64: the tensor cores' truncating fp32 accumulation adds its
# own error on the card (chip_smoke.py reads ~2.4e-06 of dh's largest
# value there). It does not stand in for the card test.
CCE_TOL = 1e-5     # tests/test_torch_cuda.py and chip_smoke.py
TF32_MASK = ~0x1FFF   # sign, exponent and 10 mantissa bits of an fp32


def _tf32(x):
    """x rounded to TF32 on its fp32 bit pattern: 10 mantissa bits kept,
    to nearest (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & TF32_MASK).view(torch.float32)


def _tf32_toward_zero(x):
    """x cut to TF32 toward zero: its 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def _mm_3xtf32(a, b, hi=_tf32):
    """a @ b with both operands split into TF32 parts, hi by `hi` and lo
    = a - hi rounded to nearest; the three products summed in float64,
    rounded to fp32."""
    ah, bh = hi(a), hi(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return sum(p.double() @ q.double() for p, q in
               ((ah, bh), (ah, bl), (al, bh))).float()


def _mm_tf32(a, b):
    return (_tf32(a).double() @ _tf32(b).double()).float()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 2.0 ** -12,
                      -(1 + 3 * 2.0 ** -11), 3.0e-30])
    got = _tf32(x)
    assert got[:4].tolist() == [1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1.0]
    assert got[4].item() == -(1 + 2 * 2.0 ** -10)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    cut = _tf32_toward_zero(x)
    assert cut[:4].tolist() == [1.0, 1 + 2.0 ** -10, 1.0, 1.0]
    assert cut[4].item() == -(1 + 2.0 ** -10)


@pytest.mark.parametrize("hi", [_tf32, _tf32_toward_zero],
                         ids=["hi_nearest", "hi_toward_zero"])
def test_cce_dh_3xtf32_meets_the_tolerance_and_tf32_misses_it(hi):
    from bigdl_tpu_torch.kernels.cut_cross_entropy import (cce_dh_plain,
                                                           cce_lse_plain)
    n, v, d = 256, 4096, 768
    r = np.random.RandomState(0)
    h = torch.from_numpy(r.randn(n, d).astype(np.float32))
    w = torch.from_numpy((r.randn(v, d) / np.sqrt(d)).astype(np.float32))
    g = torch.from_numpy(r.randn(n).astype(np.float32))
    lse = cce_lse_plain(h, w)
    want = cce_dh_plain(h, w, lse, g)

    def dh(mm):
        p = torch.exp(mm(h, w.T) - lse[:, None]) * g[:, None]
        return mm(p, w)

    def rel(x):
        return ((x - want).abs().max() / want.abs().max()).item()
    err3 = rel(dh(lambda a, b: _mm_3xtf32(a, b, hi)))
    err1 = rel(dh(_mm_tf32))
    print(f"dh of max: 3xTF32 {err3:.3e}, single TF32 {err1:.3e}")
    assert err3 <= CCE_TOL / 10, err3
    assert err1 > CCE_TOL * 10, err1


@pytest.mark.parametrize("hi", [_tf32, _tf32_toward_zero],
                         ids=["hi_nearest", "hi_toward_zero"])
def test_cce_dw_3xtf32_meets_the_tolerance_and_tf32_misses_it(hi):
    """The same for dw (K3c, the dh body with the roles of h and w
    swapped): P^T h with P's lse and g taken by h row. Held against the
    plain version evaluated in float64: the fp32 plain dw on the CPU is
    itself ~1.4e-06 of its largest value away from it (P^T h sums rows
    of mixed sign in fp32), more than the split's own error."""
    from bigdl_tpu_torch.kernels.cut_cross_entropy import (cce_dw_plain,
                                                           cce_lse_plain)
    n, v, d = 256, 4096, 768
    r = np.random.RandomState(1)
    h = torch.from_numpy(r.randn(n, d).astype(np.float32))
    w = torch.from_numpy((r.randn(v, d) / np.sqrt(d)).astype(np.float32))
    g = torch.from_numpy(r.randn(n).astype(np.float32))
    lse = cce_lse_plain(h, w)
    want = cce_dw_plain(h.double(), w.double(), lse.double(), g.double())

    def dw(mm):
        p = torch.exp(mm(w, h.T) - lse[None, :]) * g[None, :]   # (V, N)
        return mm(p, h)

    def rel(x):
        return ((x.double() - want).abs().max() / want.abs().max()).item()
    err3 = rel(dw(lambda a, b: _mm_3xtf32(a, b, hi)))
    err1 = rel(dw(_mm_tf32))
    print(f"dw of max: 3xTF32 {err3:.3e}, single TF32 {err1:.3e}, the fp32 "
          f"plain dw {rel(cce_dw_plain(h, w, lse, g)):.3e}")
    assert err3 <= CCE_TOL / 10, err3
    assert err1 > CCE_TOL * 10, err1


# ----------------------------------------------- cut cross-entropy's lse
# LSE_TOL (tests/test_torch_cuda.py and chip_smoke.py hold K3a to it):
# max|lse - plain| <= LSE_TOL * max|plain|. The fp32 plain lse is ~8.5e-08
# of its largest value from float64 (fp32 sums of S and of the softmax);
# one TF32 product (10-bit mantissa, ~5e-4 relative on each logit) moves
# lse by ~4.7e-06, averaged under the softmax. 1e-6 sits ~10x above the
# first and ~5x below the second, so CCE_TOL (1e-5) would pass the
# shortcut and LSE_TOL does not.
LSE_TOL = 1e-6
LSE_BK, LSE_BN = 32, 128   # K3a's promotion depth in D and vocab tile


def _lse_like_k3a(h, w, mm, splits=3):
    """K3a's arithmetic: S summed from zero per 32 columns of D (in
    `mm`, rounded to fp32) and added in fp32; 128-column vocab tiles
    folded into a running (max, sum) in fp32, columns cut into `splits`
    chunks as the kernel's grid cuts them, merged in index order."""
    s = None
    for k0 in range(0, h.shape[1], LSE_BK):
        part = mm(h[:, k0:k0 + LSE_BK], w[:, k0:k0 + LSE_BK].T)
        s = part if s is None else s + part
    tiles = -(-w.shape[0] // LSE_BN)
    neg = torch.full((h.shape[0],), -1e30)
    m_all, s_all = neg.clone(), torch.zeros(h.shape[0])
    for c in range(splits):
        m, acc = neg.clone(), torch.zeros(h.shape[0])
        for tile in range(c * tiles // splits, (c + 1) * tiles // splits):
            st = s[:, tile * LSE_BN:(tile + 1) * LSE_BN]
            mn = torch.maximum(m, st.amax(1))
            acc = acc * torch.exp(m - mn) + torch.exp(st - mn[:, None]).sum(1)
            m = mn
        mn = torch.maximum(m_all, m)
        s_all = s_all * torch.exp(m_all - mn) + acc * torch.exp(m - mn)
        m_all = mn
    return m_all + torch.log(s_all)


@pytest.mark.parametrize("hi", [_tf32, _tf32_toward_zero],
                         ids=["hi_nearest", "hi_toward_zero"])
def test_cce_lse_3xtf32_meets_the_tolerance_and_tf32_misses_it(hi):
    """K3a's design emulated on the CPU (products in float64 after the
    split; the tensor cores' truncating accumulation is not modelled, the
    card tests hold the kernel itself to LSE_TOL) against float64 and
    against the reference's cut_cross_entropy in interpret mode, whose
    lse is its loss plus the label logit."""
    from bigdl_tpu.kernels.cut_cross_entropy import cut_cross_entropy as jcce
    from bigdl_tpu_torch.kernels.cut_cross_entropy import cce_lse_plain
    n, v, d = 256, 4096, 768
    r = np.random.RandomState(2)
    h = torch.from_numpy(r.randn(n, d).astype(np.float32))
    w = torch.from_numpy((r.randn(v, d) / np.sqrt(d)).astype(np.float32))
    labels = r.randint(0, v, n).astype(np.int32)
    exact = cce_lse_plain(h.double(), w.double())
    loss = np.asarray(jcce(jnp.asarray(h.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(labels), interpret=True))
    ref = torch.from_numpy(loss.copy()).double() + (
        h.double() * w.double()[labels]).sum(1)

    def rel(x, want):
        return ((x.double() - want).abs().max() / want.abs().max()).item()
    got = _lse_like_k3a(h, w, lambda a, b: _mm_3xtf32(a, b, hi))
    err3, err_ref = rel(got, exact), rel(got, ref)
    err1 = rel(_lse_like_k3a(h, w, _mm_tf32), exact)
    err_plain = rel(cce_lse_plain(h, w), exact)
    print(f"lse of max: 3xTF32 {err3:.3e} (against the reference "
          f"{err_ref:.3e}), single TF32 {err1:.3e}, the fp32 plain lse "
          f"{err_plain:.3e}")
    assert err3 <= LSE_TOL / 4, err3
    assert err_ref <= LSE_TOL, err_ref
    assert err_plain <= LSE_TOL / 4, err_plain
    assert err1 > 2 * LSE_TOL, err1


# --------------------------------------------- flash attention's products
# The CUDA flash-attention kernel (K2) runs S = Q K^T and O = P V on the
# tensor cores in 3xTF32 with the split above. This emulates its
# arithmetic on the CPU (P = exp(S - row max) unnormalised, O = P V / l,
# the products in float64 after the split) against the fp32 plain
# version, with the error measured as the tolerance FLASH_TOL reads it,
# max |got - want| / (1 + |want|). The tensor cores' truncating fp32
# accumulation is not modelled (the kernel sums each 64 columns of d and
# each key tile from zero to bound it); the card tests hold the kernel
# itself to FLASH_TOL.
def _attention(q, k, v, causal, mm):
    s = mm(q, k.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    if causal:
        s = torch.where(causal_mask(q.shape[2], k.shape[2]), s,
                        torch.full((), NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(e, v) / e.sum(-1, keepdim=True)


@pytest.mark.parametrize("hi", [_tf32, _tf32_toward_zero],
                         ids=["hi_nearest", "hi_toward_zero"])
@pytest.mark.parametrize("tq,tk,d,causal", [(128, 128, 64, True),
                                            (50, 77, 256, False)])
def test_flash_3xtf32_meets_the_tolerance_and_tf32_misses_it(hi, tq, tk, d,
                                                             causal):
    q, k, v = (t(a) for a in _qkv(b=2, h=2, tq=tq, tk=tk, d=d, seed=d))
    want = flash_attention_plain(q, k, v, causal=causal)

    def err(got):
        return ((got - want).abs() / (1 + want.abs())).max().item()
    err3 = err(_attention(q, k, v, causal, lambda a, b: _mm_3xtf32(a, b, hi)))
    err1 = err(_attention(q, k, v, causal, _mm_tf32))
    print(f"attention Tq={tq} Tk={tk} d={d}: max|err|/(1+|plain|) 3xTF32 "
          f"{err3:.3e}, single TF32 {err1:.3e}")
    assert err3 <= FLASH_TOL / 10, err3
    assert err1 > FLASH_TOL, err1
