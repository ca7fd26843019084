"""The port's training path against the JAX reference, on the CPU: the
fused update's plain version and the optimizer methods, blockwise and
flash attention with their gradients, the criterions, and a 5-step run
of the local Optimizer on a tiny LlamaLM. Inputs come from numpy; the
reference's weights and optimizer slots are copied into the port
(interop/from_jax.py). The CUDA kernels run only on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.core import IteratorDataSet as JaxIteratorDataSet
from bigdl_tpu.dataset.core import MiniBatch as JaxMiniBatch
from bigdl_tpu.interop.huggingface import LlamaLM as JaxLlamaLM
from bigdl_tpu.kernels import fused_update as jfu
from bigdl_tpu.kernels.flash_attention import (PallasFlashAttention,
                                               flash_attention as jax_flash)
from bigdl_tpu.nn.attention import blockwise_attention as jax_blockwise
from bigdl_tpu.optim import method as jm
from bigdl_tpu.optim.local import Optimizer as JaxOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.dataset.core import IteratorDataSet, MiniBatch
from bigdl_tpu_torch.interop.from_jax import slots_from_jax, tree_to_paths
from bigdl_tpu_torch.interop.huggingface import LlamaLM
from bigdl_tpu_torch.kernels import fused_update as fu
from bigdl_tpu_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention)
from bigdl_tpu_torch.models import train as train_cli
from bigdl_tpu_torch.nn import criterion as pc
from bigdl_tpu_torch.nn.attention import blockwise_attention, padding_mask
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.optim import method as pm
from bigdl_tpu_torch.optim.local import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from torch_parity import CPU, np_tree, port_from, t

# fp32 elementwise update given the same scalars: the same operations in
# the same order as the reference's `_math`, each rounded once; torch's
# vectorized CPU sqrt is not correctly rounded (1 ulp), so 1 ulp
UPDATE_ULP = 1
# the Pallas kernel in interpret mode differs from the reference's own
# `_math` by a few ulp (XLA fuses the interpreted body its own way);
# against it, the reference's own Pallas-vs-oracle tolerance
# (tests/test_fused_update.py)
STEP_RTOL, STEP_ATOL = 2e-6, 2e-7
# attention gradients through a recompute: the reference's own
# flash-vs-dense gradient tolerance (tests/test_kernels.py)
GRAD_TOL = 3e-5
# losses of a few steps: the XLA and torch forwards differ by a few ulp
# per op; 1e-5 relative on an O(5) loss
LOSS_RTOL = 1e-5
# parameters after 5 Adam(1e-3) steps: per-op ulp differences in a
# gradient near 0 can turn Adam's normalized step (up to lr per step);
# 1e-4 absolute on O(0.1) weights
PARAM_ATOL = 1e-4

TINY = dict(vocab_size=128, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=256, num_layers=2)


def _tree(seed=0):
    r = np.random.RandomState(seed)
    params = {"w1": r.randn(33, 7), "blk": {"w2": r.randn(4097),
                                           "b": r.randn(1, 5)},
              "one": r.randn(1)}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    grads = jax.tree.map(
        lambda p: jnp.asarray(r.randn(*p.shape), jnp.float32), params)
    return params, grads


def _paths(tree):
    return tree_to_paths(np_tree(tree), CPU)


FUSED_CASES = [
    ("adam", lambda M: M.Adam(1e-3)),
    ("adam-wd", lambda M: M.Adam(1e-3, weight_decay=0.01)),
    ("adamw", lambda M: M.AdamW(1e-3, weight_decay=0.05)),
    ("sgd", lambda M: M.SGD(0.1)),
    ("sgd-mom-damp-wd", lambda M: M.SGD(0.1, momentum=0.5, dampening=0.1,
                                        weight_decay=0.02)),
    ("sgd-nesterov", lambda M: M.SGD(0.1, momentum=0.9, nesterov=True)),
]


def _assert_close(got: dict, want_tree):
    want = _paths(want_tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)


def _warm_slots(jmeth, params, grads):
    """A non-zero reference optimizer state: two oracle steps."""
    slots = jmeth.init_slots(params)
    for s in range(2):
        params, slots = jmeth.update(params, grads, slots, jnp.float32(1e-2),
                                     jnp.int32(s))
    return params, slots


@pytest.mark.parametrize("name,make", FUSED_CASES, ids=[c[0] for c in
                                                        FUSED_CASES])
def test_fused_update_plain_matches_pallas_kernel(name, make):
    """The kernel's arithmetic: fused_update_plain over the leaf list
    against the reference's `_math` (1 ulp) and its Pallas kernel in
    interpret mode (STEP_RTOL/ATOL) over the concatenated leaves, given
    the same lr, bias corrections and non-zero state."""
    params, grads = _tree()
    jmeth, pmeth = make(jm), make(pm)
    params, slots = _warm_slots(jmeth, params, grads)
    kind, hyper = jfu.describe(jmeth)
    assert fu.describe(pmeth) == (kind, hyper)
    bc1, bc2 = (np.float32(b) for b in
                jfu._bias_corrections(kind, hyper, jnp.int32(7)))
    names = jfu.slot_names(kind, hyper)
    leaves, treedef = jax.tree.flatten(params)

    def flat(tree):
        return jnp.concatenate([a.ravel() for a in
                                treedef.flatten_up_to(tree)])
    want_p, want_s = jfu._pallas_flat(
        kind, hyper, flat(params), flat(grads),
        tuple(flat(slots[nm]) for nm in names), jnp.float32(5e-3),
        jnp.float32(bc1), jnp.float32(bc2), 8, True)
    got_p, got_s = fu.fused_update_plain(
        kind, hyper, [t(np.array(a)) for a in leaves],
        [t(np.array(a)) for a in treedef.flatten_up_to(grads)],
        [[t(np.array(a)) for a in treedef.flatten_up_to(slots[nm])]
         for nm in names],
        5e-3, float(bc1), float(bc2))

    math_p, math_s = jfu._math(
        kind, hyper, flat(params), flat(grads),
        tuple(flat(slots[nm]) for nm in names), jnp.float32(5e-3),
        jnp.float32(bc1), jnp.float32(bc2))

    def cat(ts):
        return torch.cat([x.ravel() for x in ts]).numpy()
    for got, pallas, math in zip([got_p, *got_s], [want_p, *want_s],
                                 [math_p, *math_s]):
        np.testing.assert_array_max_ulp(cat(got), np.asarray(math),
                                        maxulp=UPDATE_ULP)
        np.testing.assert_allclose(cat(got), np.asarray(pallas),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)


def test_bias_corrections_match_reference():
    """fp32 `1 - b ** t`. The port's fp32 pow is correctly rounded; XLA's
    CPU pow (exp of t * log b in fp32) drifts with t: 1 ulp of b ** t at
    t = 8, 314 ulp at t = 4001 for b = 0.999 (measured). After the
    subtraction from 1 the bias corrections agree within 1e-5
    relative."""
    hyper = {"b1": 0.9, "b2": 0.999}
    for step in (0, 1, 7, 99, 999, 4000):
        want = jfu._bias_corrections("adam", hyper, jnp.int32(step))
        got = fu._bias_corrections("adam", hyper, step)
        for b, w, g in zip((0.9, 0.999), want, got):
            np.testing.assert_allclose(g, np.float32(w), rtol=1e-5, atol=0)
            exact = np.float32(np.float64(np.float32(b)) ** (step + 1))
            assert g == np.float32(1) - exact
    assert fu._bias_corrections("sgd", {}, 3) == (1.0, 1.0)


@pytest.mark.parametrize("name,make", FUSED_CASES, ids=[c[0] for c in
                                                        FUSED_CASES])
def test_make_update_fn_matches_reference(name, make):
    """make_update_fn against the reference's flat Pallas layout
    (interpret mode), from a non-zero state carried over with
    slots_from_jax; besides the arithmetic above, the bias correction's
    1-ulp pow differs (magnified by 1 - b ** t), within the same
    tolerance. Bit for bit equal to the port's tree-map oracle, and in
    place, as the kernel is."""
    params, grads = _tree()
    jmeth, pmeth = make(jm), make(pm)
    params, slots = _warm_slots(jmeth, params, grads)
    jupd = jfu.make_update_fn(jmeth, layout="flat", use_pallas=True,
                              interpret=True, block_rows=8)
    want_p, want_s = jupd(params, grads, slots, jnp.float32(5e-3),
                          jnp.int32(7))
    p, g = _paths(params), _paths(grads)
    s = slots_from_jax(np_tree(slots), CPU)
    got_p, got_s = fu.make_update_fn(pmeth)(p, g, s, 5e-3, 7)
    _assert_close(got_p, want_p)
    for nm in fu.slot_names(*fu.describe(pmeth)):
        _assert_close(got_s[nm], want_s[nm])
        assert all(got_s[nm][k] is s[nm][k] for k in p)
    want_o, want_os = pmeth.update(_paths(params), g, slots_from_jax(
        np_tree(slots), CPU), 5e-3, 7)
    for k in want_o:
        assert got_p[k] is p[k]
        assert torch.equal(got_p[k], want_o[k]), k
        for nm in want_os:
            assert torch.equal(got_s[nm][k], want_os[nm][k]), (nm, k)


def test_fused_update_cpu_wrapper_does_not_launch(monkeypatch):
    for raw, on in (("", False), ("0", False), ("off", False), ("1", True),
                    ("flat", True), ("leaf", True)):
        monkeypatch.setenv("BIGDL_TPU_FUSED_UPDATE", raw)
        assert fu.enabled() is on, raw
    kind, hyper = fu.describe(pm.Adam(1e-3))
    p = [torch.ones(5)]
    g = [torch.full((5,), 0.5)]
    s = [[torch.zeros(5)], [torch.zeros(5)]]
    fu.fused_update.launches.reset()
    bc1, bc2 = fu._bias_corrections(kind, hyper, 0)
    fu.fused_update(kind, hyper, p, g, s, 1e-3, bc1, bc2)
    assert fu.fused_update.launches.value == 0
    assert float(p[0][0]) < 1.0 and float(s[0][0][0]) > 0.0
    with pytest.raises(ValueError, match="cuda or cpu"):
        fu.fused_update(kind, hyper, [torch.empty(3, device="meta")],
                        [torch.empty(3, device="meta")],
                        [[torch.empty(3, device="meta")]] * 2, 1e-3, 1., 1.)
    assert fu.make_update_fn(pm.RMSprop()) is None
    assert fu.describe(type("MyAdam", (pm.Adam,), {})()) is None


@pytest.mark.parametrize("name,make", FUSED_CASES + [
    ("rmsprop", lambda M: M.RMSprop(1e-2))], ids=[c[0] for c in FUSED_CASES]
    + ["rmsprop"])
def test_methods_match_reference(name, make):
    """OptimMethod.update over three steps, slots threaded: the port's
    tree-map oracle against the reference's."""
    params, grads = _tree(1)
    jmeth, pmeth = make(jm), make(pm)
    jp, js = params, jmeth.init_slots(params)
    pp = _paths(params)
    ps = pmeth.init_slots(pp)
    for step in range(3):
        jp, js = jmeth.update(jp, grads, js, jnp.float32(1e-2),
                              jnp.int32(step))
        pp, ps = pmeth.update(pp, _paths(grads), ps, 1e-2, step)
    _assert_close(pp, jp)
    for nm in (js or {}):
        _assert_close(ps[nm], js[nm])


def _qkv(b=2, h=2, tq=32, tk=32, d=16, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, h, tq, d).astype(np.float32),
            r.randn(b, h, tk, d).astype(np.float32),
            r.randn(b, h, tk, d).astype(np.float32))


@pytest.mark.parametrize("tq,tk,bs,causal", [(32, 32, 8, True),
                                             (16, 48, 16, True),
                                             (20, 36, 12, False)])
def test_blockwise_attention_matches_reference(tq, tk, bs, causal):
    q, k, v = _qkv(tq=tq, tk=tk)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         block_size=bs, causal=causal)
    got = blockwise_attention(t(q), t(k), t(v), block_size=bs,
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    with pytest.raises(ValueError, match="divide"):
        blockwise_attention(t(q), t(k), t(v), block_size=tk + 1)


def test_padding_mask():
    got = padding_mask(torch.tensor([1, 3]), 4)
    assert got.shape == (2, 1, 1, 4)
    assert got[:, 0, 0].tolist() == [[True, False, False, False],
                                     [True, True, True, False]]


@pytest.mark.parametrize("tq,tk,causal", [(32, 32, True), (32, 32, False),
                                          (24, 33, False), (33, 33, True)])
def test_flash_gradients_match_reference(tq, tk, causal):
    """q/k/v gradients through the port's FlashAttention Function (the
    plain forward on the CPU, the dense recompute backward) against
    jax.grad through the Pallas kernel in interpret mode (its custom_vjp
    recomputes through blockwise attention)."""
    q, k, v = _qkv(tq=tq, tk=tk, seed=tq + tk)
    w = np.random.RandomState(9).randn(2, 2, tq, 16).astype(np.float32)

    def f_ref(q, k, v):
        return (jax_flash(q, k, v, 16, 16, causal, None, True) * w).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq_, tk_, tv_ = (t(a).requires_grad_() for a in (q, k, v))
    out = FlashAttention()(tq_, tk_, tv_, causal=causal)
    got = torch.autograd.grad((out * t(w)).sum(), (tq_, tk_, tv_))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    flash_attention.launches.reset()
    assert flash_attention(t(q), t(k), t(v), causal=causal).shape == q.shape
    assert flash_attention.launches.value == 0


def _criterion_case(seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(3, 5, 7).astype(np.float32)
    y = r.randint(0, 7, (3, 5)).astype(np.int32)
    y[0, 1] = 2
    return x, y


@pytest.mark.parametrize("kind", ["nll", "ce", "ce-sum", "ce-weights-ignore"])
def test_criterions_match_reference(kind):
    """ClassNLL/CrossEntropy on (B, C) rows, and TimeDistributed over
    (B, T, C): the reference loops over T, the port computes the steps in
    one pass and sums them in another order (1e-6 relative)."""
    x, y = _criterion_case()
    kw = {}
    if kind == "ce-weights-ignore":
        kw = dict(weights=np.linspace(0.5, 2.0, 7).astype(np.float32),
                  ignore_index=2)
    if kind == "ce-sum":
        kw = dict(size_average=False)
    if kind == "nll":
        x = np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))
        jc, pcr = jnn.ClassNLLCriterion(), pc.ClassNLLCriterion()
    else:
        jc, pcr = (jnn.CrossEntropyCriterion(**kw),
                   pc.CrossEntropyCriterion(**kw))
    want = jc.forward(jnp.asarray(x[:, 0]), jnp.asarray(y[:, 0]))
    got = pcr.forward(t(x[:, 0]), t(y[:, 0]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for avg in (True, False):
        want = jnn.TimeDistributedCriterion(jc, size_average=avg).forward(
            jnp.asarray(x), jnp.asarray(y))
        got = pc.TimeDistributedCriterion(pcr, size_average=avg).forward(
            t(x), t(y))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


class _Losses:
    """Train summary that keeps the per-step losses."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def _tokens(seed=0, shape=(4, 16)):
    r = np.random.RandomState(seed)
    return (r.randint(0, TINY["vocab_size"], shape).astype(np.int32),
            r.randint(0, TINY["vocab_size"], shape).astype(np.int32))


@pytest.mark.parametrize("flash,fused,accum", [
    (False, "0", 1), (False, "1", 1), (True, "1", 1), (False, "0", 2)],
    ids=["dense-oracle", "dense-fused", "flash-fused", "dense-accum2"])
def test_trainer_matches_reference(monkeypatch, flash, fused, accum):
    """5 Adam steps of the local Optimizer on a tiny LlamaLM in both
    packages, from the same weights and batches: per-step losses within
    1e-5 relative, final params within 1e-4 absolute."""
    monkeypatch.setenv("BIGDL_TPU_FUSED_UPDATE", fused)
    jmod = JaxLlamaLM(**TINY, tied=True, attn_impl=PallasFlashAttention(
        16, 16, interpret=True) if flash else "dense")
    pmod = LlamaLM(**TINY, tied=True,
                   attn_impl=FlashAttention() if flash else "dense")
    params, state, pmod = port_from(jmod, pmod)
    batches = [_tokens(s) for s in range(3)]

    def crit(nn_):
        return nn_.TimeDistributedCriterion(nn_.CrossEntropyCriterion(),
                                            size_average=True)

    jopt = JaxOptimizer(jmod, JaxIteratorDataSet(
        lambda: iter([JaxMiniBatch(x, y) for x, y in batches])),
        crit(jnn), jm.Adam(1e-3), accum_steps=accum)
    jopt.set_initial(params, state).set_end_when(JaxTrigger.max_iteration(5))
    jsum = _Losses()
    jopt.set_train_summary(jsum)
    jparams, _ = jopt.optimize()

    popt = Optimizer(pmod, IteratorDataSet(
        lambda: iter([MiniBatch(x, y) for x, y in batches])),
        crit(pc), pm.Adam(1e-3), accum_steps=accum, device=CPU)
    popt.set_end_when(Trigger.max_iteration(5))
    psum = _Losses()
    popt.set_train_summary(psum)
    pparams, pstate = popt.optimize()

    assert len(psum.losses) == 5 and pstate == {}
    np.testing.assert_allclose(psum.losses, jsum.losses, rtol=LOSS_RTOL)
    want = _paths(jparams)
    assert pparams.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(pparams[k].numpy(), want[k].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    assert popt.state["neval"] == 5 and popt.state["epoch"] == 1


@pytest.mark.parametrize("fused", ["0", "1"], ids=["oracle", "fused"])
def test_accum_step_masks_a_nonfinite_step_as_reference(monkeypatch, fused):
    """accum_steps=2 with a NaN in one microbatch of the second batch:
    the reference's scan step masks that step's update and trains on;
    so does the port. Per-step losses (the NaN included) within 1e-5
    relative, final params within 1e-4 absolute."""
    monkeypatch.setenv("BIGDL_TPU_FUSED_UPDATE", fused)
    r = np.random.RandomState(5)
    batches = [(r.randn(4, 6).astype(np.float32),
                r.randint(0, 5, (4,)).astype(np.int32)) for _ in range(3)]
    batches[1][0][0, 2] = np.nan
    jmod, pmod = jnn.Linear(6, 5), Linear(6, 5)
    params, state, pmod = port_from(jmod, pmod)

    jopt = JaxOptimizer(jmod, JaxIteratorDataSet(
        lambda: iter([JaxMiniBatch(x, y) for x, y in batches])),
        jnn.CrossEntropyCriterion(), jm.Adam(1e-2), accum_steps=2)
    jopt.set_initial(params, state).set_end_when(JaxTrigger.max_iteration(5))
    jsum = _Losses()
    jparams, _ = jopt.set_train_summary(jsum).optimize()

    popt = Optimizer(pmod, IteratorDataSet(
        lambda: iter([MiniBatch(x, y) for x, y in batches])),
        pc.CrossEntropyCriterion(), pm.Adam(1e-2), accum_steps=2, device=CPU)
    psum = _Losses()
    pparams, _ = popt.set_train_summary(psum).set_end_when(
        Trigger.max_iteration(5)).optimize()

    # the poisoned batch comes again in the second epoch (step 5); two
    # non-finite steps that are not consecutive never abort
    assert np.isnan(psum.losses).tolist() == [False, True, False, False,
                                              True]
    np.testing.assert_allclose(psum.losses, jsum.losses, rtol=LOSS_RTOL)
    want = _paths(jparams)
    for k in want:
        assert torch.isfinite(pparams[k]).all(), k
        np.testing.assert_allclose(pparams[k].numpy(), want[k].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    for sl in popt.slots.values():
        assert all(torch.isfinite(s).all() for s in sl.values())


def test_trainer_freeze_clipping_and_refusals(monkeypatch):
    """A frozen subtree keeps its weights; clipping composes; what is
    not ported refuses loudly; the default device is the card."""
    x, y = _tokens(3)
    model = LlamaLM(**TINY, tied=True).init(torch.Generator().manual_seed(0),
                                            device=CPU)
    model.l1.freeze()
    mask = model.trainable_mask()
    assert not mask["l1.attn.wq"] and mask["l0.attn.wq"] and mask["embed"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = Optimizer(model, IteratorDataSet(lambda: iter([MiniBatch(x, y)])),
                    pc.TimeDistributedCriterion(pc.CrossEntropyCriterion()),
                    pm.SGD(0.1, momentum=0.9, weight_decay=0.1), device=CPU)
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_constant_gradient_clipping(-0.01, 0.01)
    opt.set_end_when(Trigger.max_iteration(2)).optimize()
    after = model.state_dict()
    for k in before:
        moved = not torch.equal(before[k], after[k])
        assert moved == mask[k], k
    assert opt.slots["velocity"]["l1.attn.wq"].abs().sum() > 0
    model.unfreeze()
    assert all(model.trainable_mask().values())

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Optimizer(model, None, None, steps_per_call=2, device=CPU)
    opt.set_validation(Trigger.every_epoch(), None, [])
    with pytest.raises(NotImplementedError, match="metrics"):
        opt.optimize()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Optimizer(model, None, None)


def test_trainer_draws_an_undrawn_model_from_seed():
    x, y = _tokens(4)

    def run():
        model = LlamaLM(**TINY, tied=True)
        assert next(model.parameters(), None) is None
        Optimizer(model, IteratorDataSet(lambda: iter([MiniBatch(x, y)])),
                  pc.TimeDistributedCriterion(pc.CrossEntropyCriterion()),
                  pm.Adam(), seed=3, device=CPU).optimize()
        return model.embed.detach()

    assert torch.equal(run(), run())


def test_ptb_llama_cli_trains_on_cpu(capsys):
    train_cli.main(["ptb", "--model", "llama", "--device", "cpu",
                    "--max-iter", "3", "--hidden", "32", "--num-steps", "8",
                    "-b", "4"])
    out = capsys.readouterr().out
    loss = float(out.split("loss ")[1].split()[0])
    assert np.isfinite(loss) and "finished at iter 3" in out
    for argv in (["--model", "lstm"], ["--model", "llama",
                                       "--pipeline-stages", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_cli.main(["ptb", "--device", "cpu", *argv])


def test_module_freeze_is_per_subtree():
    class Two(Module):
        def __init__(self):
            super().__init__()
            self.add_child("a", LlamaLM(**TINY))
            self.add_child("b", LlamaLM(**TINY))

    m = Two().init(torch.Generator().manual_seed(0), device=CPU)
    m.b.freeze()
    mask = m.trainable_mask()
    assert all(v for k, v in mask.items() if k.startswith("a."))
    assert not any(v for k, v in mask.items() if k.startswith("b."))


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True),
                                               (False, False)])
def test_data_pipeline_matches_reference(shuffle, drop_last):
    """ArrayDataSet's batches over two epochs, SampleToMiniBatch's
    padding, and the PTB vocabulary and token windows: equal to the
    reference's, element for element."""
    from bigdl_tpu.dataset import core as jdc
    from bigdl_tpu.dataset import text as jtext
    from bigdl_tpu_torch.dataset import core as pdc
    from bigdl_tpu_torch.dataset import text as ptext

    r = np.random.RandomState(0)
    feats, labels = r.randn(23, 3).astype(np.float32), np.arange(23)
    mk = dict(batch_size=5, shuffle=shuffle, seed=4, drop_last=drop_last)
    want_ds, got_ds = (m.ArrayDataSet(feats, labels, **mk) for m in (jdc, pdc))
    assert len(got_ds) == len(want_ds)
    for epoch in range(2):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        want, got = list(want_ds), list(got_ds)
        assert len(got) == len(want)
        for (wx, wy), (gx, gy) in zip(want, got):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)

    samples = [(np.arange(n, dtype=np.float32), np.full(n, n))
               for n in (3, 1, 4, 2, 5)]
    for pad_to in (None, 4):
        want, got = ([(b.input, b.target) for b in m.SampleToMiniBatch(
            2, drop_last=drop_last, pad_to=pad_to, pad_value=-1.0)(
                m.Sample(f, l) for f, l in samples)] for m in (jdc, pdc))
        assert len(got) == len(want)
        for (wx, wy), (gx, gy) in zip(want, got):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)

    words = jtext.ptb_raw(None, "train")
    assert ptext.ptb_raw(None, "train") == words
    jd = jtext.Dictionary([words], vocab_size=99)
    pd = ptext.Dictionary([words], vocab_size=99)
    assert pd.vocab_size == jd.vocab_size
    for a, b in zip(ptext.ptb_batches(words, pd, 4, 7),
                    jtext.ptb_batches(words, jd, 4, 7)):
        np.testing.assert_array_equal(a, b)
