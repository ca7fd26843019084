"""The port's pipelined LM path against the JAX reference, on the CPU: the
cut cross-entropy (its plain kernels against the reference's Pallas
kernels in interpret mode), LayerNormalization, the sinusoidal signal,
TransformerLayer, the flat-row carry-across, apply_update, the Pipeline
and 3 Adam steps of a tiny PipelinedLM on 1 and 2 stages, fused and
dense. Inputs come from numpy; the reference's weights and optimizer
slots are copied into the port (interop/from_jax.py). The CUDA kernels
run only on the card (tests/test_torch_cuda.py).

Nothing is built at import: the reference runs are module-scoped
fixtures shared by the tests that read them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from bigdl_tpu_torch.interop.from_jax import (flat_layout,
                                              load_pipelined_lm,
                                              paths_to_rows,
                                              pipelined_lm_state,
                                              rows_to_paths, tree_to_paths)
from bigdl_tpu_torch.kernels.cut_cross_entropy import (
    cut_cross_entropy, cut_cross_entropy_plain)
from bigdl_tpu_torch.models.pipelined_lm import CausalBlocks, PipelinedLM
from bigdl_tpu_torch.nn.attention import (TransformerLayer,
                                          positional_encoding)
from bigdl_tpu_torch.nn.normalization import LayerNormalization
from bigdl_tpu_torch.optim import method as pm
from bigdl_tpu_torch.parallel.pipeline import Pipeline
from torch_parity import CPU, np_tree, port_from, run_port, t

# fp32 forwards of a few ops: XLA and torch round a few ulp apart
FWD_TOL = 1e-5
# the cut cross-entropy: dense plain kernels against the reference's
# blockwise Pallas kernels (online logsumexp over 512-column blocks);
# sums in other orders, ~1e-6 of the largest value
CCE_TOL = 2e-5
# losses of a few steps: per-op ulp differences; 1e-5 relative on an
# O(4) loss
LOSS_RTOL = 1e-5
# parameters and logits after 3 Adam(1e-2) steps: an ulp difference in a
# gradient near 0 can turn Adam's normalized step; 1e-4 absolute
PARAM_ATOL = 1e-4

LM = dict(vocab_size=37, d_model=32, num_heads=2, num_layers=2)
B, T, STEPS, ADAM_LR = 8, 16, 3, 1e-2


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("pipe",))


# ------------------------------------------------------ cut cross-entropy
@pytest.fixture(scope="module")
def cce_case():
    """N=256, D=32, V=1000 (not a multiple of the 512-column block): the
    reference's loss and its gradients against a random cotangent."""
    from bigdl_tpu.kernels.cut_cross_entropy import cut_cross_entropy as jcce
    r = np.random.RandomState(0)
    h = r.randn(256, 32).astype(np.float32)
    w = (r.randn(1000, 32) / np.sqrt(32)).astype(np.float32)
    labels = r.randint(0, 1000, 256).astype(np.int32)
    g = r.randn(256).astype(np.float32)
    loss, pull = jax.vjp(lambda a, b: jcce(a, b, jnp.asarray(labels),
                                           interpret=True),
                         jnp.asarray(h), jnp.asarray(w))
    dh, dw = pull(jnp.asarray(g))
    return (h, w, labels, g), tuple(np.asarray(a) for a in (loss, dh, dw))


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.mark.parametrize("fn", [cut_cross_entropy, cut_cross_entropy_plain],
                         ids=["function", "plain"])
def test_cut_cross_entropy_matches_reference(cce_case, fn):
    (h, w, labels, g), want = cce_case
    ht, wt = t(h).requires_grad_(), t(w).requires_grad_()
    loss = fn(ht, wt, t(labels).long())
    dh, dw = torch.autograd.grad(loss, (ht, wt), t(g))
    for a, b in zip((loss, dh, dw), want):
        _close(a.detach().numpy(), b, CCE_TOL)


@pytest.fixture(scope="module")
def cce_wide_case():
    """N=128, V=500, D=1280 (GPT-2 large's width, past the 1024 columns
    the CUDA kernels once refused): the reference returns here, its loss
    and gradients against a random cotangent."""
    from bigdl_tpu.kernels.cut_cross_entropy import cut_cross_entropy as jcce
    r = np.random.RandomState(3)
    h = r.randn(128, 1280).astype(np.float32)
    w = (r.randn(500, 1280) / np.sqrt(1280)).astype(np.float32)
    labels = r.randint(0, 500, 128).astype(np.int32)
    g = r.randn(128).astype(np.float32)
    loss, pull = jax.vjp(lambda a, b: jcce(a, b, jnp.asarray(labels),
                                           interpret=True),
                         jnp.asarray(h), jnp.asarray(w))
    dh, dw = pull(jnp.asarray(g))
    return (h, w, labels, g), tuple(np.asarray(a) for a in (loss, dh, dw))


@pytest.mark.parametrize("fn", [cut_cross_entropy, cut_cross_entropy_plain],
                         ids=["function", "plain"])
def test_cut_cross_entropy_past_1024_columns_matches_reference(
        cce_wide_case, fn):
    (h, w, labels, g), want = cce_wide_case
    ht, wt = t(h).requires_grad_(), t(w).requires_grad_()
    loss = fn(ht, wt, t(labels).long())
    dh, dw = torch.autograd.grad(loss, (ht, wt), t(g))
    for a, b in zip((loss, dh, dw), want):
        _close(a.detach().numpy(), b, CCE_TOL)


def test_cut_cross_entropy_block_contract():
    h, w = torch.zeros(200, 8), torch.zeros(16, 8)
    labels = torch.zeros(200, dtype=torch.long)
    with pytest.raises(ValueError, match="multiple of block_n=128"):
        cut_cross_entropy(h, w, labels)
    assert cut_cross_entropy(h, w, labels, block_n=40).shape == (200,)
    assert cut_cross_entropy(h[:96], w, labels[:96]).shape == (96,)


# -------------------------------------------------------------- layers
def test_layer_norm_matches_reference():
    from bigdl_tpu.nn.normalization import LayerNormalization as JLN
    r = np.random.RandomState(1)
    x = (r.randn(3, 5, 24) * 3 + 1).astype(np.float32)
    # non-trivial affine parameters
    params = {"weight": r.randn(24).astype(np.float32),
              "bias": r.randn(24).astype(np.float32)}
    port = LayerNormalization(24)
    for k, v in params.items():
        port.set_param(k, t(v))
    want, _ = JLN(24).apply(params, {}, jnp.asarray(x))
    np.testing.assert_allclose(run_port(port, t(x)), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("d", [1, 7, 8, 33])
def test_positional_encoding_matches_reference(d):
    from bigdl_tpu.nn.attention import positional_encoding as jpe
    np.testing.assert_allclose(positional_encoding(50, d).numpy(),
                               np.asarray(jpe(50, d)), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_transformer_layer_matches_reference(causal):
    from bigdl_tpu.nn.attention import TransformerLayer as JTL
    x = np.random.RandomState(3).randn(2, 9, 16).astype(np.float32)
    params, state, port = port_from(JTL(16, 4, 40), TransformerLayer(16, 4,
                                                                     40))
    want, _ = JTL(16, 4, 40).apply(params, state, jnp.asarray(x),
                                   causal=causal)
    with torch.no_grad():
        got = port(t(x), causal=causal).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_dropout_in_training_is_refused():
    layer = TransformerLayer(8, 2, 16, dropout=0.1).init(
        torch.Generator().manual_seed(0), device=CPU)
    x = torch.zeros(1, 3, 8)
    layer.eval()(x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer.train()(x)


# --------------------------------------------------- flat-row carry-across
def test_flat_rows_carry_across_with_twelve_blocks():
    """12 blocks in one stage: jax.tree.flatten packs b0, b1, b10, b11, b2
    ... and the keys inside each block sorted; both directions must
    follow that order, not the module's. The second, one-block stage's
    row is zero-padded to the first's width. The rows are packed by the
    reference's own packer from the reference stages' tree shapes."""
    from bigdl_tpu.models.pipelined_lm import CausalBlocks as JCB
    from bigdl_tpu.parallel.pipeline import _StageMeta
    r = np.random.RandomState(8)
    trees = []
    for k in (12, 1):
        shapes, _ = jax.eval_shape(JCB(8, 2, 12, k).init,
                                   jax.random.PRNGKey(0))
        trees.append(jax.tree.map(
            lambda s: r.randn(*s.shape).astype(np.float32), shapes))
    metas = [_StageMeta(tr) for tr in trees]
    width = max(m.total for m in metas)
    rows = np.stack([np.asarray(m.flatten(tr, width))
                     for m, tr in zip(metas, trees)])
    pipe = Pipeline([CausalBlocks(8, 2, 12, 12), CausalBlocks(8, 2, 12, 1)],
                    n_microbatches=2)
    order = [p for p, _ in flat_layout(pipe.s0)]
    assert order[:3] == ["b0.attn.wk", "b0.attn.wo", "b0.attn.wq"]
    assert [p.split(".")[0] for p in order[::12]][:4] == ["b0", "b1", "b10",
                                                          "b11"]
    got = rows_to_paths(pipe, rows, device=CPU)
    want = {f"s{i}.{k}": v for i, tr in enumerate(trees)
            for k, v in tree_to_paths(tr, CPU).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    np.testing.assert_array_equal(paths_to_rows(pipe, want), rows)


# ------------------------------------------------------------ the update
def test_apply_update_matches_reference():
    from bigdl_tpu.optim import method as jm
    r = np.random.RandomState(4)
    params = {"a": r.randn(5).astype(np.float32),
              "b": {"c": r.randn(2, 3).astype(np.float32)}}
    grads = jax.tree.map(lambda p: r.randn(*p.shape).astype(np.float32),
                         params)
    p_port, g_port = tree_to_paths(params, CPU), tree_to_paths(grads, CPU)
    # plain SGD
    want, _ = jm.apply_update(None, params, grads, None, sgd_lr=0.1)
    got, _ = pm.apply_update(None, p_port, g_port, None, sgd_lr=0.1)
    for k, v in tree_to_paths(np_tree(want), CPU).items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)
    # Adam, two steps: the step counter advances inside the slots
    jslots = jm.init_update_slots(jm.Adam(1e-2), params)
    slots = pm.init_update_slots(pm.Adam(1e-2), p_port)
    jp, p = params, p_port
    for _ in range(2):
        jp, jslots = jm.apply_update(jm.Adam(1e-2), jp, grads, jslots)
        p, slots = pm.apply_update(pm.Adam(1e-2), p, g_port, slots)
    assert slots[1] == int(jslots[1]) == 2
    for k, v in tree_to_paths(np_tree(jp), CPU).items():
        torch.testing.assert_close(p[k], v, atol=1e-7, rtol=1e-6)


# ------------------------------------------------------------ the pipeline
def test_pipeline_refuses_uneven_splits():
    with pytest.raises(ValueError, match="must divide by n_stages"):
        Pipeline([CausalBlocks(8, 2, 8, 1)] * 2, n_microbatches=3)
    pipe = Pipeline(CausalBlocks(8, 2, 8, 1), n_stages=2, n_microbatches=2)
    pipe.init(torch.Generator().manual_seed(0), device=CPU)
    assert not torch.equal(pipe.s0.b0.attn.wq, pipe.s1.b0.attn.wq)
    with pytest.raises(ValueError, match="batch 3 must divide"):
        pipe(torch.zeros(3, 4, 8))


def test_pipeline_train_step_is_the_microbatch_mean():
    """train_step's loss and gradients are the mean over microbatches of
    each microbatch's, and train_step_full's d_x is the gradient of that
    mean w.r.t. the input."""
    pipe = Pipeline(CausalBlocks(8, 2, 8, 1), n_stages=2, n_microbatches=4)
    pipe.init(torch.Generator().manual_seed(0), device=CPU)
    r = np.random.RandomState(5)
    x, y = t(r.randn(8, 3, 8).astype(np.float32)), t(
        r.randn(8, 3, 8).astype(np.float32))
    scale = torch.tensor(1.5)

    def loss_fn(h, yy, lp=None):
        s = scale if lp is None else lp["scale"]
        return torch.mean((h * s - yy) ** 2)

    loss, grads = pipe.train_step(x, y, loss_fn)
    loss_f, grads_f, d_x, d_lp = pipe.train_step_full(
        x, y, loss_fn, {"scale": scale})
    xg = x.clone().requires_grad_()
    sg = scale.clone().requires_grad_()
    want = sum(loss_fn(pipe.s1(pipe.s0(xg[i:i + 2])), y[i:i + 2],
                       {"scale": sg}) for i in range(0, 8, 2)) / 4
    params = dict(pipe.named_parameters())
    wg = torch.autograd.grad(want, [xg, sg, *params.values()])
    torch.testing.assert_close(loss, want.detach(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(loss_f, loss, atol=0, rtol=0)
    torch.testing.assert_close(d_x, wg[0], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(d_lp["scale"], wg[1], atol=1e-6, rtol=1e-5)
    for (k, g), w in zip(params.items(), wg[2:]):
        torch.testing.assert_close(grads[k], w, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(grads_f[k], grads[k], atol=0, rtol=0)


# ----------------------------------------------------- the pipelined LM
def _tokens(seed=6, b=B, tt=T, vocab=LM["vocab_size"]):
    r = np.random.RandomState(seed)
    toks = r.randint(0, vocab, (b, tt + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def reference_runs():
    """The reference runs of this module, made on first use."""
    return {}


def _reference(runs, stages, micro, fused):
    """3 Adam steps of the reference PipelinedLM, cached per setting:
    (initial state, initial slots, losses, final state, final logits)."""
    key = (stages, micro, fused)
    if key not in runs:
        from bigdl_tpu.models.pipelined_lm import PipelinedLM as JPLM
        from bigdl_tpu.optim import method as jm
        mesh = _mesh(stages)
        lm = JPLM(**LM, n_stages=stages, n_microbatches=micro,
                  fused_loss=fused, fused_interpret=True)
        st = lm.init(jax.random.PRNGKey(0), mesh)
        # the embedding and final norm replicated over the mesh, where the
        # first update leaves them: the second step then reuses the
        # first step's compiled programs
        rep = NamedSharding(mesh, PartitionSpec())
        st = {"emb": jax.device_put(st["emb"], rep),
              "ln": jax.device_put(st["ln"], rep), "pv": st["pv"]}
        adam = jm.Adam(ADAM_LR)
        slots = jm.init_update_slots(adam, {"emb": st["emb"], "ln": st["ln"],
                                            "flat": st["pv"]["flat"]})
        st0, slots0 = np_tree(st), np_tree(slots)
        x, y = (jnp.asarray(a) for a in _tokens())
        losses = []
        for _ in range(STEPS):
            st, loss, slots = lm.train_step(st, x, y, mesh, method=adam,
                                            slots=slots)
            losses.append(loss)
        runs[key] = (st0, slots0, losses, np_tree(st),
                     np.asarray(lm.apply(st, x, mesh)))
    return runs[key]


@pytest.mark.parametrize("stages,micro", [(1, 2), (2, 4)])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_pipelined_lm_matches_reference(reference_runs, stages, micro,
                                        fused):
    st0, slots0, want_losses, want_st, want_logits = _reference(
        reference_runs, stages, micro, fused)
    lm = PipelinedLM(**LM, n_stages=stages, n_microbatches=micro,
                     fused_loss=fused, device=CPU)
    slots = load_pipelined_lm(lm, st0, slots0, device=CPU)
    x, y = _tokens()
    losses = []
    for _ in range(STEPS):
        loss, slots = lm.train_step(x, y, method=pm.Adam(ADAM_LR),
                                    slots=slots)
        losses.append(loss)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert slots[1] == STEPS
    got = pipelined_lm_state(lm)
    np.testing.assert_allclose(got["emb"], want_st["emb"], atol=PARAM_ATOL)
    for k in ("weight", "bias"):
        np.testing.assert_allclose(got["ln"][k], want_st["ln"][k],
                                   atol=PARAM_ATOL)
    np.testing.assert_allclose(got["pv"]["flat"], want_st["pv"]["flat"],
                               atol=PARAM_ATOL)
    with torch.no_grad():
        logits = lm(x).numpy()
    assert logits.shape == (B, T, LM["vocab_size"])
    np.testing.assert_allclose(logits, want_logits, atol=PARAM_ATOL)


def test_pipelined_lm_fused_loss_unaligned_rows():
    """2 x 96 = 192 rows a microbatch, not a multiple of 128: the fused
    loss pads them, and its loss equals the port's dense loss and the
    reference's dense loss of the same weights (its stages, final norm
    and tied head run in order, without the pipeline's schedule)."""
    from bigdl_tpu.models.pipelined_lm import PipelinedLM as JPLM
    cfg = dict(vocab_size=13, d_model=16, num_heads=2, num_layers=2,
               n_stages=2, n_microbatches=4)
    x, y = _tokens(seed=7, tt=96, vocab=13)
    jlm = JPLM(**cfg)
    st = jlm.init(jax.random.PRNGKey(0), _mesh(2))

    @jax.jit
    def dense_loss(st, x, y):
        h = jlm._embed(st["emb"], x)
        for i, stage in enumerate(jlm.pipe.stages):
            h, _ = stage.apply(jlm.pipe.stage_params(st["pv"], i), {}, h)
        h, _ = jlm.final_ln.apply(st["ln"], {}, h)
        logp = jax.nn.log_softmax(h @ st["emb"].T, -1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1))

    want = float(dense_loss(st, jnp.asarray(x), jnp.asarray(y)))
    got = []
    for fused in (True, False):
        lm = PipelinedLM(**cfg, fused_loss=fused, device=CPU)
        load_pipelined_lm(lm, np_tree(st), device=CPU)
        got.append(lm.train_step(x, y, lr=0.05))
    assert np.isfinite(got[0])
    np.testing.assert_allclose(got, [want, want], rtol=LOSS_RTOL)
