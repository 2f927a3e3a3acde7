"""Parity of the port's GPT-2 (``ray_tpu_torch/models/gpt2.py``) against
``ray_tpu/models/gpt2.py`` on the ``tiny`` preset, with the same weights
(the JAX init, carried over by ``params_from_jax``) and the same numpy
tokens. The reference's attention is the plain einsum path, so no Pallas
kernel runs on either side.

Tolerances, f32 (sums of width 64-256 in another order through 2 layers):
logits and losses within 1e-5 absolute (|logit| ~ 1, loss ~ 5.5);
gradients within 1e-5 absolute plus 1e-4 relative (the largest, of the
tied embedding, reach ~0.1); the 3-step AdamW trajectory within 1e-5 on
loss and grad norm and 1e-5 on the params (each step moves a param by
~lr = 3e-4), but for the key bias, whose exact gradient is 0. bf16 compute (f32 params): logits within 0.05 absolute, a
few bf16 ulps at |logit| ~ 1, as the two round their bf16 activations
at different points of each fused elementwise chain. The GELU trap: an
exact-erf GELU moves the f32 logits by more than 1e-4, twenty times the
bound above, so the parity test would catch it.

The ``cuda`` tests (no JAX) run the 2-layer cut of the 125m width on the
card against the CPU.
"""

import numpy as np
import pytest
import torch

from test_torch_support import (jax_reference, jax_tree_to_np, require_cuda,
                                to_np)

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.parallel import train_step as ts

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_TOL = 1e-5
BF16_TOL = 0.05
GELU_GAP = 1e-4


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def tiny(jax):
    """(JAX cfg, port cfg, numpy params) of the tiny preset in f32."""
    with jax_reference() as ref:
        jcfg = ref.gpt2.PRESETS["tiny"].replace(dtype=jax.numpy.float32)
        params = jax_tree_to_np(ref.gpt2.init_params(
            jax.random.PRNGKey(0), jcfg))
    tcfg = gpt2.PRESETS["tiny"].replace(dtype=torch.float32)
    return jcfg, tcfg, params


def _tokens(seed, shape=(2, 33)):
    return np.random.default_rng(seed).integers(
        0, 256, size=shape).astype(np.int32)


def _grad_params(params):
    return ts._map(lambda t: t.requires_grad_(True),
                   gpt2.params_from_jax(params, "cpu"))


def _assert_tree_close(ours, theirs, atol, rtol):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_tree_close(ours[k], theirs[k], atol, rtol)
        return
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), atol=atol,
                               rtol=rtol)


def test_presets_and_specs_match_jax(tiny):
    with jax_reference() as ref:
        for name, jc in ref.gpt2.PRESETS.items():
            tc = gpt2.PRESETS[name]
            for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                      "d_ff", "max_seq_len", "norm_eps", "remat"):
                assert getattr(tc, f) == getattr(jc, f), (name, f)
            assert gpt2.param_specs(tc) == ref.gpt2.param_specs(jc)
    _, tcfg, params = tiny
    ours = gpt2.init_params(torch.Generator().manual_seed(0), tcfg)
    # same tree, shapes and dtype; the numbers are each RNG's own
    _assert_shapes(ours, params)
    assert gpt2.num_params(tcfg) == sum(
        v.size for v in _flat(params))
    assert gpt2.num_params(gpt2.PRESETS["125m"]) == 124_439_808


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _assert_shapes(ours, theirs):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_shapes(ours[k], theirs[k])
        return
    assert tuple(ours.shape) == theirs.shape and ours.dtype == torch.float32


@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_match_jax(tiny, remat):
    jcfg, tcfg, params = tiny
    toks = _tokens(1)
    with jax_reference() as ref:
        jl = np.asarray(ref.gpt2.forward(params, toks,
                                         jcfg.replace(remat=remat)))
    tl = gpt2.forward(gpt2.params_from_jax(params, "cpu"),
                      torch.from_numpy(toks), tcfg.replace(remat=remat))
    assert tl.dtype == torch.float32 and tl.shape == (2, 33, 256)
    np.testing.assert_allclose(to_np(tl), jl, atol=TOL, rtol=0)


def test_out_of_range_tokens_read_as_jax_reads_them(tiny):
    """A JAX gather wraps a negative index once and clamps into the
    table, where torch's indexing would raise: the port clamps the same
    way (256 is the tiny vocab)."""
    jcfg, tcfg, params = tiny
    toks = np.array([[0, 255, 256, 1000, -1, -3, -300, 7]], np.int32)
    with jax_reference() as ref:
        jnp = ref.gpt2.jnp
        jl = np.asarray(ref.gpt2.forward(
            {k: (v if isinstance(v, dict) else jnp.asarray(v))
             for k, v in params.items()}, jnp.asarray(toks), jcfg))
    tl = gpt2.forward(gpt2.params_from_jax(params, "cpu"),
                      torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(to_np(tl), jl, atol=TOL, rtol=0)


@pytest.mark.parametrize("form", ["tokens", "inputs"])
def test_loss_fn_matches_jax(tiny, form):
    jcfg, tcfg, params = tiny
    toks = _tokens(2)
    batch = ({"tokens": toks} if form == "tokens" else
             {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    with jax_reference() as ref:
        jloss = float(ref.gpt2.loss_fn(params, batch, jcfg))
    tloss = gpt2.loss_fn(gpt2.params_from_jax(params, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         tcfg)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss) - jloss) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_match_jax(tiny, jax, remat):
    """grads of loss_fn against jax.grad, remat off and on; the tied
    embedding's gradient sums the gather's and the output matmul's."""
    jcfg, tcfg, params = tiny
    batch = {"tokens": _tokens(4)}
    with jax_reference() as ref:
        jcfg2 = jcfg.replace(remat=remat)
        jloss, jg = jax.value_and_grad(
            lambda p: ref.gpt2.loss_fn(p, batch, jcfg2))(params)
        jg = jax_tree_to_np(jg)
    tp = _grad_params(params)
    tloss = gpt2.loss_fn(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                         tcfg.replace(remat=remat))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL
    _assert_tree_close(ts._map(lambda t: t.grad, tp), jg, GRAD_ATOL,
                       GRAD_RTOL)


def test_train_trajectory_matches_jax(tiny, jax):
    """3 steps of the port's make_train_step + adamw(3e-4,
    weight_decay=0.01) against JAX make_train_step + optax.adamw on a
    one-device mesh: per-step loss and grad_norm, and the params after
    step 3."""
    import optax

    jcfg, tcfg, params = tiny
    toks = _tokens(7)
    with jax_reference() as ref:
        mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(dp=-1),
                                   devices=jax.devices()[:1])
        rules = ref.sharding.ShardingRules.dp()
        opt = optax.adamw(3e-4, weight_decay=0.01)
        jp = jax.tree.map(jax.numpy.asarray, params)
        init_fn, state_sh = ref.train_step.make_train_state_init(
            lambda k: jp, opt, mesh, rules, ref.gpt2.param_specs(jcfg))
        state = init_fn(jax.random.PRNGKey(0))
        step = ref.train_step.make_train_step(
            lambda p, b: ref.gpt2.loss_fn(p, b, jcfg), opt, mesh, rules,
            state_sh)
        jm = []
        for _ in range(3):
            state, m = step(state, {"tokens": jax.numpy.asarray(toks)})
            jm.append((float(m["loss"]), float(m["grad_norm"]),
                       int(m["step"])))
        jparams = jax_tree_to_np(state.params)

    init, _ = ts.make_train_state_init(
        lambda g: gpt2.params_from_jax(params, "cpu"),
        ts.adamw(3e-4, weight_decay=0.01), device="cpu")
    tstate = init(0)
    tstep = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, tcfg))
    for loss, gnorm, n in jm:
        tstate, m = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert m["step"] == n == tstate.step
        assert abs(float(m["loss"]) - loss) <= TOL
        assert abs(float(m["grad_norm"]) - gnorm) <= TOL
    assert jm[-1][0] < jm[0][0]
    # the key bias's exact gradient is 0 (a softmax is unchanged when the
    # same q.b is added to every score of a query), so both sides step on
    # rounding noise ~1e-12, which AdamW normalises into steps of up to
    # lr either way: it is held to 2 lr a step, everything else to
    # PARAM_TOL
    D = tcfg.d_model
    kb_ours = tstate.params["layers"]["bqkv"][:, D:2 * D]
    kb_jax = jparams["layers"]["bqkv"][:, D:2 * D]
    np.testing.assert_allclose(to_np(kb_ours), kb_jax, atol=3 * 2 * 3e-4,
                               rtol=0)
    for tree in (tstate.params, jparams):
        tree["layers"]["bqkv"] = tree["layers"]["bqkv"][:, [
            *range(D), *range(2 * D, 3 * D)]]
    _assert_tree_close(tstate.params, jparams, PARAM_TOL, 0)


def test_bf16_forward_matches_jax(tiny, jax):
    """bf16 compute over f32 params, within BF16_TOL: the LayerNorm's
    order (normalise in f32, cast, then * g + b in bf16) and the tanh
    GELU as the reference computes them."""
    jcfg, tcfg, params = tiny
    toks = _tokens(8)
    with jax_reference() as ref:
        jl = np.asarray(ref.gpt2.forward(
            params, toks, jcfg.replace(dtype=jax.numpy.bfloat16)))
    tl = gpt2.forward(gpt2.params_from_jax(params, "cpu"),
                      torch.from_numpy(toks),
                      tcfg.replace(dtype=torch.bfloat16))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(to_np(tl), jl, atol=BF16_TOL, rtol=0)


def test_exact_gelu_fails_and_tanh_gelu_passes(tiny, monkeypatch):
    """The GELU trap: torch's default (exact erf) GELU in the port's
    forward moves the logits off JAX's by more than GELU_GAP (20x the
    parity bound); the tanh form the port uses lands within TOL."""
    import torch.nn.functional as F

    jcfg, tcfg, params = tiny
    toks = _tokens(9)
    with jax_reference() as ref:
        jl = np.asarray(ref.gpt2.forward(params, toks, jcfg))
    tp = gpt2.params_from_jax(params, "cpu")
    tanh = to_np(gpt2.forward(tp, torch.from_numpy(toks), tcfg))
    gelu = F.gelu
    monkeypatch.setattr(gpt2.F, "gelu",
                        lambda x, approximate="none": gelu(x))
    exact = to_np(gpt2.forward(tp, torch.from_numpy(toks), tcfg))
    assert np.abs(tanh - jl).max() <= TOL
    assert np.abs(exact - jl).max() > GELU_GAP


@pytest.mark.cuda
def test_card_matches_cpu_at_125m_width():
    """On the card: the 125m width cut to 2 layers, f32 without TF32, the
    same init and tokens on the card and on the CPU: logits within 1e-3
    (768- and 3072-long f32 sums in another order), one AdamW step's loss
    within 1e-5 relative."""
    require_cuda()
    cfg = gpt2.PRESETS["125m"].replace(n_layers=2, dtype=torch.float32)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 129)))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            p = ts._map(lambda t: t.to(dev), params)
            logits = gpt2.forward(p, toks[:, :-1].to(dev), cfg)
            init, _ = ts.make_train_state_init(lambda g: p, ts.adamw(3e-4),
                                               device=dev)
            state, m = ts.make_train_step(
                lambda q, b: gpt2.loss_fn(q, b, cfg))(
                    init(0), {"tokens": toks.to(dev)})
            out[dev] = (logits.detach().cpu(), float(m["loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-3,
                               rtol=0)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * out["cpu"][1]
