"""The MoE model (ray_tpu_torch/models/moe.py) against the JAX reference,
on the ``tiny`` preset in f32 (mirroring tests/test_models_moe_gpt2.py
:41-80). Weights cross via ``params_from_jax``.

Routing is discontinuous (a flipped top-2 choice moves an output by a
whole expert), so every comparison asserts the routing first:

- the top-2 indices (and gates) equal JAX's ``jax.lax.top_k`` of the same
  router probabilities, on random inputs, on a tie, and at every layer of
  a forward (the port's FFN inputs fed to JAX's routing);
- the capacity slots and the kept mask equal the reference's arithmetic,
  with tokens dropped (a router skewed onto one expert);
- ``_moe_ffn``'s output and aux within TOL, then ``forward``, ``loss_fn``
  and every gradient within TOL, with and without drops;
- a 3-step AdamW trajectory within TRAJ_TOL (test_torch_parallel_train.
  py's PARAM rule on the params);
- the flash route at S 128 (JAX's Pallas kernels in interpret mode, the
  port's plain versions);
- expert parallel on 4 gloo ranks (dp2 x fsdp2, ``ShardingRules.ep()``):
  3 AdamW steps against JAX's make_train_step on the same 4-device mesh,
  each rank holding 1 of the 4 experts (and its AdamW moments) at rest.

The ``cuda`` case runs the tiny model on the card in f32 (TF32 off)
against the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_support import (Ranks, flat, jax_reference, jax_tree_to_np,
                                rank_main, require_cuda, to_np, unflat)
from test_torch_parallel_train import (PARAM_FAR_SHARE, PARAM_MAX,
                                       PARAM_TOL)

from ray_tpu_torch.models import moe
from ray_tpu_torch.parallel import train_step as ts

# f32, the same products summed in another order
TOL = 1e-5
# 3 AdamW steps: losses and grad norms (test_torch_train_step.py's bound)
TRAJ_TOL = 1e-4
STEPS = 3
WORLD = 4
RANK_TIMEOUT_S = 180


def _tokens(B=2, S=17, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, port cfg, numpy params) of the tiny MoE in f32."""
    jax = pytest.importorskip("jax")
    with jax_reference() as ref:
        jcfg = ref.moe.PRESETS["tiny"].replace(dtype=jax.numpy.float32)
        params = jax_tree_to_np(ref.moe.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    return jcfg, moe.PRESETS["tiny"].replace(dtype=torch.float32), params


def _jax_route(xt, router, K):
    """The reference's routing lines (moe.py:85-88), on numpy inputs."""
    import jax

    jnp = jax.numpy
    probs = jax.nn.softmax((jnp.asarray(xt) @ jnp.asarray(router)
                            ).astype(jnp.float32), axis=-1)
    gates, idx = jax.lax.top_k(probs, K)
    return np.asarray(probs), np.asarray(gates), np.asarray(idx)


def _jax_positions(idx, E, C):
    """The reference's slot lines (moe.py:98-104)."""
    import jax

    jnp = jax.numpy
    flat_idx = jnp.asarray(idx).reshape(-1)
    eo = jax.nn.one_hot(flat_idx, E, dtype=jnp.int32)
    pos = jnp.cumsum(eo, axis=0) * eo - 1
    pos = pos.sum(axis=-1)
    return np.asarray(pos), np.asarray(pos < C)


def _skewed(x, skew):
    """Inputs shifted by +2 where a router is skewed (``_skew_router``)."""
    return (x + (2.0 if skew else 0.0)).astype(np.float32)


def _skew_router(router, skew):
    """The router with skew / D added to expert 0's column: with inputs
    near +2, expert 0's logit leads by ~2 skew for every token."""
    router = router.copy()
    router[:, 0] += skew / router.shape[0]
    return router


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


@pytest.mark.parametrize("skew", [0.0, 30.0])
def test_top2_indices_then_slots_equal_jax(tiny, skew):
    """Indices first, then gates, slots and the kept mask. skew > 0 sends
    every token to expert 0 first, so its buffer overflows and tokens
    drop."""
    _, cfg, params = tiny
    rng = np.random.default_rng(2)
    xt = _skewed(rng.standard_normal((64, cfg.d_model)), skew)
    router = _skew_router(_layer0(params)["router"], skew)
    probs, gates, idx = _jax_route(xt, router, cfg.top_k)
    tp, tg, ti = moe._route(torch.from_numpy(xt), torch.from_numpy(router),
                            cfg)
    np.testing.assert_array_equal(ti.numpy(), idx)
    np.testing.assert_allclose(tg.numpy(), gates, atol=TOL, rtol=0)
    np.testing.assert_allclose(tp.numpy(), probs, atol=TOL, rtol=0)
    C = moe.capacity(cfg, 64)
    pos, keep = _jax_positions(idx, cfg.n_experts, C)
    tpos, tkeep = moe._positions(ti, cfg.n_experts, C)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert tpos.dtype == torch.int32
    if skew:
        assert not keep.all()          # the case drops tokens


def test_top2_tie_takes_the_lower_index(tiny):
    """Equal router probabilities: jax.lax.top_k puts the lower index
    first, and so does the port's stable sort."""
    _, cfg, _ = tiny
    xt = np.zeros((3, 4), np.float32)
    router = np.zeros((4, cfg.n_experts), np.float32)
    _, _, idx = _jax_route(xt, router, cfg.top_k)
    _, _, ti = moe._route(torch.from_numpy(xt), torch.from_numpy(router),
                          cfg)
    np.testing.assert_array_equal(ti.numpy(), idx)
    assert ti.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("skew", [0.0, 30.0])
def test_moe_ffn_matches_jax(tiny, skew):
    import jax

    jcfg, cfg, params = tiny
    lp = _layer0(params)
    rng = np.random.default_rng(4)
    x = _skewed(rng.standard_normal((2, 16, cfg.d_model)), skew)
    lp = dict(lp, router=_skew_router(lp["router"], skew))
    if skew:     # the case drops tokens
        idx = _jax_route(x.reshape(32, -1), lp["router"], cfg.top_k)[2]
        assert not _jax_positions(idx, cfg.n_experts,
                                  moe.capacity(cfg, 32))[1].all()
    with jax_reference() as ref:
        want, aux = ref.moe._moe_ffn(jax.numpy.asarray(x),
                                     jax.tree.map(jax.numpy.asarray, lp),
                                     jcfg)
    got, taux = moe._moe_ffn(torch.from_numpy(x),
                             moe.params_from_jax(lp, "cpu"), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert abs(float(taux) - float(aux)) <= TOL


def _routes_per_layer(params, tokens, cfg):
    """The port's forward with each layer's FFN input recorded, and the
    port's routing of it."""
    seen = []
    real = moe._moe_ffn

    def record(x, lp, c):
        seen.append((to_np(x.reshape(-1, x.shape[-1])).astype(np.float32),
                     to_np(lp["router"]).astype(np.float32),
                     to_np(moe._route(x.reshape(-1, x.shape[-1]),
                                      lp["router"], c)[2])))
        return real(x, lp, c)

    moe._moe_ffn = record
    try:
        with torch.no_grad():
            out = moe.forward(params, tokens, cfg)
    finally:
        moe._moe_ffn = real
    return seen, out


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_forward_loss_and_grads_match_jax(tiny, attn):
    """Routing at every layer first, then logits, aux, loss and every
    gradient. flash: S 128 (JAX's Pallas kernels in interpret mode)."""
    import jax

    jcfg, cfg, params = tiny
    jcfg, cfg = (c.replace(attn_impl=attn) for c in (jcfg, cfg))
    S = 129 if attn == "flash" else 17
    tokens = _tokens(S=S)
    batch = {"tokens": tokens}
    tp = moe.params_from_jax(params, "cpu")
    seen, _ = _routes_per_layer(tp, torch.from_numpy(tokens[:, :-1]), cfg)
    assert len(seen) == cfg.n_layers
    for h, router, idx in seen:
        np.testing.assert_array_equal(idx, _jax_route(h, router,
                                                      cfg.top_k)[2])
    with jax_reference() as ref:
        jp = jax.tree.map(jax.numpy.asarray, params)
        jb = {"tokens": jax.numpy.asarray(tokens)}
        logits, aux = ref.moe.forward(jp, jb["tokens"][:, :-1], jcfg)
        loss, grads = jax.value_and_grad(ref.moe.loss_fn)(jp, jb, jcfg)
    tp = ts._map(lambda t: t.requires_grad_(True), tp)
    tl, taux = moe.forward(tp, torch.from_numpy(tokens[:, :-1]), cfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(logits),
                               atol=TOL, rtol=0)
    assert abs(float(taux.detach()) - float(aux)) <= TOL
    assert float(taux.detach()) > 0
    tloss = moe.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert abs(float(tloss.detach()) - float(loss)) <= TOL
    tloss.backward()
    want = flat(jax_tree_to_np(grads))
    got = flat(ts._map(lambda t: t.grad.numpy(), tp))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)
    assert np.abs(got["/layers/router"]).sum() > 0


def test_adamw_trajectory_matches_jax(tiny):
    import jax
    import optax

    jcfg, cfg, params = tiny
    batch = {"tokens": _tokens(B=4)}
    with jax_reference() as ref:
        opt = optax.adamw(3e-4, weight_decay=0.01)
        jp = jax.tree.map(jax.numpy.asarray, params)
        state = opt.init(jp)
        jb = {"tokens": jax.numpy.asarray(batch["tokens"])}
        want = []

        @jax.jit
        def jstep(jp, state):
            loss, g = jax.value_and_grad(ref.moe.loss_fn)(jp, jb, jcfg)
            up, state = opt.update(g, state, jp)
            return (optax.apply_updates(jp, up), state, loss,
                    optax.global_norm(g))

        for _ in range(STEPS):
            jp, state, loss, gn = jstep(jp, state)
            want.append((float(loss), float(gn)))
        wp = flat(jax_tree_to_np(jp))
    init, _ = ts.make_train_state_init(
        lambda g: moe.params_from_jax(params, "cpu"),
        ts.adamw(3e-4, weight_decay=0.01), device="cpu")
    st = init(0)
    step = ts.make_train_step(lambda p, b: moe.loss_fn(p, b, cfg))
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    got = []
    for _ in range(STEPS):
        st, m = step(st, tb)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)
    assert got[-1][0] < got[0][0]
    gp = flat(ts._map(lambda t: t.detach().numpy(), st.params))
    for k in wp:
        d = np.abs(gp[k] - wp[k])
        assert d.max() <= PARAM_MAX, k
        assert (d > PARAM_TOL).sum() <= max(1, PARAM_FAR_SHARE * d.size), k


def test_init_and_specs_match_jax_layout(tiny):
    _, cfg, params = tiny
    got = moe.init_params(torch.Generator().manual_seed(0), cfg)
    shapes = flat(ts._map(lambda t: tuple(t.shape), got))
    assert shapes == flat({k: (tuple(v.shape) if not isinstance(v, dict)
                               else {kk: tuple(vv.shape)
                                     for kk, vv in v.items()})
                           for k, v in params.items()})
    with jax_reference() as ref:
        jcfg = ref.moe.PRESETS["tiny"]
        assert ref.moe.param_specs(jcfg) == moe.param_specs(cfg)
    assert moe.num_params(cfg) == sum(int(np.prod(s)) for s in
                                      shapes.values())
    big = moe.PRESETS["8x1b"]
    assert (big.d_model, big.n_experts, big.top_k, big.capacity_factor) == \
        (2048, 8, 2, 1.5)
    assert 4.7e9 < moe.num_params(big) < 4.9e9


# --- expert parallel on 4 ranks ------------------------------------------------


@pytest.fixture(scope="module")
def ep_ranks(tiny, tmp_path_factory):
    import jax
    import optax

    jcfg, _, params = tiny
    d = tmp_path_factory.mktemp("moe_ep")
    batch = _tokens(B=8)
    np.savez(d / "inputs.npz", tokens=batch, **flat(params, "params"))
    with jax_reference() as ref:
        mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(dp=2, fsdp=2),
                                   devices=jax.devices()[:WORLD])
        rules = ref.sharding.ShardingRules.ep()
        opt = optax.adamw(3e-4, weight_decay=0.01)
        jp = jax.tree.map(jax.numpy.asarray, params)
        init_fn, state_sh = ref.train_step.make_train_state_init(
            lambda k: jp, opt, mesh, rules, ref.moe.param_specs(jcfg))
        state = init_fn(jax.random.PRNGKey(0))
        jb = {"tokens": jax.numpy.asarray(batch)}
        step = ref.train_step.make_train_step(
            lambda p, b: ref.moe.loss_fn(p, b, jcfg), opt, mesh, rules,
            state_sh, batch_shapes=jax.eval_shape(lambda: jb))
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        expected = {"metrics": np.asarray(metrics),
                    **flat(jax_tree_to_np(state.params), "params")}
    # the reference first: the ranks' budget is their own time
    return expected, Ranks(Path(__file__), d, WORLD, RANK_TIMEOUT_S).run()


def test_expert_parallel_training_matches_jax(ep_ranks):
    expected, results = ep_ranks
    wp = {k: v for k, v in expected.items() if k.startswith("params/")}
    for arrays, info in results:
        got = arrays["metrics"]
        np.testing.assert_allclose(got, expected["metrics"], atol=TRAJ_TOL,
                                   rtol=0)
        assert got[-1, 0] < got[0, 0]
        gp = {k: v for k, v in arrays.items() if k.startswith("params/")}
        assert gp.keys() == wp.keys() and len(gp) == 13
        for k in wp:
            d = np.abs(gp[k] - wp[k])
            assert d.max() <= PARAM_MAX, (k, d.max())
            assert (d > PARAM_TOL).sum() <= max(1, PARAM_FAR_SHARE * d.size)


def test_expert_parallel_holds_one_expert_per_rank(ep_ranks):
    """Under ep() on dp2 x fsdp2 the 4 experts rest one per rank, their
    AdamW moments too; the dense weights rest whole."""
    _, results = ep_ranks
    experts = []
    for _, info in results:
        assert info["we_gate_local"] == [2, 1, 64, 96]
        assert info["we_gate_moment_local"] == [2, 1, 64, 96]
        assert info["wq_local"] == [2, 64, 64]
        experts.append(info["expert_index"])
    assert sorted(experts) == [0, 1, 2, 3]


def _rank_main(rank: int, d: Path) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel.sharding import ShardingRules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=WORLD)
    inp = dict(np.load(d / "inputs.npz"))
    params = unflat(inp, "params")
    cfg = moe.PRESETS["tiny"].replace(dtype=torch.float32)
    mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=2, fsdp=2), device="cpu")
    rules = ShardingRules.ep()
    init, state_sh = ts.make_train_state_init(
        lambda g: moe.params_from_jax(params, "cpu"),
        ts.adamw(3e-4, weight_decay=0.01), mesh, rules, moe.param_specs(cfg),
        device="cpu")
    state = init(0)
    step = ts.make_train_step(
        lambda p, b: moe.loss_fn(p, b, cfg, mesh=mesh, rules=rules),
        mesh=mesh, rules=rules, state_shardings=state_sh)
    batch = {"tokens": torch.from_numpy(inp["tokens"])}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    arrays = {"metrics": np.asarray(metrics),
              **flat(ts._map(lambda p: p.full_tensor().detach().numpy(),
                             state.params), "params")}
    we = state.params["layers"]["we_gate"]
    full = we.full_tensor()
    local = we.to_local()
    info = {"we_gate_local": list(local.shape),
            "we_gate_moment_local": list(
                state.opt_state.state[we]["exp_avg"].to_local().shape),
            "wq_local": list(state.params["layers"]["wq"].to_local().shape),
            "expert_index": next(e for e in range(full.shape[1]) if
                                 torch.equal(full[:, e:e + 1], local))}
    np.savez(d / f"rank{rank}.npz", **arrays)
    (d / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


# --- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_card_matches_cpu():
    """The tiny MoE with 2 heads of 32 (the card's flash backward runs
    head dims 32/64/128) in f32 (TF32 off), one init: the routing of
    every layer, then the loss and every gradient on the card (flash at S
    128: K1, K3, K4) against the CPU."""
    require_cuda()
    cfg = moe.PRESETS["tiny"].replace(dtype=torch.float32, attn_impl="flash",
                                      n_heads=2, n_kv_heads=1)
    params = moe.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(_tokens(S=129).astype(np.int64))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            p = ts._map(lambda t: t.to(dev, copy=True).requires_grad_(True),
                        params)
            seen, _ = _routes_per_layer(p, tokens[:, :-1].to(dev), cfg)
            loss = moe.loss_fn(p, {"tokens": tokens.to(dev)}, cfg)
            loss.backward()
            out[dev] = (float(loss), flat(ts._map(lambda t: to_np(t.grad),
                                                  p)),
                        [idx for _, _, idx in seen])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (lc, gc, ic), (lh, gh, ih) = out["cuda"], out["cpu"]
    assert len(ic) == cfg.n_layers
    for a, b in zip(ic, ih):
        np.testing.assert_array_equal(a, b)
    assert abs(lc - lh) <= TRAJ_TOL * abs(lh)
    for k in gh:
        np.testing.assert_allclose(gc[k], gh[k], atol=1e-4, rtol=0,
                                   err_msg=k)


if __name__ == "__main__":
    rank_main(_rank_main)
