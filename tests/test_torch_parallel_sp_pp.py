"""Sequence and pipeline parallelism on 4 gloo ranks against JAX's
4-device meshes (``jax.devices()[:4]``), in f32 on the ``tiny`` preset.

The ranks run this file as a script (``python tests/test_torch_parallel_
sp_pp.py RANK DIR``, ``test_torch_support.Ranks``), once per test session
(a module-scoped fixture), joined by a ``file://`` store, with a budget
of the gang's own time. They import no JAX: the parent writes the inputs
(numpy, from seeds) to ``DIR/inputs.npz``, computes the JAX reference,
then starts the ranks and reads ``DIR/rank{r}.{npz,json}``.

Cases (mirroring tests/test_ops_attention.py :48-83 and :142-200,
tests/test_models_llama.py:87-150 and the six cases of
tests/test_parallel_pipeline.py):

- ring (H 4, KV 2) and Ulysses (H 8, KV 4) attention on sp=4: each
  rank's chunk of the output and the inputs' gradients (summed over the
  ranks) against JAX's shard_map, within ATTN_TOL;
- ``forward_sp`` (ring, Ulysses) on dp2 x sp2 under ``ShardingRules.full()``
  through ``make_train_step``: 3 AdamW steps, losses and grad norms within
  TOL of JAX's on the same mesh, the params by test_torch_parallel_train.
  py's PARAM rule;
- ``pipeline_trunk`` on pp=4 against the sequential stack and JAX's;
- ``forward_pp`` (gpipe and 1f1b) on pp2 x dp2 against JAX's and against
  ``forward`` (PP_TOL, the reference test's bound);
- 1F1B trunk gradients equal to GPipe's and to JAX's, on pp2 (M 4) and
  pp4 (M 8);
- a 1F1B Llama training run equal to GPipe's step for step, and to JAX's;
- ``pipeline_train_1f1b`` against JAX's and against autodiff, on (pp, M)
  (2, 4), (4, 8), (4, 2);
- pp2 x tp2 under ``fsdp_tp``: 3 AdamW steps against JAX's;
- the loss and every gradient of ``loss_fn`` on sharded meshes against
  the same weights unsharded: ``forward_pp`` (both schedules) on
  pp2 x fsdp2, pp2 x dp2 and pp2 x tp2, ``forward_sp`` (ring) on sp4 and
  sp2 x tp2 (GRAD_TOL).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_support import Ranks, flat, jax_tree_to_np, jax_reference, \
    rank_main, unflat
from test_torch_parallel_train import (PARAM_FAR_SHARE, PARAM_MAX,
                                       PARAM_TOL, TOL)

WORLD = 4
RANK_TIMEOUT_S = 240
STEPS = 3
# f32 attention of the same inputs, another summation order
ATTN_TOL = 1e-5
# the reference test's bound (test_parallel_pipeline.py)
PP_TOL = 2e-4
# f32 gradients of one small trunk, another microbatch summation order
GRAD_TOL = 1e-5
ATTN = {"ring": dict(B=2, S=128, H=4, KV=2, D=16),
        "ulysses": dict(B=1, S=128, H=8, KV=4, D=16)}
SP_IMPLS = ("ring", "ulysses")
TRUNK_CASES = [(2, 4, 2), (4, 8, 1)]            # (pp, M, dp)
TRAIN_1F1B_CASES = [(2, 4), (4, 8), (4, 2)]      # (pp, M)
L_TRUNK, D_TRUNK, B_TRUNK = 8, 16, 16
# (name, mesh, rules, cfg changes) of the sharded-against-unsharded cases
SHARD_CASES = [(f"pp2_{ax}2_{sched}", {"pp": 2, ax: 2}, rules,
                {"pp_schedule": sched})
               for ax, rules in (("fsdp", "fsdp"), ("dp", "fsdp_tp"),
                                 ("tp", "fsdp_tp"))
               for sched in ("gpipe", "1f1b")] + [
    ("sp4_ring", {"sp": 4}, "full", {"attn_impl": "ring"}),
    ("sp2_tp2_ring", {"sp": 2, "tp": 2}, "full", {"attn_impl": "ring"})]


def _inputs():
    """Every input, from seeds: attention q/k/v and cotangents, Llama
    weights (the port's init, as numpy), token batches, trunk weights."""
    import torch

    from ray_tpu_torch.models import llama

    rng = np.random.default_rng(0)
    out = {}
    for op, c in ATTN.items():
        for n, h in (("q", c["H"]), ("k", c["KV"]), ("v", c["KV"])):
            out[f"attn/{op}/{n}"] = rng.standard_normal(
                (c["B"], c["S"], h, c["D"])).astype(np.float32)
        out[f"attn/{op}/w"] = rng.standard_normal(
            (c["B"], c["S"], c["H"], c["D"])).astype(np.float32)
    for n_layers in (2, 4):
        cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32,
                                            n_layers=n_layers)
        p = llama.init_params(torch.Generator().manual_seed(n_layers), cfg)
        out.update(flat({k: (v.numpy() if not isinstance(v, dict) else
                             {kk: vv.numpy() for kk, vv in v.items()})
                         for k, v in p.items()}, f"llama{n_layers}"))
    out["tok_sp"] = rng.integers(0, 256, (4, 33)).astype(np.int32)
    out["tok_pp_fwd"] = rng.integers(0, 256, (4, 16)).astype(np.int32)
    out["tok_pp"] = rng.integers(0, 256, (8, 17)).astype(np.int32)
    out["trunk/w"] = (rng.standard_normal((L_TRUNK, D_TRUNK, D_TRUNK))
                      * 0.5).astype(np.float32)
    out["trunk/x"] = rng.standard_normal((8, D_TRUNK)).astype(np.float32)
    out["g/w"] = (rng.standard_normal((L_TRUNK, D_TRUNK, D_TRUNK))
                  * 0.3).astype(np.float32)
    out["g/b"] = (rng.standard_normal((L_TRUNK, D_TRUNK))
                  * 0.1).astype(np.float32)
    out["g/head"] = (rng.standard_normal((D_TRUNK, D_TRUNK))
                     * 0.3).astype(np.float32)
    out["g/x"] = rng.standard_normal((B_TRUNK, D_TRUNK)).astype(np.float32)
    out["g/tgt"] = rng.standard_normal((B_TRUNK, D_TRUNK)).astype(np.float32)
    return out


def _sp_batch(tok):
    return {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


# --- the parent: JAX reference --------------------------------------------------


def _jax_expected(inp):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    out = {}
    devs = jax.devices()[:WORLD]
    with jax_reference() as ref:
        def mesh(**spec):
            return ref.mesh.build_mesh(ref.mesh.MeshSpec(**spec),
                                       devices=devs)

        # ring / Ulysses on sp=4: output and the inputs' gradients
        sp4 = jax.make_mesh((WORLD,), ("sp",), devices=devs)
        for op in ATTN:
            fn = (ref.ring_attention.ring_attention if op == "ring"
                  else ref.ulysses.ulysses_attention)
            sm = jax.shard_map(lambda q, k, v, fn=fn: fn(q, k, v,
                                                         axis_name="sp"),
                               mesh=sp4, in_specs=(P(None, "sp"),) * 3,
                               out_specs=P(None, "sp"))
            args = [jnp.asarray(inp[f"attn/{op}/{n}"]) for n in "qkv"]
            w = jnp.asarray(inp[f"attn/{op}/w"])
            out[f"attn/{op}/out"] = np.asarray(jax.jit(sm)(*args))
            grads = jax.jit(jax.grad(lambda *a: (sm(*a) * w).sum(),
                                     argnums=(0, 1, 2)))(*args)
            for n, g in zip("qkv", grads):
                out[f"attn/{op}/d{n}"] = np.asarray(g)

        def train(jcfg, mesh_, rules, opt, batch, params):
            jp = jax.tree.map(jnp.asarray, params)
            init_fn, state_sh = ref.train_step.make_train_state_init(
                lambda k: jp, opt, mesh_, rules, ref.llama.param_specs(jcfg))
            state = init_fn(jax.random.PRNGKey(0))
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            step = ref.train_step.make_train_step(
                lambda p, b: ref.llama.loss_fn(p, b, jcfg, mesh_, rules),
                opt, mesh_, rules, state_sh,
                batch_shapes=jax.eval_shape(lambda: jb))
            metrics = []
            for _ in range(STEPS):
                state, m = step(state, jb)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            return np.asarray(metrics), jax_tree_to_np(state.params)

        # forward_sp on dp2 x sp2 through make_train_step
        p2 = unflat(inp, "llama2")
        for impl in SP_IMPLS:
            jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jnp.float32,
                                                     attn_impl=impl)
            m, params = train(jcfg, mesh(dp=2, sp=2),
                              ref.sharding.ShardingRules.full(),
                              optax.adamw(3e-4, weight_decay=0.01),
                              _sp_batch(inp["tok_sp"]), p2)
            out[f"sp/{impl}/metrics"] = m
            out.update(flat(params, f"sp/{impl}/params"))

        # pipeline_trunk on pp=4
        def tanh_stage(w, x):
            y, _ = jax.lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None), x, w)
            return y

        trunk = ref.pipeline.pipeline_trunk(tanh_stage, mesh(pp=WORLD), 4)
        out["trunk/out"] = np.asarray(jax.jit(trunk)(
            ref.pipeline.stack_stages(jnp.asarray(inp["trunk/w"]), WORLD),
            jnp.asarray(inp["trunk/x"])))

        # forward_pp on pp2 x dp2
        p4 = jax.tree.map(jnp.asarray, unflat(inp, "llama4"))
        cfg4 = ref.llama.PRESETS["tiny"].replace(remat=False,
                                                 dtype=jnp.float32,
                                                 n_layers=4)
        tok = jnp.asarray(inp["tok_pp_fwd"])
        out["fwd_pp/forward"] = np.asarray(ref.llama.forward(p4, tok, cfg4))
        for sched in ("gpipe", "1f1b"):
            c = cfg4.replace(pp_schedule=sched)
            out[f"fwd_pp/{sched}"] = np.asarray(jax.jit(
                lambda p, t, c=c: ref.llama.forward_pp(
                    p, t, c, mesh(pp=2, dp=2), num_microbatches=2))(p4, tok))

        # 1F1B trunk gradients against GPipe's
        layers = {"w": jnp.asarray(inp["g/w"]), "b": jnp.asarray(inp["g/b"])}
        x, tgt = jnp.asarray(inp["g/x"]), jnp.asarray(inp["g/tgt"])

        def wb_stage(sp_, h):
            y, _ = jax.lax.scan(
                lambda h, lp: (jnp.tanh(h @ lp["w"] + lp["b"]), None), h, sp_)
            return y

        for pp, M, dp in TRUNK_CASES:
            stacked = ref.pipeline.stack_stages(layers, pp)
            for sched in ("gpipe", "1f1b"):
                t = ref.pipeline.pipeline_trunk(wb_stage, mesh(dp=dp, pp=pp),
                                                M, schedule=sched)
                lf = lambda p, xx, t=t: jnp.mean((t(p, xx) - tgt) ** 2)
                dp_, dx = jax.jit(jax.grad(lf, argnums=(0, 1)))(stacked, x)
                key = f"grad/{pp}_{M}/{sched}"
                out[f"{key}/w"] = np.asarray(dp_["w"])
                out[f"{key}/b"] = np.asarray(dp_["b"])
                out[f"{key}/x"] = np.asarray(dx)

        # 1F1B Llama steps against GPipe's (adam 1e-2, the reference test)
        for sched in ("gpipe", "1f1b"):
            jcfg = cfg4.replace(pp_schedule=sched)
            m, _ = train(jcfg, mesh(pp=2, dp=2),
                         ref.sharding.ShardingRules.fsdp_tp(),
                         optax.adam(1e-2), {"tokens": inp["tok_pp"]},
                         unflat(inp, "llama4"))
            out[f"llama_pp/{sched}/metrics"] = m

        # pipeline_train_1f1b against autodiff
        head = {"w": jnp.asarray(inp["g/head"])}

        def head_loss(hp, y, t):
            return jnp.mean((y @ hp["w"] - t) ** 2)

        def ref_loss(ly, hp, xx):
            return head_loss(hp, wb_stage(ly, xx), tgt)

        loss_ref, grads_ref = jax.jit(jax.value_and_grad(
            ref_loss, argnums=(0, 1, 2)))(layers, head, x)
        out["t1f1b/auto/loss"] = np.asarray(loss_ref)
        out["t1f1b/auto/w"] = np.asarray(grads_ref[0]["w"])
        out["t1f1b/auto/b"] = np.asarray(grads_ref[0]["b"])
        out["t1f1b/auto/head"] = np.asarray(grads_ref[1]["w"])
        out["t1f1b/auto/x"] = np.asarray(grads_ref[2])
        for pp, M in TRAIN_1F1B_CASES:
            step = ref.pipeline.pipeline_train_1f1b(
                wb_stage, head_loss, mesh(dp=WORLD // pp, pp=pp), M)
            loss, d_st, d_head, dx = jax.jit(step)(
                ref.pipeline.stack_stages(layers, pp), head, x, tgt)
            d_l = ref.pipeline.unstack_stages(d_st)
            key = f"t1f1b/{pp}_{M}"
            out[f"{key}/loss"] = np.asarray(loss)
            out[f"{key}/w"] = np.asarray(d_l["w"])
            out[f"{key}/b"] = np.asarray(d_l["b"])
            out[f"{key}/head"] = np.asarray(d_head["w"])
            out[f"{key}/x"] = np.asarray(dx)

        # pp2 x tp2 under fsdp_tp
        m, params = train(cfg4, mesh(pp=2, tp=2),
                          ref.sharding.ShardingRules.fsdp_tp(),
                          optax.adamw(3e-4, weight_decay=0.01),
                          {"tokens": inp["tok_pp"]}, unflat(inp, "llama4"))
        out["pp_tp/metrics"] = m
        out.update(flat(params, "pp_tp/params"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, JAX's expected values, [(rank npz, rank json)])."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("parallel_sp_pp")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    # the reference first: the ranks' budget is their own time
    expected = _jax_expected(inp)
    return inp, expected, Ranks(Path(__file__), d, WORLD,
                                RANK_TIMEOUT_S).run()


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _param_rule(got, want, n_leaves):
    """test_torch_parallel_train.py's PARAM rule, counted in elements: at
    most PARAM_FAR_SHARE of a leaf's elements, and at least one, further
    than PARAM_TOL apart. The tiny leaves here hold 8192 elements, where
    the share alone allows none; the one such element seen (wq[1, 33, 43]
    under sp) has a first-step gradient of -7e-11, the eps-scale kind whose
    normalised AdamW step flips with rounding (see there)."""
    assert got.keys() == want.keys() and len(got) == n_leaves
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= PARAM_MAX, (k, d.max())
        far = int((d > PARAM_TOL).sum())
        assert far <= max(1, PARAM_FAR_SHARE * d.size), (
            k, np.argwhere(d > PARAM_TOL)[:4], d.max())


@pytest.mark.parametrize("op", list(ATTN))
def test_attention_on_sp4_matches_jax(ranks, op):
    _, expected, results = ranks
    out = np.concatenate([a[f"attn/{op}/out"] for a, _ in results], axis=1)
    _close(out, expected[f"attn/{op}/out"], ATTN_TOL)
    for a, _ in results:
        for n in "qkv":
            _close(a[f"attn/{op}/d{n}"], expected[f"attn/{op}/d{n}"],
                   ATTN_TOL)


@pytest.mark.parametrize("impl", SP_IMPLS)
def test_forward_sp_training_matches_jax(ranks, impl):
    """dp2 x sp2, ShardingRules.full(), through make_train_step."""
    _, expected, results = ranks
    want = expected[f"sp/{impl}/metrics"]
    wp = {k: v for k, v in expected.items()
          if k.startswith(f"sp/{impl}/params/")}
    for arrays, info in results:
        got = arrays[f"sp/{impl}/metrics"]
        _close(got, want, TOL)
        assert got[-1, 0] < got[0, 0]
        _param_rule({k: v for k, v in arrays.items()
                     if k.startswith(f"sp/{impl}/params/")}, wp, 12)
        # the sequence really was split: each rank held 16 of 32 tokens
        assert info["sp_local_tokens"][impl] == [2, 16]


def test_pipeline_trunk_on_pp4_matches_sequential(ranks):
    inp, expected, results = ranks
    x = inp["trunk/x"]
    for w in inp["trunk/w"]:
        x = np.tanh(x @ w)
    for arrays, _ in results:
        for sched in ("gpipe", "1f1b"):
            _close(arrays[f"trunk/{sched}"], x, 1e-5)
            _close(arrays[f"trunk/{sched}"], expected["trunk/out"], 1e-5)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_forward_pp_matches_jax_and_forward(ranks, sched):
    _, expected, results = ranks
    for arrays, _ in results:
        got = arrays[f"fwd_pp/{sched}"]
        _close(got, expected[f"fwd_pp/{sched}"], PP_TOL)
        _close(got, expected["fwd_pp/forward"], PP_TOL)
        _close(got, arrays["fwd_pp/forward"], PP_TOL)


@pytest.mark.parametrize("pp,M,dp", TRUNK_CASES)
def test_1f1b_gradients_equal_gpipe_and_jax(ranks, pp, M, dp):
    _, expected, results = ranks
    for arrays, _ in results:
        for leaf in ("w", "b", "x"):
            g = arrays[f"grad/{pp}_{M}/gpipe/{leaf}"]
            f = arrays[f"grad/{pp}_{M}/1f1b/{leaf}"]
            np.testing.assert_allclose(f, g, rtol=1e-5, atol=1e-6)
            for sched in ("gpipe", "1f1b"):
                _close(arrays[f"grad/{pp}_{M}/{sched}/{leaf}"],
                       expected[f"grad/{pp}_{M}/{sched}/{leaf}"], GRAD_TOL)


def test_1f1b_llama_training_matches_gpipe(ranks):
    """pp2 x dp2, fsdp_tp, Adam(1e-2): the two schedules step for step
    (the reference test's rtol) and each against JAX's."""
    _, expected, results = ranks
    for arrays, _ in results:
        g = arrays["llama_pp/gpipe/metrics"]
        f = arrays["llama_pp/1f1b/metrics"]
        np.testing.assert_allclose(f[:, 0], g[:, 0], rtol=1e-4)
        assert f[-1, 0] < f[0, 0]
        for sched in ("gpipe", "1f1b"):
            _close(arrays[f"llama_pp/{sched}/metrics"],
                   expected[f"llama_pp/{sched}/metrics"], TOL)


@pytest.mark.parametrize("pp,M", TRAIN_1F1B_CASES)
def test_pipeline_train_1f1b_matches_autodiff(ranks, pp, M):
    _, expected, results = ranks
    for arrays, _ in results:
        key = f"t1f1b/{pp}_{M}"
        for leaf in ("loss", "w", "b", "head", "x"):
            _close(arrays[f"{key}/{leaf}"], expected[f"{key}/{leaf}"],
                   GRAD_TOL)
            np.testing.assert_allclose(arrays[f"{key}/{leaf}"],
                                       expected[f"t1f1b/auto/{leaf}"],
                                       rtol=1e-4, atol=1e-5)


def test_pp_tp_training_matches_jax(ranks):
    """pp2 x tp2 under fsdp_tp: 3 AdamW steps."""
    _, expected, results = ranks
    wp = {k: v for k, v in expected.items()
          if k.startswith("pp_tp/params/")}
    for arrays, info in results:
        got = arrays["pp_tp/metrics"]
        _close(got, expected["pp_tp/metrics"], TOL)
        assert got[-1, 0] < got[0, 0]
        _param_rule({k: v for k, v in arrays.items()
                     if k.startswith("pp_tp/params/")}, wp, 12)
        # the layers rest whole over pp; wq's heads split over tp
        assert info["pp_tp_wq_local"] == [4, 64, 32]


@pytest.mark.parametrize("name", [c[0] for c in SHARD_CASES])
def test_sharded_loss_and_grads_equal_unsharded(ranks, name):
    _, _, results = ranks
    for _, info in results:
        loss_diff, grad_diff = info["sharded_vs_whole"][name]
        assert loss_diff <= TOL and grad_diff <= GRAD_TOL, (loss_diff,
                                                             grad_diff)


# --- a rank -----------------------------------------------------------------


def _rank_main(rank: int, d: Path) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention
    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel import pipeline as tpp
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.sharding import ShardingRules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=WORLD)
    inp = dict(np.load(d / "inputs.npz"))
    arrays, info = {}, {"sp_local_tokens": {}}
    cache = {}

    def mesh(**spec):
        key = tuple(sorted(spec.items()))
        if key not in cache:
            cache[key] = tmesh.build_mesh(tmesh.MeshSpec(**spec),
                                          device="cpu")
        return cache[key]

    def t(a, grad=False):
        return torch.from_numpy(np.array(a)).requires_grad_(grad)

    # ring / Ulysses on sp=4
    axis = spmd.Axis.of(mesh(sp=WORLD), "sp")
    for op in ATTN:
        q, k, v = (t(inp[f"attn/{op}/{n}"], True) for n in "qkv")
        n = q.shape[1] // WORLD
        c = slice(axis.index * n, (axis.index + 1) * n)
        fn = ring_attention if op == "ring" else ulysses_attention
        out = fn(q[:, c], k[:, c], v[:, c], axis=axis)
        w = t(inp[f"attn/{op}/w"])[:, c]
        grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        arrays[f"attn/{op}/out"] = out.detach().numpy()
        for name, g in zip("qkv", grads):
            dist.all_reduce(g)
            arrays[f"attn/{op}/d{name}"] = g.numpy()

    def train(cfg, mesh_, rules, opt, batch, params, loss=None):
        init, state_sh = ts.make_train_state_init(
            lambda g: llama.params_from_jax(params, "cpu"), opt, mesh_,
            rules, llama.param_specs(cfg), device="cpu")
        state = init(0)
        step = ts.make_train_step(
            loss or (lambda p, b: llama.loss_fn(p, b, cfg, mesh=mesh_,
                                                rules=rules)),
            mesh=mesh_, rules=rules, state_shardings=state_sh)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, tb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return np.asarray(metrics), state

    def gathered(params):
        return ts._map(lambda p: p.full_tensor().detach().numpy(), params)

    # forward_sp on dp2 x sp2
    p2 = unflat(inp, "llama2")
    for impl in SP_IMPLS:
        cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32,
                                            attn_impl=impl)
        m_ = mesh(dp=2, sp=2)
        rules = ShardingRules.full()
        seen = []

        def loss(p, b, cfg=cfg, m_=m_, rules=rules, seen=seen):
            seen.append(list(b["inputs"].to_local().shape))
            return llama.loss_fn(p, b, cfg, mesh=m_, rules=rules)

        metrics, state = train(cfg, m_, rules,
                               ts.adamw(3e-4, weight_decay=0.01),
                               _sp_batch(inp["tok_sp"]), p2, loss)
        arrays[f"sp/{impl}/metrics"] = metrics
        arrays.update(flat(gathered(state.params), f"sp/{impl}/params"))
        info["sp_local_tokens"][impl] = seen[0]

    # pipeline_trunk on pp=4
    def tanh_stage(w, x):
        for wi in w.unbind(0):
            x = torch.tanh(x @ wi)
        return x

    for sched in ("gpipe", "1f1b"):
        trunk = tpp.pipeline_trunk(tanh_stage, mesh(pp=WORLD), 4, sched)
        with torch.no_grad():
            arrays[f"trunk/{sched}"] = trunk(
                tpp.stack_stages(t(inp["trunk/w"]), WORLD),
                t(inp["trunk/x"])).numpy()

    # forward_pp on pp2 x dp2
    cfg4 = llama.PRESETS["tiny"].replace(remat=False, dtype=torch.float32,
                                         n_layers=4)
    p4 = llama.params_from_jax(unflat(inp, "llama4"), "cpu")
    tok = torch.from_numpy(inp["tok_pp_fwd"])
    with torch.no_grad():
        arrays["fwd_pp/forward"] = llama.forward(p4, tok, cfg4).numpy()
        for sched in ("gpipe", "1f1b"):
            arrays[f"fwd_pp/{sched}"] = llama.forward_pp(
                p4, tok, cfg4.replace(pp_schedule=sched), mesh(pp=2, dp=2),
                num_microbatches=2).numpy()

    # 1F1B trunk gradients against GPipe's
    def wb_stage(sp_, h):
        for w, b in zip(sp_["w"].unbind(0), sp_["b"].unbind(0)):
            h = torch.tanh(h @ w + b)
        return h

    tgt = t(inp["g/tgt"])
    for pp, M, dp in TRUNK_CASES:
        for sched in ("gpipe", "1f1b"):
            layers = {"w": t(inp["g/w"], True), "b": t(inp["g/b"], True)}
            x = t(inp["g/x"], True)
            trunk = tpp.pipeline_trunk(wb_stage, mesh(dp=dp, pp=pp), M,
                                       sched)
            y = trunk(tpp.stack_stages(layers, pp), x)
            gw, gb, gx = torch.autograd.grad(((y - tgt) ** 2).mean(),
                                             (layers["w"], layers["b"], x))
            key = f"grad/{pp}_{M}/{sched}"
            arrays[f"{key}/w"] = tpp.stack_stages(gw, pp).numpy()
            arrays[f"{key}/b"] = tpp.stack_stages(gb, pp).numpy()
            arrays[f"{key}/x"] = gx.numpy()

    # 1F1B Llama steps against GPipe's
    for sched in ("gpipe", "1f1b"):
        metrics, _ = train(cfg4.replace(pp_schedule=sched), mesh(pp=2, dp=2),
                           ShardingRules.fsdp_tp(),
                           ts.adamw(1e-2, weight_decay=0.0),
                           {"tokens": inp["tok_pp"]}, unflat(inp, "llama4"))
        arrays[f"llama_pp/{sched}/metrics"] = metrics

    # pipeline_train_1f1b
    def head_loss(hp, y, tg):
        return ((y @ hp["w"] - tg) ** 2).mean()

    for pp, M in TRAIN_1F1B_CASES:
        step = tpp.pipeline_train_1f1b(wb_stage, head_loss,
                                       mesh(dp=WORLD // pp, pp=pp), M)
        layers = {"w": t(inp["g/w"]), "b": t(inp["g/b"])}
        loss, d_st, d_head, dx = step(tpp.stack_stages(layers, pp),
                                      {"w": t(inp["g/head"])}, t(inp["g/x"]),
                                      tgt)
        d_l = tpp.unstack_stages(d_st)
        key = f"t1f1b/{pp}_{M}"
        arrays[f"{key}/loss"] = loss.numpy()
        arrays[f"{key}/w"] = d_l["w"].numpy()
        arrays[f"{key}/b"] = d_l["b"].numpy()
        arrays[f"{key}/head"] = d_head["w"].numpy()
        arrays[f"{key}/x"] = dx.numpy()

    # pp2 x tp2 under fsdp_tp
    metrics, state = train(cfg4, mesh(pp=2, tp=2), ShardingRules.fsdp_tp(),
                           ts.adamw(3e-4, weight_decay=0.01),
                           {"tokens": inp["tok_pp"]}, unflat(inp, "llama4"))
    arrays["pp_tp/metrics"] = metrics
    arrays.update(flat(gathered(state.params), "pp_tp/params"))
    info["pp_tp_wq_local"] = list(
        state.params["layers"]["wq"].to_local().shape)

    # loss_fn on sharded meshes against the same weights unsharded
    from ray_tpu_torch.parallel.sharding import shard_params

    info["sharded_vs_whole"] = {}
    base = llama.params_from_jax(unflat(inp, "llama4"), "cpu")
    batch = {"tokens": torch.from_numpy(inp["tok_pp"])}
    for name, spec, rules_name, change in SHARD_CASES:
        cfg = cfg4.replace(remat=True, **change)
        rules = getattr(ShardingRules, rules_name)()
        whole = ts._map(lambda t: t.clone().requires_grad_(True), base)
        want = llama.loss_fn(whole, batch, cfg)
        want.backward()
        m_ = mesh(**spec)
        sharded = ts._map(lambda t: t.requires_grad_(True), shard_params(
            m_, base, llama.param_specs(cfg), rules))
        got = llama.loss_fn(sharded, batch, cfg, mesh=m_, rules=rules)
        got.backward()
        info["sharded_vs_whole"][name] = (
            abs(float(got.detach()) - float(want.detach())),
            max(float((a.grad.full_tensor() - b.grad).abs().max())
                for a, b in zip(ts._leaves(sharded), ts._leaves(whole))))

    np.savez(d / f"rank{rank}.npz", **arrays)
    (d / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(_rank_main)
