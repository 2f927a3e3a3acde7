"""Sharded training on 2 gloo ranks against JAX's 2-device
``make_train_step``, on the ``tiny`` preset in f32 (H 4, KV 2, d_model 64,
d_ff 128, vocab 256: every axis of size 2 divides), flash route (S 128;
the port's plain versions on the CPU, JAX's Pallas kernels in interpret
mode).

The ranks run this file as a script (``python tests/test_torch_parallel_
train.py RANK DIR``), one pair of processes per test session (a
module-scoped fixture), joined by a ``file://`` store under pytest's
tmp_path, through ``test_torch_support.Ranks`` (one gang of ranks at a
time across the xdist workers; the budget is the gang's own time). They
import no JAX: the parent computes the JAX reference
(``jax_reference()``) first and passes weights, batches and
expected values through ``DIR/inputs.npz``; each rank writes
``DIR/rank{r}.npz`` and ``DIR/rank{r}.json``.

Cases, each a parametrised test reading the ranks' results:

- (d) for ``dp`` (MeshSpec(dp=2), ShardingRules.dp()), ``fsdp``
  (MeshSpec(fsdp=2), .fsdp()) and ``fsdp_tp`` (MeshSpec(tp=2),
  .fsdp_tp()), with and without a mask that differs by rank (rank 0's
  rows dense, rank 1's sparse): 3 AdamW(3e-4, weight_decay=0.01) steps,
  per-step loss and grad_norm within TOL of JAX's
  (test_torch_train_step.py's), and the gathered params after step 3
  within PARAM_TOL of JAX's but for at most PARAM_FAR_SHARE of each leaf,
  all within PARAM_MAX (see there); the fsdp AdamW moments hold half of
  each fsdp-sharded leaf on each rank;
- (e) the sharded init gathered back equals the unsharded init bit for
  bit, on each mesh;
- (g) ``sharded_jit``: late binding, local shapes inside, and a rebind
  that invalidates the cache;
- loss and gradients on each mesh against the same weights unsharded,
  with fused matmuls and with a sliding window;
- kernel wrappers refuse a DTensor; a mesh that does not divide a dim
  raises naming it; ``make_eval_step`` on the mesh gives the loss of the
  gathered params.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_support import (Ranks, jax_reference, jax_tree_to_np,
                                rank_main)

TOL = 1e-4
PARAM_TOL = 1e-5
# AdamW divides each element's step by its own RMS gradient, so where that
# gradient is at eps scale (~1e-9) rounding-level differences of the
# gradient (another summation order across ranks) move the update by a
# share of lr; chip_smoke.py's card-vs-CPU rule holds such elements:
# every param within 4 lr (3 steps move one by at most 3 lr), and at most
# 1e-4 of each leaf's elements more than PARAM_TOL apart
PARAM_MAX = 4 * 3e-4
PARAM_FAR_SHARE = 1e-4
MESHES = {"dp": dict(dp=2), "fsdp": dict(fsdp=2), "fsdp_tp": dict(tp=2)}
CASES = [(name, masked) for name in MESHES for masked in (False, True)]
STEPS = 3
RANK_TIMEOUT_S = 120
VARIANTS = ("fused_matmuls", "window")
# f32 gradients of one loss, unsharded against sharded: the same products
# summed in another order (tp's partial sums, the data ranks' parts)
GRAD_TOL = 1e-5


def _case_key(name, masked):
    return f"{name}_{'masked' if masked else 'plain'}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _unflat(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _batch(masked):
    """The global batch: 4 rows of 129 tokens; the mask (when asked) keeps
    rows 0-1 (rank 0's under dp/fsdp) dense and rows 2-3 sparse."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, size=(4, 129)).astype(np.int32)
    if not masked:
        return {"tokens": toks}
    keep = np.where(np.arange(4)[:, None] < 2, 0.9, 0.15)
    mask = (rng.random(size=(4, 129)) < keep).astype(np.int32)
    return {"tokens": toks, "mask": mask}


# --- the parent: JAX reference, then the two ranks ----------------------------


def _jax_trajectories(params):
    import jax
    import optax

    out = {}
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jax.numpy.float32,
                                                 attn_impl="flash")
        for name, masked in CASES:
            mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(**MESHES[name]),
                                       devices=jax.devices()[:2])
            rules = getattr(ref.sharding.ShardingRules, name)()
            opt = optax.adamw(3e-4, weight_decay=0.01)
            jp = jax.tree.map(jax.numpy.asarray, params)
            init_fn, state_sh = ref.train_step.make_train_state_init(
                lambda k: jp, opt, mesh, rules,
                ref.llama.param_specs(jcfg))
            state = init_fn(jax.random.PRNGKey(0))
            step = ref.train_step.make_train_step(
                lambda p, b: ref.llama.loss_fn(p, b, jcfg, mesh, rules),
                opt, mesh, rules, state_sh)
            batch = {k: jax.numpy.asarray(v)
                     for k, v in _batch(masked).items()}
            metrics = []
            for _ in range(STEPS):
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            key = _case_key(name, masked)
            out[f"{key}/metrics"] = np.asarray(metrics)
            out.update(_flat(jax_tree_to_np(state.params), f"{key}/params"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the JAX reference, then both ranks; returns (expected, [rank 0
    results, rank 1 results]) as (npz dict, [(npz dict, json dict)])."""
    jax = pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("parallel_train")
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jax.numpy.float32)
        params = jax_tree_to_np(ref.llama.init_params(
            jax.random.PRNGKey(0), jcfg))
    expected = _jax_trajectories(params)
    np.savez(d / "inputs.npz", **_flat(params, "params"))
    return expected, Ranks(Path(__file__), d, 2, RANK_TIMEOUT_S).run()


@pytest.mark.parametrize("name,masked", CASES)
def test_sharded_trajectory_matches_jax(ranks, name, masked):
    expected, results = ranks
    key = _case_key(name, masked)
    want = expected[f"{key}/metrics"]
    for arrays, _ in results:
        got = arrays[f"{key}/metrics"]
        assert got.shape == (STEPS, 2)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert got[-1, 0] < got[0, 0]
        gp = {k: v for k, v in arrays.items()
              if k.startswith(f"{key}/params/")}
        wp = {k: v for k, v in expected.items()
              if k.startswith(f"{key}/params/")}
        assert gp.keys() == wp.keys() and len(gp) == 12
        for k in wp:
            d = np.abs(gp[k] - wp[k])
            assert d.max() <= PARAM_MAX, (k, d.max())
            assert (d > PARAM_TOL).mean() <= PARAM_FAR_SHARE, \
                (k, np.argwhere(d > PARAM_TOL)[:4], d.max())


@pytest.mark.parametrize("name", list(MESHES))
def test_state_is_sharded_like_the_rules(ranks, name):
    """Params, grads and AdamW moments are DTensors; under fsdp the
    moments of an fsdp-sharded leaf are half the leaf on each rank, under
    dp they are whole, under fsdp_tp (tp=2) wq's are split by columns."""
    for _, info in ranks[1]:
        st = info["state"][name]
        assert st["param_type"] == st["moment_type"] == "DTensor"
        assert st["grad_type"] == "DTensor"
        full, local = st["wq_shape"], st["wq_moment_local_shape"]
        if name == "dp":
            assert local == full
        elif name == "fsdp":
            assert local == [full[0], full[1] // 2, full[2]]
            assert st["embed_moment_local_shape"] == [256, 32]
        else:
            assert local == [full[0], full[1], full[2] // 2]
            assert st["embed_moment_local_shape"] == [128, 64]
        assert st["eval_loss"] == pytest.approx(st["whole_loss"], abs=TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_grads_match_unsharded(ranks, name, variant):
    """loss_fn and its gradients on the mesh against the same weights
    unsharded, with fused_matmuls (under tp: the local column blocks of
    wq|wk|wv and w_gate|w_up concatenated) and with a sliding window (the
    windowed flash route on local heads)."""
    for _, info in ranks[1]:
        loss_diff, grad_diff = info["variants"][f"{name}/{variant}"]
        assert loss_diff <= TOL and grad_diff <= GRAD_TOL


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_init_equals_unsharded_init(ranks, name):
    for _, info in ranks[1]:
        assert info["init_equal"][name] is True
        assert info["init_local_lt_full"][name] is (name != "dp")


def test_sharded_jit_late_binding_and_rebind(ranks):
    for r, (_, info) in enumerate(ranks[1]):
        sj = info["sharded_jit"]
        assert sj["unbound_raises"] is True
        assert sj["local_shape_dp2"] == [2, 8]
        assert sj["out"] == [[float(8 * i + j) * 2 for j in range(8)]
                             for i in range(4)]
        assert sj["local_shape_after_rebind"] == [4, 8]
        assert sj["cache_entries"] == 1
        assert sj["plain_call"] == 3
        assert sj["mixed_specs_raise"] is True


def test_wrappers_reject_dtensor_and_uneven_mesh_raises(ranks):
    for _, info in ranks[1]:
        assert info["wrapper_errors"] == {
            "flash_attention": True, "flash_attention_fwd": True,
            "paged_attention": True, "paged_decode_attention_inplace": True}
        assert "dim 0 of shape (255, 64) is 255" in info["uneven_error"]
        assert info["mesh_axis_size_tp"] == 2


# --- a rank -----------------------------------------------------------------


def _rank_main(rank: int, d: Path) -> None:
    import functools

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor, Shard

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel import presets
    from ray_tpu_torch.parallel import sharding as tsh
    from ray_tpu_torch.parallel import train_step as ts

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=2)
    inputs = dict(np.load(d / "inputs.npz"))
    params = _unflat(inputs, "params")
    cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32,
                                        attn_impl="flash")
    arrays, info = {}, {"state": {}, "init_equal": {},
                        "init_local_lt_full": {}}
    meshes = {name: tmesh.build_mesh(tmesh.MeshSpec(**spec), device="cpu")
              for name, spec in MESHES.items()}

    def gather(tree):
        return ts._map(lambda t: t.full_tensor().detach().numpy(), tree)

    for name, masked in CASES:
        mesh, rules = meshes[name], getattr(tsh.ShardingRules, name)()
        init, state_sh = ts.make_train_state_init(
            lambda g: llama.params_from_jax(params, "cpu"),
            ts.adamw(3e-4, weight_decay=0.01), mesh, rules,
            llama.param_specs(cfg), device="cpu")
        assert isinstance(state_sh, ts.TrainState)
        state = init(0)

        def loss(p, b, mesh=mesh, rules=rules):
            return llama.loss_fn(p, b, cfg, mesh=mesh, rules=rules)

        step = ts.make_train_step(loss, mesh=mesh, rules=rules,
                                  state_shardings=state_sh)
        batch = {k: torch.from_numpy(v) for k, v in _batch(masked).items()}
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            assert not isinstance(m["loss"], DTensor)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        key = _case_key(name, masked)
        arrays[f"{key}/metrics"] = np.asarray(metrics)
        arrays.update(_flat(gather(state.params), f"{key}/params"))
        if not masked:
            wq = state.params["layers"]["wq"]
            emb = state.params["embed"]
            opt = state.opt_state.state
            ev = ts.make_eval_step(loss, mesh, rules, state_sh)(state, batch)
            with torch.no_grad():
                whole = llama.loss_fn(
                    ts._map(lambda t: t.full_tensor(), state.params), batch,
                    cfg)
            info["state"][name] = {
                "param_type": type(wq).__name__,
                "grad_type": type(wq.grad).__name__,
                "moment_type": type(opt[wq]["exp_avg"]).__name__,
                "wq_shape": list(wq.shape),
                "wq_moment_local_shape":
                    list(opt[wq]["exp_avg_sq"].to_local().shape),
                "embed_moment_local_shape":
                    list(opt[emb]["exp_avg"].to_local().shape),
                "eval_loss": float(ev), "whole_loss": float(whole)}

    # the loss and its gradients, sharded against unsharded, on variants
    info["variants"] = {}
    batch = {"tokens": torch.from_numpy(_batch(False)["tokens"])}
    for variant in VARIANTS:
        vcfg = cfg.replace(**({"fused_matmuls": True}
                              if variant == "fused_matmuls"
                              else {"sliding_window": 64}))
        whole = ts._map(lambda t: t.requires_grad_(True),
                        llama.params_from_jax(params, "cpu"))
        want = llama.loss_fn(whole, batch, vcfg)
        want.backward()
        for name, mesh in meshes.items():
            rules = getattr(tsh.ShardingRules, name)()
            sharded = ts._map(lambda t: t.requires_grad_(True),
                              tsh.shard_params(
                                  mesh, llama.params_from_jax(params, "cpu"),
                                  llama.param_specs(cfg), rules))
            got = llama.loss_fn(sharded, batch, vcfg, mesh=mesh, rules=rules)
            got.backward()
            grad_diff = max(
                float((a.grad.full_tensor() - b.grad).abs().max())
                for a, b in zip(ts._leaves(sharded), ts._leaves(whole)))
            info["variants"][f"{name}/{variant}"] = (
                abs(float(got) - float(want)), grad_diff)

    # (e) the sharded init, leaf by leaf, against the unsharded one
    want = llama.init_params(torch.Generator().manual_seed(0), cfg)
    for name, mesh in meshes.items():
        rules = getattr(tsh.ShardingRules, name)()
        init, _ = ts.make_train_state_init(
            functools.partial(llama.init_params, cfg=cfg),
            ts.adamw(3e-4), mesh, rules, llama.param_specs(cfg),
            device="cpu")
        got = init(0).params
        info["init_equal"][name] = all(
            torch.equal(a.full_tensor(), b) for a, b in
            zip(ts._leaves(got), ts._leaves(want)))
        info["init_local_lt_full"][name] = any(
            a.to_local().numel() < a.numel() for a in ts._leaves(got))

    # (g) sharded_jit
    sj = {}
    seen = []

    @presets.sharded_jit(in_specs=(tsh.PartitionSpec("dp"),),
                         out_specs=tsh.PartitionSpec("dp"))
    def double(x):
        seen.append(list(x.shape))
        return x * 2

    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    try:
        double(x)
        sj["unbound_raises"] = False
    except RuntimeError:
        sj["unbound_raises"] = True
    presets.set_default_mesh(meshes["dp"], tsh.ShardingRules.dp(),
                             tmesh.MeshSpec(dp=2))
    out = double(x)
    sj["local_shape_dp2"] = seen[-1]
    sj["out"] = out.full_tensor().tolist()
    presets.rebind_default_mesh(tmesh.MeshSpec(fsdp=2), device="cpu")
    double(x)
    sj["local_shape_after_rebind"] = seen[-1]
    sj["cache_entries"] = double.cache_info()["entries"]
    sj["plain_call"] = presets.sharded_jit(lambda a: a + 1)(2)
    try:
        presets.sharded_jit(in_specs=(tsh.PartitionSpec(),))
        sj["mixed_specs_raise"] = False
    except ValueError:
        sj["mixed_specs_raise"] = True
    info["sharded_jit"] = sj

    # kernel wrappers never read a DTensor's storage
    mesh = meshes["fsdp"]
    q = distribute_tensor(torch.zeros(2, 128, 4, 16), mesh,
                          [Shard(0) if n == "fsdp" else tsh.Replicate()
                           for n in mesh.mesh_dim_names])
    pool = torch.zeros(2, 3, 8, 16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    qd = distribute_tensor(torch.zeros(2, 4, 16), mesh,
                           [tsh.Replicate()] * 5)
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, q, q),
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, q, q),
        "paged_attention": lambda: pa.paged_attention(qd, pool, pool, table,
                                                      lens),
        "paged_decode_attention_inplace":
            lambda: pa.paged_decode_attention_inplace(
                qd, torch.zeros(2, 2, 16), torch.zeros(2, 2, 16), pool, pool,
                table, lens)}
    errors = {}
    for what, call in calls.items():
        try:
            call()
            errors[what] = False
        except TypeError as e:
            errors[what] = "DTensor" in str(e)
    info["wrapper_errors"] = errors
    try:
        tsh.shard_params(meshes["fsdp_tp"], {"embed": torch.zeros(255, 64)},
                         {"embed": ("vocab", "embed")},
                         tsh.ShardingRules.fsdp_tp())
        info["uneven_error"] = ""
    except ValueError as e:
        info["uneven_error"] = str(e)
    info["mesh_axis_size_tp"] = tmesh.mesh_axis_size(meshes["fsdp_tp"], "tp")

    np.savez(d / f"rank{rank}.npz", **arrays)
    (d / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(_rank_main)
