"""The ViT model (ray_tpu_torch/models/vit.py) and the model registry
(models/registry.py) against the JAX reference, mirroring
tests/test_models_vit.py, on the ``tiny`` preset in f32. Weights cross via
``params_from_jax``.

- ``patchify`` equals JAX's (and a constant-per-patch image patchifies to
  constant rows);
- ``forward``, ``loss_fn``, every gradient and ``predict_fn`` within TOL,
  with remat off and on;
- sharded training on 4 gloo ranks (dp2 x tp2 under
  ``ShardingRules.fsdp_tp().with_(embed=None)``): 3 AdamW steps against
  JAX's make_train_step on the same 4-device mesh (losses and grad norms
  within TRAJ_TOL, params by test_torch_parallel_train.py's PARAM rule);
- the registry's families, ``get`` and its KeyError texts;
- JAX's batch inference over a Dataset, on the port's data layer (slow,
  as the reference's).

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
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch.models import registry, vit
from ray_tpu_torch.parallel import train_step as ts

# f32, the same products summed in another order
TOL = 1e-5
# 3 AdamW steps: losses and grad norms (test_torch_train_step.py's bound)
TRAJ_TOL = 1e-4
# the sharded run's grad norms (20-31 on random images) are sums of squares
# taken in another order over 4 ranks: f32 rounding, ~1e-6 relative apart
GNORM_RTOL = 1e-5
STEPS = 3
WORLD = 4
RANK_TIMEOUT_S = 240


def _cfg(**kw):
    return vit.PRESETS["tiny"].replace(**{"remat": False,
                                          "dtype": torch.float32, **kw})


def _batch(n=8, seed=0, cfg=None):
    cfg = cfg or _cfg()
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.channels)).astype(
            np.float32),
        "labels": rng.integers(0, cfg.num_classes, n).astype(np.int32)}


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, numpy params) of the tiny ViT in f32."""
    jax = pytest.importorskip("jax")
    with jax_reference() as ref:
        jcfg = ref.vit.PRESETS["tiny"].replace(remat=False,
                                               dtype=jax.numpy.float32)
        params = jax_tree_to_np(ref.vit.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    return jcfg, params


def test_patchify_matches_jax_and_roundtrip(tiny):
    jcfg, _ = tiny
    cfg = _cfg()
    imgs = _batch(2)["images"]
    with jax_reference() as ref:
        want = np.asarray(ref.vit.patchify(imgs, jcfg))
    got = vit.patchify(torch.from_numpy(imgs), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    # a constant-per-patch image patchifies to constant rows (the
    # reference test's layout check)
    n = cfg.image_size // cfg.patch_size
    img = torch.arange(n * n, dtype=torch.float32).reshape(1, n, 1, n, 1, 1)
    img = img.expand(1, n, cfg.patch_size, n, cfg.patch_size,
                     cfg.channels).reshape(1, cfg.image_size,
                                           cfg.image_size, cfg.channels)
    patches = vit.patchify(img, cfg)
    assert patches.shape == (1, cfg.num_patches, cfg.patch_dim)
    assert float(patches.std(-1).max()) == 0.0
    assert patches[0, :, 0].tolist() == list(range(n * n))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_grads_predict_match_jax(tiny, remat):
    import jax

    jcfg, params = tiny
    jcfg, cfg = jcfg.replace(remat=remat), _cfg(remat=remat)
    batch = _batch()
    with jax_reference() as ref:
        jp = jax.tree.map(jax.numpy.asarray, params)
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        logits = ref.vit.forward(jp, jb["images"], jcfg)
        loss, grads = jax.value_and_grad(ref.vit.loss_fn)(jp, jb, jcfg)
        pred = ref.vit.predict_fn(jp, jb["images"], jcfg)
    tp = ts._map(lambda t: t.requires_grad_(True),
                 vit.params_from_jax(params, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = vit.forward(tp, tb["images"], cfg)
    assert tl.shape == (8, cfg.num_classes)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(logits),
                               atol=TOL, rtol=0)
    tloss = vit.loss_fn(tp, tb, cfg)
    assert abs(float(tloss.detach()) - float(loss)) <= TOL
    tloss.backward()
    want = flat(jax_tree_to_np(grads))
    got = flat(ts._map(lambda t: t.grad.numpy(), tp))
    assert got.keys() == want.keys() and len(got) == 20
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)
    with torch.no_grad():
        np.testing.assert_array_equal(
            vit.predict_fn(tp, tb["images"], cfg).numpy(), np.asarray(pred))


def test_init_and_specs_match_jax_layout(tiny):
    _, params = tiny
    cfg = _cfg()
    got = vit.init_params(torch.Generator().manual_seed(0), cfg)
    assert flat(ts._map(lambda t: tuple(t.shape), got)) == flat(
        {k: (v.shape if not isinstance(v, dict) else
             {kk: vv.shape for kk, vv in v.items()})
         for k, v in params.items()})
    assert float(got["patch_b"].abs().sum()) == 0.0
    assert float(got["layers"]["ln1_g"].min()) == 1.0
    with jax_reference() as ref:
        assert ref.vit.param_specs(ref.vit.PRESETS["tiny"]) == \
            vit.param_specs(cfg)
    assert vit.num_params(cfg) == sum(v.numel() for v in ts._leaves(got))
    base = vit.PRESETS["base"]
    assert (base.image_size, base.patch_size, base.d_model,
            base.n_layers) == (224, 16, 768, 12)
    assert 86.0e6 < vit.num_params(base) < 86.9e6


def test_registry_matches_jax():
    with jax_reference() as ref:
        fams = ref.registry.families()
        errors = []
        for fam, preset in (("bert", "tiny"), ("vit", "giant")):
            with pytest.raises(KeyError) as e:
                ref.registry.get(fam, preset)
            errors.append(str(e.value))
        jcfg, jmod = ref.registry.get("vit", "tiny")
    assert registry.families() == fams == ["gpt2", "llama", "moe", "vit"]
    for (fam, preset), want in zip((("bert", "tiny"), ("vit", "giant")),
                                   errors):
        with pytest.raises(KeyError) as e:
            registry.get(fam, preset)
        assert str(e.value) == want
    cfg, mod = registry.get("vit", "tiny")
    assert cfg.num_classes == jcfg.num_classes == 10
    assert mod is vit and hasattr(mod, "predict_fn")
    for fam in registry.families():
        cfg, mod = registry.get(fam, "tiny")
        assert mod.__name__ == f"ray_tpu_torch.models.{fam}"
        for fn in ("init_params", "forward", "loss_fn", "param_specs"):
            assert callable(getattr(mod, fn)), (fam, fn)


# --- sharded training on 4 ranks ------------------------------------------------


@pytest.fixture(scope="module")
def sharded(tiny, tmp_path_factory):
    import jax
    import optax

    jcfg, params = tiny
    d = tmp_path_factory.mktemp("vit_sharded")
    batch = _batch(8)
    np.savez(d / "inputs.npz", **batch, **flat(params, "params"))
    with jax_reference() as ref:
        mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(dp=2, tp=2),
                                   devices=jax.devices()[:WORLD])
        rules = ref.sharding.ShardingRules.fsdp_tp().with_(embed=None)
        opt = optax.adamw(3e-4, weight_decay=0.01)
        jp = jax.tree.map(jax.numpy.asarray, params)
        init_fn, state_sh = ref.train_step.make_train_state_init(
            lambda k: jp, opt, mesh, rules, ref.vit.param_specs(jcfg))
        state = init_fn(jax.random.PRNGKey(0))
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        step = ref.train_step.make_train_step(
            lambda p, b: ref.vit.loss_fn(p, b, jcfg), opt, mesh, rules,
            state_sh, batch_shapes=jax.eval_shape(lambda: jb))
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        expected = {"metrics": np.asarray(metrics),
                    **flat(jax_tree_to_np(state.params), "params")}
    # the reference first: the ranks' budget is their own time
    return expected, Ranks(Path(__file__), d, WORLD, RANK_TIMEOUT_S).run()


def test_sharded_training_matches_jax(sharded):
    expected, results = sharded
    wp = {k: v for k, v in expected.items() if k.startswith("params/")}
    for arrays, info in results:
        got = arrays["metrics"]
        np.testing.assert_allclose(got[:, 0], expected["metrics"][:, 0],
                                   atol=TRAJ_TOL, rtol=0)
        np.testing.assert_allclose(got[:, 1], expected["metrics"][:, 1],
                                   atol=0, rtol=GNORM_RTOL)
        assert got[-1, 0] < got[0, 0]
        gp = {k: v for k, v in arrays.items() if k.startswith("params/")}
        assert gp.keys() == wp.keys() and len(gp) == 20
        for k in wp:
            d = np.abs(gp[k] - wp[k])
            assert d.max() <= PARAM_MAX, (k, d.max())
            far = d > PARAM_TOL
            if k == "params/layers/bqkv":
                # the key bias: q.b_k shifts every score of a row alike, so
                # its gradient is 0 in exact arithmetic and rounding noise
                # (~1e-9) in both; AdamW turns that noise into steps of
                # +-lr, held by PARAM_MAX alone
                D = far.shape[1] // 3
                far[:, D:2 * D] = False
            assert far.sum() <= max(1, PARAM_FAR_SHARE * d.size), (
                k, d.max(), np.argwhere(far)[:4])
        # each data rank computed 4 of the 8 images; w1's mlp columns rest
        # split over tp
        assert info["rows"] == 4
        assert info["w1_local"] == [2, 64, 64]


def _rank_main(rank: int, d: Path) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel.sharding import ShardingRules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=WORLD)
    inp = dict(np.load(d / "inputs.npz"))
    params = unflat(inp, "params")
    cfg = _cfg()
    mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=2, tp=2), device="cpu")
    rules = ShardingRules.fsdp_tp().with_(embed=None)
    init, state_sh = ts.make_train_state_init(
        lambda g: vit.params_from_jax(params, "cpu"),
        ts.adamw(3e-4, weight_decay=0.01), mesh, rules, vit.param_specs(cfg),
        device="cpu")
    state = init(0)
    rows = []

    def loss(p, b):
        rows.append(int(b["images"].to_local().shape[0]))
        return vit.loss_fn(p, b, cfg, mesh=mesh, rules=rules)

    step = ts.make_train_step(loss, mesh=mesh, rules=rules,
                              state_shardings=state_sh)
    batch = {k: torch.from_numpy(inp[k]) for k in ("images", "labels")}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    arrays = {"metrics": np.asarray(metrics),
              **flat(ts._map(lambda p: p.full_tensor().detach().numpy(),
                             state.params), "params")}
    info = {"rows": rows[0],
            "w1_local": list(state.params["layers"]["w1"].to_local().shape)}
    np.savez(d / f"rank{rank}.npz", **arrays)
    (d / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


# --- batch inference through the port's data layer ------------------------------


@pytest.mark.slow
def test_batch_inference_over_dataset(ray_start_regular):
    from ray_tpu_torch import data

    cfg = _cfg()
    params = vit.init_params(torch.Generator().manual_seed(0), cfg)
    imgs = np.random.default_rng(0).standard_normal(
        (16, cfg.image_size, cfg.image_size, cfg.channels)).astype(
        np.float32)
    ds = data.from_numpy({"images": imgs})

    def infer(batch):
        from ray_tpu_torch.models import vit as v

        with torch.no_grad():
            preds = v.predict_fn(params, torch.from_numpy(batch["images"]),
                                 cfg)
        return {"pred": preds.numpy()}

    out = ds.map_batches(infer, batch_size=8).take_all()
    assert len(out) == 16
    assert all(0 <= r["pred"] < cfg.num_classes for r in out)
    with torch.no_grad():
        want = vit.predict_fn(params, torch.from_numpy(imgs), cfg)
    assert sorted(int(r["pred"]) for r in out) == sorted(want.tolist())


# --- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_card_matches_cpu():
    """The tiny ViT in f32 (TF32 off), one init: logits, the loss and every
    gradient on the card against the CPU."""
    require_cuda()
    cfg = _cfg(remat=True)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _batch(8)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            p = ts._map(lambda t: t.to(dev, copy=True).requires_grad_(True),
                        params)
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss = vit.loss_fn(p, b, cfg)
            loss.backward()
            out[dev] = (float(loss), flat(ts._map(lambda t: to_np(t.grad),
                                                  p)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= TRAJ_TOL * abs(lh)
    for k in gh:
        np.testing.assert_allclose(gc[k], gh[k], atol=1e-4, rtol=0,
                                   err_msg=k)


if __name__ == "__main__":
    rank_main(_rank_main)
