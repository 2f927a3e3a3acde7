"""The sequence split under ``ShardingRules.full()`` (seq over sp), on 4
gloo ranks against JAX's 4-device meshes (``jax.devices()[:4]``), in f32
on the ``tiny`` presets.

The reference pins the Llama's [batch, seq, embed] activation to
``full()``'s sharding and GSPMD splits the sequence over sp through the
whole forward; the port computes each rank's chunk and gathers the
chunks' k and v (and q for flash) over sp in attention
(``llama._attention_seq``). The MoE's forward splits its sequence the same
way; the ViT's "seq" is the images' rows, which it gathers over sp before
it computes whole images. Each case is the model's ``loss_fn`` through
``make_train_step``, 3 AdamW steps, from the same carried params:

- Llama on two meshes (dp2 x sp2, tp2 x sp2) and three routes:
  ``attn_impl`` "xla" at S 32, "flash" at S 128 (the JAX side's Pallas
  kernels in interpret mode, the port's plain versions on the CPU) and
  "flash" under a 64-token sliding window (K2's route);
- the MoE on dp2 x sp2, "xla" at S 32 and "flash" at S 128;
- the ViT on dp2 x sp2;
- the Llama on pp2 x sp2 ("xla" at S 32), whose ``forward_pp`` computes
  whole sequences, gathered over sp.

Losses and grad norms within test_torch_parallel_train.py's TOL (the
ViT's grad norms within test_torch_vit.py's GNORM_RTOL), the params by
its PARAM rule (``test_torch_parallel_sp_pp._param_rule``; for the ViT,
test_torch_vit.py's form of it), as ``test_forward_sp_training_matches_
jax`` holds ``forward_sp``.

The ranks run this file as a script (``test_torch_support.Ranks``), once
per session in a module fixture; the parent writes the inputs and computes
the JAX reference first.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_parallel_sp_pp import _param_rule
from test_torch_parallel_train import (PARAM_FAR_SHARE, PARAM_MAX,
                                       PARAM_TOL, TOL)
from test_torch_support import Ranks, flat, jax_tree_to_np, jax_reference, \
    rank_main, unflat

WORLD = 4
RANK_TIMEOUT_S = 240
STEPS = 3
# the ViT's grad norms (test_torch_vit.py's GNORM_RTOL)
GNORM_RTOL = 1e-5
MESHES = {"dp2_sp2": {"dp": 2, "sp": 2}, "tp2_sp2": {"tp": 2, "sp": 2},
          "pp2_sp2": {"pp": 2, "sp": 2}}
# case: (model, mesh, attn_impl, sequence length, sliding window)
CASES = {
    **{f"llama/{m}/{r}": ("llama", m, impl, S, win)
       for m in ("dp2_sp2", "tp2_sp2")
       for r, (impl, S, win) in (("xla", ("xla", 32, None)),
                                 ("flash", ("flash", 128, None)),
                                 ("flash_w64", ("flash", 128, 64)))},
    "moe/dp2_sp2/xla": ("moe", "dp2_sp2", "xla", 32, None),
    "moe/dp2_sp2/flash": ("moe", "dp2_sp2", "flash", 128, None),
    "vit/dp2_sp2": ("vit", "dp2_sp2", None, None, None),
    "llama/pp2_sp2/xla": ("llama", "pp2_sp2", "xla", 32, None),
}
BATCH = 4
VIT_BATCH = 8
# the models' leaves
LEAVES = {"llama": 12, "moe": 13, "vit": 20}


def _inputs():
    """Each model's tiny weights (the port's init, as numpy), a token batch
    [BATCH, S + 1] for each sequence length and the ViT's images, from
    seeds."""
    import torch

    from ray_tpu_torch.models import llama, moe, vit

    out = {}
    for name, mod, kw in (("llama", llama, {}), ("moe", moe, {}),
                          ("vit", vit, {"remat": False})):
        cfg = mod.PRESETS["tiny"].replace(dtype=torch.float32, **kw)
        p = mod.init_params(torch.Generator().manual_seed(3), cfg)
        out.update(flat({k: (v.numpy() if not isinstance(v, dict) else
                             {kk: vv.numpy() for kk, vv in v.items()})
                         for k, v in p.items()}, f"params/{name}"))
    rng = np.random.default_rng(5)
    for S in sorted({c[3] for c in CASES.values() if c[3]}):
        out[f"tok{S}"] = rng.integers(0, 256, (BATCH, S + 1)).astype(
            np.int32)
    vcfg = vit.PRESETS["tiny"]
    out["images"] = rng.standard_normal(
        (VIT_BATCH, vcfg.image_size, vcfg.image_size, vcfg.channels)).astype(
        np.float32)
    out["labels"] = rng.integers(0, vcfg.num_classes, VIT_BATCH).astype(
        np.int32)
    return out


def _batch(inp, model, S):
    if model == "vit":
        return {"images": inp["images"], "labels": inp["labels"]}
    tok = inp[f"tok{S}"]
    return {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


def _jax_expected(inp):
    import jax
    import jax.numpy as jnp
    import optax

    out = {}
    devs = jax.devices()[:WORLD]
    with jax_reference() as ref:
        rules = ref.sharding.ShardingRules.full()
        for key, (model, mname, impl, S, win) in CASES.items():
            mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(**MESHES[mname]),
                                       devices=devs)
            mod = getattr(ref, model)
            if model == "vit":
                jcfg = mod.PRESETS["tiny"].replace(dtype=jnp.float32,
                                                   remat=False)
            else:
                jcfg = mod.PRESETS["tiny"].replace(
                    dtype=jnp.float32, attn_impl=impl, sliding_window=win)

            def loss(p, b, mod=mod, jcfg=jcfg, mesh=mesh, model=model):
                if model == "llama":
                    return mod.loss_fn(p, b, jcfg, mesh, rules)
                if model == "moe":
                    return mod.loss_fn(p, b, jcfg, mesh)
                return mod.loss_fn(p, b, jcfg)

            opt = optax.adamw(3e-4, weight_decay=0.01)
            jp = jax.tree.map(jnp.asarray, unflat(inp, f"params/{model}"))
            init_fn, state_sh = ref.train_step.make_train_state_init(
                lambda k, jp=jp: jp, opt, mesh, rules,
                mod.param_specs(jcfg))
            state = init_fn(jax.random.PRNGKey(0))
            jb = {k: jnp.asarray(v)
                  for k, v in _batch(inp, model, S).items()}
            step = ref.train_step.make_train_step(
                loss, opt, mesh, rules, state_sh,
                batch_shapes=jax.eval_shape(lambda jb=jb: jb))
            metrics = []
            for _ in range(STEPS):
                state, m = step(state, jb)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            out[f"{key}/metrics"] = np.asarray(metrics)
            out.update(flat(jax_tree_to_np(state.params), f"{key}/params"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(JAX's expected values, [(rank npz, rank json)])."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("parallel_seq")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    # the reference first: the ranks' budget is their own time
    expected = _jax_expected(inp)
    return expected, Ranks(Path(__file__), d, WORLD, RANK_TIMEOUT_S).run()


def _vit_params_held(got, want):
    """test_torch_vit.py's PARAM rule: the key bias's columns of bqkv (a
    gradient of 0 in exact arithmetic, whose rounding noise AdamW turns
    into steps of +-lr) held by PARAM_MAX alone."""
    assert got.keys() == want.keys() and len(got) == LEAVES["vit"]
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= PARAM_MAX, (k, d.max())
        far = d > PARAM_TOL
        if k.endswith("/layers/bqkv"):
            D = far.shape[1] // 3
            far[:, D:2 * D] = False
        assert far.sum() <= max(1, PARAM_FAR_SHARE * d.size), (
            k, d.max(), np.argwhere(far)[:4])


@pytest.mark.parametrize("case", list(CASES))
def test_seq_split_training_matches_jax(ranks, case):
    """``full()`` on the case's mesh through make_train_step: 3 AdamW
    steps against JAX's, and the chunks each rank held."""
    expected, results = ranks
    model, mname, impl, S, _ = CASES[case]
    want = expected[f"{case}/metrics"]
    wp = {k: v for k, v in expected.items()
          if k.startswith(f"{case}/params/")}
    rows = (VIT_BATCH if model == "vit" else BATCH) // MESHES[mname].get(
        "dp", 1)
    for arrays, info in results:
        got = arrays[f"{case}/metrics"]
        gp = {k: v for k, v in arrays.items()
              if k.startswith(f"{case}/params/")}
        assert got[-1, 0] < got[0, 0]
        seen = info["seen"][case]
        if model == "vit":
            np.testing.assert_allclose(got[:, 0], want[:, 0], atol=TOL,
                                       rtol=0)
            np.testing.assert_allclose(got[:, 1], want[:, 1], atol=0,
                                       rtol=GNORM_RTOL)
            _vit_params_held(gp, wp)
            # the batch as placed held 16 of the 32 image rows; the ViT
            # gathered them and attended whole images
            assert seen["batch"] == [rows, 16, 32, 3]
            continue
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        _param_rule(gp, wp, LEAVES[model])
        # each rank held S/sp tokens of its batch rows, and attention saw
        # its chunk of S/sp queries (under pp the whole sequence)
        assert seen["batch"] == [rows, S // 2]
        if "pp" in MESHES[mname]:
            assert seen["attention"] == []
            continue
        assert set(seen["attention"]) == {S // 2}
        # flash ran the whole gathered sequence (K1, or K2 under the
        # window, on the card); xla never reached the flash route
        assert set(seen["flash"]) == ({S} if impl == "flash" else set())


# --- a rank -----------------------------------------------------------------


def _rank_main(rank: int, d: Path) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama, moe, vit
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.sharding import ShardingRules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=WORLD)
    inp = dict(np.load(d / "inputs.npz"))
    arrays, info = {}, {"seen": {}}
    seen = {}

    # record the chunk each attention call computes and the sequence the
    # flash route runs (the functions are looked up at call time)
    attention_seq, flash = llama._attention_seq, fa.flash_attention

    def attention_spy(q, *args, **kwargs):
        seen["attention"].add(q.shape[1])
        return attention_seq(q, *args, **kwargs)

    def flash_spy(q, *args, **kwargs):
        seen["flash"].add(q.shape[1])
        return flash(q, *args, **kwargs)

    llama._attention_seq, fa.flash_attention = attention_spy, flash_spy
    rules = ShardingRules.full()
    meshes = {}
    mods = {"llama": llama, "moe": moe, "vit": vit}
    for key, (model, mname, impl, S, win) in CASES.items():
        if mname not in meshes:
            meshes[mname] = tmesh.build_mesh(tmesh.MeshSpec(**MESHES[mname]),
                                             device="cpu")
        m_, mod = meshes[mname], mods[model]
        if model == "vit":
            cfg = vit.PRESETS["tiny"].replace(dtype=torch.float32,
                                              remat=False)
        else:
            cfg = mod.PRESETS["tiny"].replace(
                dtype=torch.float32, attn_impl=impl, sliding_window=win)
        seen.clear()
        seen.update(attention=set(), flash=set(), batch=None)
        first = "images" if model == "vit" else "inputs"

        def loss(p, b, mod=mod, cfg=cfg, m_=m_, first=first):
            seen["batch"] = list(b[first].to_local().shape)
            return mod.loss_fn(p, b, cfg, mesh=m_, rules=rules)

        opt = ts.adamw(3e-4, weight_decay=0.01)
        init, state_sh = ts.make_train_state_init(
            lambda g, model=model, mod=mod: mod.params_from_jax(
                unflat(inp, f"params/{model}"), "cpu"),
            opt, m_, rules, mod.param_specs(cfg), device="cpu")
        state = init(0)
        step = ts.make_train_step(loss, mesh=m_, rules=rules,
                                  state_shardings=state_sh)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(inp, model, S).items()}
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        arrays[f"{key}/metrics"] = np.asarray(metrics)
        arrays.update(flat(ts._map(
            lambda p: p.full_tensor().detach().numpy(), state.params),
            f"{key}/params"))
        info["seen"][key] = {k: sorted(v) if isinstance(v, set) else v
                             for k, v in seen.items()}

    np.savez(d / f"rank{rank}.npz", **arrays)
    (d / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(_rank_main)
