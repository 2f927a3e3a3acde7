"""The sharded LLMEngine (``mesh=``/``rules=``) on 2 gloo ranks, on the
``tiny`` preset in f32 with the JAX engine's own seeded weights.

As in tests/test_torch_parallel_train.py, the ranks run this file as a
script (``python tests/test_torch_parallel_engine.py RANK DIR``), once per
test session, joined by a ``file://`` store; they import no JAX. The
parent writes the JAX engine's float weights, JAX's int8 tree and the JAX
engines' tokens to ``DIR/inputs.npz`` / ``DIR/inputs.json``.

On each mesh of 2 ranks under ``ShardingRules.fsdp_tp()``, MeshSpec(tp=2)
and MeshSpec(fsdp=2):

- ``generate([1, 2, 3, 4, 5], max_new_tokens=6)`` in the paged and the
  contiguous layout, in f32 and with ``quantize="int8"``, gives the
  unsharded engines' tokens ([35, 235, 215, 5, 21, 5] in f32), and the
  JAX engine's on a 2-device mesh of the same shape;
- the int8 tree gathered back equals JAX's ``quantize_params_int8`` of the
  same weights (and the unsharded port's) bit for bit, and the weights
  rest in shards;
- an engine that draws its own weights (``params=None``, seed 0, f32 and
  int8) holds the unsharded engine's tree, gathered, bit for bit, and
  generates its tokens;
- a config whose dims the mesh does not divide raises, naming the dim.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_support import REPO, jax_reference, jax_tree_to_np

MESHES = {"tp2": dict(tp=2), "fsdp2": dict(fsdp=2)}
LAYOUTS = ("paged", "contiguous")
QUANTIZE = (None, "int8")
PROMPT = [1, 2, 3, 4, 5]
KNOWN = [35, 235, 215, 5, 21, 5]
RANK_TIMEOUT_S = 120


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


def _key(mesh, layout, quantize):
    return f"{mesh}/{layout}/{quantize or 'f32'}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax = pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("parallel_engine")
    meta = {"jax_tokens": {}, "jax_errors": {}}
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jax.numpy.float32)
        je = ref.llm.LLMEngine(cfg=jcfg, seed=0, page_size=16)
        params = jax_tree_to_np(je.params)
        # bf16 scales as f32 (exact): npz has no bfloat16
        jq = {k: v.astype(np.float32) if v.dtype.name == "bfloat16" else v
              for k, v in _flat(jax_tree_to_np(
                  ref.llama.quantize_params_int8(je.params))).items()}
        for mname, spec in MESHES.items():
            jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(**spec),
                                        devices=jax.devices()[:2])
            for layout in LAYOUTS:
                for q in QUANTIZE:
                    k = _key(mname, layout, q)
                    try:
                        eng = ref.llm.LLMEngine(
                            cfg=jcfg, params=je.params, seed=0,
                            page_size=16, kv_layout=layout, quantize=q,
                            mesh=jmesh,
                            rules=ref.sharding.ShardingRules.fsdp_tp())
                        meta["jax_tokens"][k] = eng.generate(
                            PROMPT, max_new_tokens=6)
                    except Exception as e:   # recorded and reported
                        meta["jax_errors"][k] = f"{type(e).__name__}: {e}"
    np.savez(d / "inputs.npz", **_flat(params, "params"),
             **{f"int8{k}": v for k, v in jq.items()})
    (d / "inputs.json").write_text(json.dumps(meta))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(d)], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return meta, [json.loads((d / f"rank{r}.json").read_text())
                  for r in range(2)]


@pytest.mark.parametrize("quantize", QUANTIZE)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_engine_tokens(ranks, mesh, layout, quantize):
    meta, results = ranks
    k = _key(mesh, layout, quantize)
    for info in results:
        got = info["tokens"][k]
        assert got == info["unsharded_tokens"][f"{layout}/"
                                               f"{quantize or 'f32'}"]
        if quantize is None:
            assert got == KNOWN
        if k in meta["jax_tokens"]:
            assert got == meta["jax_tokens"][k]
        assert info["rests_sharded"][k] is True


def test_jax_engine_runs_with_a_mesh(ranks):
    """Every sharded JAX engine ran on the 2 virtual devices, so every
    case above was also held against it."""
    meta, _ = ranks
    assert meta["jax_errors"] == {}
    assert len(meta["jax_tokens"]) == len(MESHES) * len(LAYOUTS) * 2


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_int8_tree_is_the_unsharded_one(ranks, mesh):
    for info in ranks[1]:
        assert info["int8_equal_jax"][mesh] is True
        assert info["int8_equal_port"][mesh] is True


@pytest.mark.parametrize("quantize", QUANTIZE)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_engine_own_init(ranks, mesh, quantize):
    for info in ranks[1]:
        r = info["own_init"][f"{mesh}/{quantize or 'f32'}"]
        assert r["tree_equal"] is True
        assert r["tokens"] == r["unsharded_tokens"]


def test_uneven_mesh_and_lone_rules_raise(ranks):
    for info in ranks[1]:
        assert "dim 0 of shape (255, 64) is 255" in info["uneven_error"]
        assert "together" in info["lone_mesh_error"]


# --- a rank -----------------------------------------------------------------


def _rank_main(rank: int, d: Path) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import is_dtensor
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel.sharding import ShardingRules, gathered
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=2)
    inputs = dict(np.load(d / "inputs.npz"))
    params = _unflat(inputs, "params")
    jq = _flat(_unflat(inputs, "int8"))
    cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32)
    rules = ShardingRules.fsdp_tp()
    info = {"tokens": {}, "unsharded_tokens": {}, "rests_sharded": {},
            "int8_equal_jax": {}, "int8_equal_port": {}, "own_init": {}}

    def whole(tree):
        return {k: gathered(v) for k, v in _flat(tree).items()}

    unsharded_q8 = None
    for layout in LAYOUTS:
        for q in QUANTIZE:
            eng = LLMEngine(cfg=cfg, params=llama.params_from_jax(
                params, "cpu"), kv_layout=layout, page_size=16,
                quantize=q, device="cpu")
            info["unsharded_tokens"][f"{layout}/{q or 'f32'}"] = \
                eng.generate(PROMPT, max_new_tokens=6)
            if q:
                unsharded_q8 = _flat(eng.params)
    meshes = {name: tmesh.build_mesh(tmesh.MeshSpec(**spec), device="cpu")
              for name, spec in MESHES.items()}
    for mname, mesh in meshes.items():
        for layout in LAYOUTS:
            for q in QUANTIZE:
                k = _key(mname, layout, q)
                eng = LLMEngine(cfg=cfg, params=llama.params_from_jax(
                    params, "cpu"), kv_layout=layout, page_size=16,
                    quantize=q, mesh=mesh, rules=rules, device="cpu")
                info["tokens"][k] = eng.generate(PROMPT, max_new_tokens=6)
                leaves = list(_flat(eng.params).values())
                info["rests_sharded"][k] = all(
                    is_dtensor(t) for t in leaves) and any(
                    t.to_local().numel() < t.numel() for t in leaves)
                if q:
                    got = whole(eng.params)
                    info["int8_equal_jax"][mname] = got.keys() == jq.keys() \
                        and all(np.array_equal(got[n].float().numpy()
                                               if got[n].is_floating_point()
                                               else got[n].numpy(), jq[n])
                                and got[n].dtype == unsharded_q8[n].dtype
                                for n in jq)
                    info["int8_equal_port"][mname] = all(
                        torch.equal(got[n], unsharded_q8[n]) for n in got)
        for q in QUANTIZE:
            ref_eng = LLMEngine(preset="tiny", seed=0, quantize=q,
                                device="cpu")
            eng = LLMEngine(preset="tiny", seed=0, quantize=q, mesh=mesh,
                            rules=rules, device="cpu")
            a, b = whole(eng.params), _flat(ref_eng.params)
            info["own_init"][f"{mname}/{q or 'f32'}"] = {
                "tree_equal": a.keys() == b.keys() and all(
                    torch.equal(a[n], b[n]) for n in a),
                "tokens": eng.generate(PROMPT, max_new_tokens=6),
                "unsharded_tokens": ref_eng.generate(PROMPT,
                                                     max_new_tokens=6)}
    try:
        LLMEngine(cfg=cfg.replace(vocab_size=255), mesh=meshes["tp2"],
                  rules=rules, device="cpu")
        info["uneven_error"] = ""
    except ValueError as e:
        info["uneven_error"] = str(e)
    try:
        LLMEngine(cfg=cfg, mesh=meshes["tp2"], device="cpu")
        info["lone_mesh_error"] = ""
    except ValueError as e:
        info["lone_mesh_error"] = str(e)
    (d / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
