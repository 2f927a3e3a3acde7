"""Parity of the port's mesh and sharding-rule vocabulary
(``ray_tpu_torch/parallel/{mesh,sharding}.py``) with ``ray_tpu``'s, with no
process group: ``MeshSpec.resolve`` over a table of specs and errors, the
PartitionSpec of every parameter of ``param_specs`` under every preset
(and the DTensor placements read from it), and ``hybrid_layout``'s rank
array against the device ids of JAX's ``build_hybrid_mesh`` on the 8
virtual CPU devices (tests/conftest.py). The multi-rank paths are in
tests/test_torch_parallel_train.py and tests/test_torch_parallel_engine.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_support import REPO, jax_reference

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh

PRESET_NAMES = ("dp", "fsdp", "fsdp_tp", "full", "ep")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _resolve(MeshSpec, sizes, n):
    try:
        return ("ok", MeshSpec(*sizes).resolve(n).sizes())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("sizes,n", [
    ((-1, 1, 1, 1, 1), 8), ((1, 1, -1, 1, 2), 8), ((2, 1, 2, 1, 2), 8),
    ((1, 2, -1, 1, 1), 4), ((1, 1, 1, 1, 1), 1), ((-1, 1, 1, 1, -1), 8),
    ((1, 1, -1, 1, 3), 8), ((2, 1, 1, 1, 1), 8), ((1, 1, 4, 1, 1), 2)])
def test_mesh_spec_resolve_matches_jax(jax, sizes, n):
    with jax_reference() as ref:
        want = _resolve(ref.mesh.MeshSpec, sizes, n)
    assert _resolve(tmesh.MeshSpec, sizes, n) == want
    assert tmesh.AXIS_ORDER == ("dp", "pp", "fsdp", "sp", "tp")
    assert tmesh.MeshSpec.data_parallel(4) == tmesh.MeshSpec(dp=4)
    assert tmesh.MeshSpec.fsdp_only().fsdp == -1


def _logical_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _logical_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_logical_to_mesh_matches_jax(jax, preset):
    """Every param_specs leaf (and the batch and activation specs) under
    `preset` on MeshSpec(dp=2, fsdp=2, tp=2): the same PartitionSpec as
    JAX's on an 8-device mesh of that shape, and one placement per mesh
    dim, Shard(d) exactly on the axes entry d names."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = llama.PRESETS["tiny"]
    specs = dict(_logical_leaves(llama.param_specs(cfg)))
    specs.update({"batch": ("batch",), "tokens": ("batch", "seq"),
                  "act": ("batch", "seq", None)})
    spec = tmesh.MeshSpec(dp=2, fsdp=2, tp=2)
    with jax_reference() as ref:
        jmesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(dp=2, fsdp=2, tp=2),
                                    devices=jax.devices()[:8])
        jrules = getattr(ref.sharding.ShardingRules, preset)()
        want = {k: tuple(ref.sharding.logical_to_mesh(v, jrules, jmesh))
                for k, v in specs.items()}
        unmeshed = {k: tuple(ref.sharding.logical_to_mesh(v, jrules))
                    for k, v in specs.items()}
    rules = getattr(tsh.ShardingRules, preset)()
    assert rules.as_dict() == jrules.as_dict()
    for k, v in specs.items():
        got = tsh.logical_to_mesh(v, rules, spec)
        assert isinstance(got, tsh.PartitionSpec)
        assert tuple(got) == want[k], k
        assert tuple(tsh.logical_to_mesh(v, rules)) == unmeshed[k], k
        pl = tsh.spec_placements(got, spec)
        for i, axis in enumerate(tmesh.AXIS_ORDER):
            dims = [d for d, e in enumerate(got) if e is not None and
                    axis in ((e,) if isinstance(e, str) else e)]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate()), \
                (k, axis)


def test_spec_placements_rejects_out_of_order_axes():
    spec = tmesh.MeshSpec(dp=2, fsdp=2)
    with pytest.raises(ValueError, match="mesh axis order"):
        tsh.spec_placements((("fsdp", "dp"),), spec)
    with pytest.raises(ValueError, match="shards two dims"):
        tsh.spec_placements(("dp", "dp"), spec)


@pytest.mark.parametrize("ici,dcn", [
    (dict(fsdp=2, tp=2), dict(dp=2)),
    (dict(dp=2, tp=2), dict(pp=2)),
    (dict(fsdp=-1), dict(dp=2, pp=2)),
    (dict(dp=2, fsdp=2), dict(dp=2)),
    (dict(pp=2, sp=2), dict(dp=2))])
def test_hybrid_layout_matches_jax_device_ids(jax, ici, dcn):
    with jax_reference() as ref:
        jm = ref.mesh.build_hybrid_mesh(ref.mesh.MeshSpec(**ici),
                                        ref.mesh.DCNSpec(**dcn),
                                        devices=jax.devices()[:8])
        want = np.vectorize(lambda d: d.id)(jm.devices)
        assert tuple(jm.axis_names) == tmesh.AXIS_ORDER
    got = tmesh.hybrid_layout(tmesh.MeshSpec(**ici), tmesh.DCNSpec(**dcn), 8)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_hybrid_layout_rejects_uneven_slices():
    with pytest.raises(ValueError, match="not divisible into 3 slices"):
        tmesh.hybrid_layout(tmesh.MeshSpec(fsdp=-1), tmesh.DCNSpec(dp=3), 8)
    assert not tmesh.has_physical_topology([object()])


def test_check_divisible_names_the_dims():
    cfg = llama.PRESETS["tiny"]
    sh = tsh.tree_shardings(tmesh.MeshSpec(tp=3), llama.param_specs(cfg),
                            tsh.ShardingRules.fsdp_tp())
    assert tuple(sh["embed"].spec) == ("tp",)
    with pytest.raises(ValueError, match=r"dim 0 of shape \(256, 64\) is "
                                         r"256.*\('tp',\) \(size 3\)"):
        tsh.check_divisible((256, 64), sh["embed"].spec, sh["embed"].mesh,
                            "embed")
    tsh.check_divisible((255, 64), sh["embed"].spec, sh["embed"].mesh)


def test_parallel_package_is_import_light():
    """Importing ray_tpu_torch.parallel imports none of its modules, no
    DTensor machinery and starts no process group; a name loads its module
    on first use."""
    code = (
        "import sys, ray_tpu_torch.parallel as P\n"
        "import torch.distributed as dist\n"
        "mods = sorted(k for k in sys.modules if k.startswith("
        "'ray_tpu_torch.parallel.'))\n"
        "print(mods, 'torch.distributed.tensor' in sys.modules, "
        "dist.is_initialized())\n"
        "print(P.MeshSpec(fsdp=-1).resolve(4).fsdp, P.ShardingRules.dp() "
        "== P.get_preset('dp').rules())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["[] False False", "4 True"]
