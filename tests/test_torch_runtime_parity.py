"""The port's runtime leaves against the JAX package's, on the same inputs.

The reference modules load through ``test_torch_support.jax_reference()``
(``core/ids.py``, ``config.py``, ``serialization.py`` and
``scheduling_policy.py`` import nothing of ``core/rpc.py``); the port's are
``ray_tpu_torch.core.*``. Inputs come from seeded numpy generators.

- serialization: host values (nested dicts and lists of numpy f32/i8/bool
  arrays and strings) give the same meta bytes and buffers byte for byte;
  the same numbers as a jax array and as a torch tensor (f32, bf16, int32)
  deserialize to values equal bit for bit (numpy in the reference, a CPU
  tensor in the port);
- ids: equal derived IDs from equal parents and equal random bytes;
- scheduling_policy: equal node choices on the same cluster views;
- config: every default equal except ``chip_resource`` ("TPU" -> "GPU").
"""

from __future__ import annotations

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu_torch.core import config as port_config
from ray_tpu_torch.core import ids as port_ids
from ray_tpu_torch.core import scheduling_policy as port_sp
from ray_tpu_torch.core import serialization as port_ser
from ray_tpu_torch.core.common import ResourceSet as PortResourceSet
from test_torch_support import jax_reference


def _host_values(seed):
    rng = np.random.default_rng(seed)
    return [
        {"w": rng.standard_normal((7, 5)).astype(np.float32),
         "q": rng.integers(-128, 128, size=(33,), dtype=np.int8),
         "mask": rng.random((4, 4)) > 0.5,
         "name": "layer-0", "step": 12},
        [rng.standard_normal(1000).astype(np.float32), "x",
         [rng.integers(-5, 5, size=(2, 3), dtype=np.int8), ["nested", 1.5]]],
        {"empty": np.zeros((0, 3), np.float32), "scalar": np.float32(2.5),
         "strs": ["a", "bb", "ccc"], "none": None},
    ]


@pytest.mark.parametrize("case", range(3))
def test_host_values_serialize_byte_for_byte(case):
    value = _host_values(case)[case]
    with jax_reference() as ref:
        meta_r, bufs_r = ref.serialization.serialize(value)
        packed_r = ref.serialization.pack(value)
    meta_p, bufs_p = port_ser.serialize(value)
    assert meta_p == meta_r
    assert [bytes(b) for b in bufs_p] == [bytes(b) for b in bufs_r]
    assert port_ser.pack(value) == packed_r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_jax_array_and_tensor_deserialize_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    if dtype == "int32":
        base = rng.integers(-2**31, 2**31 - 1, size=(3, 17), dtype=np.int32)
    else:
        base = (rng.standard_normal((3, 17)) * 100).astype(np.float32)
    with jax_reference() as ref:
        arr = jnp.asarray(base).astype(getattr(jnp, dtype))
        out_r = ref.serialization.unpack(ref.serialization.pack(arr))
    t = torch.from_numpy(base).to(getattr(torch, dtype))
    meta, bufs = port_ser.serialize(t)
    assert len(bufs) == 1 and bufs[0].nbytes == t.numel() * t.element_size()
    out_p = port_ser.unpack(port_ser.pack(t))
    assert isinstance(out_r, np.ndarray) and isinstance(out_p, torch.Tensor)
    assert out_p.device.type == "cpu" and out_p.dtype == t.dtype
    assert tuple(out_p.shape) == out_r.shape
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert out_p.view(bits).numpy().tobytes() == out_r.tobytes()


def test_tensor_get_owns_its_bytes():
    """The module's read-only rule: a tensor read from a (read-only) store
    mapping is a copy the caller may write in place."""
    t = torch.arange(64, dtype=torch.float32)
    blob = port_ser.pack({"t": t})
    view = memoryview(blob)        # bytes: a read-only buffer, as the shm is
    out = port_ser.read_from(view)["t"]
    out.add_(1)                    # would fault or corrupt if it aliased
    assert torch.equal(port_ser.unpack(blob)["t"], t)
    assert torch.equal(out, t + 1)


def _urandom_from(seed):
    rng = random.Random(seed)
    return lambda n: bytes(rng.getrandbits(8) for _ in range(n))


def _derive(ids_mod):
    job = ids_mod.JobID.from_hex("0a0b0c0d")
    actor = ids_mod.ActorID.of(job)
    task = ids_mod.TaskID.of(actor)
    drv = ids_mod.TaskID.for_driver(job)
    rets = [ids_mod.ObjectID.for_return(task, i) for i in (0, 1, 7, 2**20)]
    puts = [ids_mod.ObjectID.for_put(drv, i) for i in (0, 3, 2**30)]
    return {"actor": actor.hex(), "actor_job": actor.job_id().hex(),
            "task": task.hex(), "task_actor": task.actor_id().hex(),
            "task_job": task.job_id().hex(), "driver": drv.hex(),
            "driver_job": drv.job_id().hex(),
            "rets": [(o.hex(), o.task_id().hex(), o.return_index(),
                      o.is_put()) for o in rets],
            "puts": [(o.hex(), o.task_id().hex(), o.return_index(),
                      o.is_put()) for o in puts],
            "nil": ids_mod.NodeID.nil().hex(),
            "sizes": [c.SIZE for c in (ids_mod.NodeID, ids_mod.WorkerID,
                                       ids_mod.PlacementGroupID,
                                       ids_mod.JobID, ids_mod.ActorID,
                                       ids_mod.TaskID, ids_mod.ObjectID)]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derived_ids_equal(seed, monkeypatch):
    with jax_reference() as ref:
        monkeypatch.setattr(os, "urandom", _urandom_from(seed))
        want = _derive(ref.ids)
    monkeypatch.setattr(os, "urandom", _urandom_from(seed))
    assert _derive(port_ids) == want


def _views(seed, n_nodes=6):
    """A random cluster view: node ids, totals, availability, liveness."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_nodes):
        total = {"CPU": float(rng.integers(1, 9)),
                 "memory": float(rng.integers(1, 5)) * 1e9}
        if rng.random() < 0.5:
            total["ACC"] = float(rng.integers(1, 5))
        avail = {k: float(np.floor(v * rng.random())) if k != "memory"
                 else v * rng.random() for k, v in total.items()}
        out.append((f"{rng.integers(0, 2**62):016x}{i}", total, avail,
                    bool(rng.random() > 0.1)))
    return out


def _requests(seed):
    rng = np.random.default_rng(seed + 100)
    reqs = []
    for _ in range(8):
        r = {"CPU": float(rng.integers(0, 4))}
        if rng.random() < 0.4:
            r["ACC"] = float(rng.integers(1, 3))
        reqs.append(r)
    return reqs


def _decisions(sp, RS, seed):
    nodes = [sp.SchedNode(node_id=nid, total=RS(dict(t)),
                          available=RS(dict(a)), alive=alive)
             for nid, t, a, alive in _views(seed)]
    reqs = [RS(dict(r)) for r in _requests(seed)]
    out = []
    for pol in (sp.HybridPolicy(seed=seed), sp.SpreadPolicy(),
                sp.RandomPolicy(seed=seed),
                sp.NodeAffinityPolicy(nodes[1].node_id, soft=True)):
        for i, r in enumerate(reqs):
            out.append(pol.schedule(r, nodes))
            if isinstance(pol, sp.HybridPolicy):
                out.append(pol.schedule(
                    r, nodes, preferred_node_id=nodes[i % 6].node_id,
                    require_node_available=False))
    out.append([round(sp.critical_utilization(n), 12) for n in nodes])
    for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        out.append(sp.pack_bundles(reqs[:3], nodes, strategy))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_scheduling_decisions_equal(seed):
    with jax_reference() as ref:
        want = _decisions(ref.scheduling_policy, ref.common.ResourceSet,
                          seed)
    assert _decisions(port_sp, PortResourceSet, seed) == want


def _defaults(cfg_cls):
    out = {}
    for f in dataclasses.fields(cfg_cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


def test_config_defaults_equal_but_chip_resource():
    with jax_reference() as ref:
        want = _defaults(ref.config.Config)
    got = _defaults(port_config.Config)
    assert list(got) == list(want)
    assert want.pop("chip_resource") == "TPU"
    assert got.pop("chip_resource") == "GPU"
    assert got == want
