"""Checkpoint layer: DCP-backed sharded save/restore + URI storage tier.

Port of tests/test_train_checkpoint.py, aimed at ray_tpu_torch, where
orbax is ``torch.distributed.checkpoint`` (DCP): the 8-device
NamedSharding roundtrip is a DTensor on a one-rank gloo mesh (restored
with its placements); the true 2-process save is 2 gloo ranks, each
writing only its shards of a DTensor and restoring them sharded (the
multi-process branch of ``from_state``); the fsspec URI tier is
unchanged (memory:// in tests, same code path as gs:// s3://), and the
trainer's failure restart resumes through a URI storage_path. Added: a
round trip of a tree mixing tensors (f32, bf16, int, an optimizer's
state_dict) with non-tensor leaves, an async save, the commit rule (a
save killed half-way is never returned by ``CheckpointManager.latest()``,
and two ranks without a common filesystem each commit their own shards),
and, on the card, CUDA tensors that come back on CUDA.
"""

import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_support import REPO, require_cuda
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch.train import storage
from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                            _complete)


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group and its CPU mesh (dp, fsdp, ... all 1),
    destroyed after the test: xdist runs other files in this process."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh

    assert not dist.is_initialized()
    try:
        yield local_mesh(MeshSpec(dp=-1), device="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_roundtrip(tmp_path, one_rank_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.sharding import spec_placements

    mesh = one_rank_mesh
    sh = spec_placements(("dp", "tp"), mesh)
    repl = tuple(Replicate() for _ in range(mesh.ndim))
    assert any(isinstance(p, Shard) for p in sh)
    x = DTensor.from_local(torch.arange(64, dtype=torch.float32)
                           .reshape(8, 8), mesh, sh)
    state = {"params": {"w": x, "b": DTensor.from_local(torch.ones(8), mesh,
                                                         repl)},
             "step": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))

    r = ck.load_state(state)
    assert isinstance(r["params"]["w"], DTensor)
    assert tuple(r["params"]["w"].placements) == tuple(sh)
    assert tuple(r["params"]["b"].placements) == repl
    assert torch.equal(r["params"]["w"].full_tensor(), x.full_tensor())
    assert r["params"]["w"] is not x       # loaded into new tensors
    assert int(r["step"]) == 7


def test_nonarray_leaves_and_host_restore(tmp_path):
    state = {"w": torch.arange(4.0), "name": "run1", "fn": len}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))
    r = ck.load_state()
    assert r["name"] == "run1" and r["fn"] is len
    assert np.allclose(r["w"].numpy(), np.arange(4.0))


def test_mixed_tree_roundtrip(tmp_path):
    """Tensors of several dtypes (bf16, int64, a 0-d step), an optimizer's
    state_dict (int keys, tuples, floats, None) and non-tensor leaves
    (numpy, str, int) come back with their values, dtypes and tree."""
    w = torch.randn(5, 3, requires_grad=True)
    opt = torch.optim.AdamW([w], lr=0.1)
    w.grad = torch.ones_like(w)
    opt.step()
    state = {"params": {"w": w, "h": torch.randn(4).to(torch.bfloat16)},
             "ids": torch.arange(6), "opt": opt.state_dict(),
             "meta": ("tag", 3, np.arange(3, dtype=np.int16)), "none": None}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))
    assert sorted(os.listdir(ck.path)) == ["arrays", "aux.pkl"]
    r = ck.load_state()
    assert torch.equal(r["params"]["w"], w.detach())
    assert r["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(r["params"]["h"], state["params"]["h"])
    assert torch.equal(r["ids"], torch.arange(6))
    assert r["meta"][:2] == ("tag", 3) and r["meta"][2].dtype == np.int16
    assert r["none"] is None
    opt2 = torch.optim.AdamW([torch.zeros(5, 3, requires_grad=True)],
                             lr=0.5)
    opt2.load_state_dict(r["opt"])
    assert opt2.param_groups[0]["lr"] == 0.1
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(opt2.state[opt2.param_groups[0]["params"][0]][k],
                           opt.state[w][k])


def test_async_save_commits_on_wait(tmp_path):
    state = {"w": torch.arange(16.0).reshape(4, 4), "step": 2}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"), async_save=True)
    ck.wait()
    assert _complete(ck.path)
    assert not os.path.exists(os.path.join(ck.path, "arrays.tmp"))
    r = ck.load_state()
    assert r["step"] == 2 and torch.equal(r["w"], state["w"])


_KILLED_SAVE = textwrap.dedent("""
    import os, signal, sys
    import torch
    import torch.distributed.checkpoint as dcp
    from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager

    mgr = CheckpointManager(sys.argv[1])
    p0 = mgr.new_dir()
    Checkpoint.from_state({"w": torch.zeros(256, 256), "step": 0}, p0)
    mgr.register(p0)
    write = dcp.FileSystemWriter.write_data

    def write_then_die(self, plan, planner):
        fut = write(self, plan, planner)
        fut.wait()                 # the tensor bytes are on disk ...
        print("killed mid-save", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)   # ... the commit never runs

    dcp.FileSystemWriter.write_data = write_then_die
    p1 = mgr.new_dir()
    Checkpoint.from_state({"w": torch.ones(256, 256), "step": 1}, p1)
""")


def test_killed_save_is_never_latest(tmp_path):
    """The commit rule: a process SIGKILLed half-way through a DCP save
    (its tensor data written, the metadata and the rename to ``arrays``
    not) leaves ``arrays.tmp`` beside its aux.pkl; ``_complete`` rejects
    it and ``latest()`` returns the older, whole checkpoint."""
    run_dir = tmp_path / "run"
    script = tmp_path / "kill.py"
    script.write_text(_KILLED_SAVE)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, str(script), str(run_dir)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -9, proc.stdout + proc.stderr
    assert "killed mid-save" in proc.stdout
    half = run_dir / "checkpoint_000001"
    assert sorted(os.listdir(half)) == ["arrays.tmp", "aux.pkl"]
    assert any(f.endswith(".distcp") for f in os.listdir(half / "arrays.tmp"))
    assert not _complete(str(half))
    latest = CheckpointManager(str(run_dir)).latest()
    assert latest is not None
    assert latest.path.endswith("checkpoint_000000")
    r = latest.load_state()
    assert r["step"] == 0 and torch.equal(r["w"], torch.zeros(256, 256))


def test_uri_roundtrip(tmp_path):
    state = {"w": torch.arange(8.0), "step": torch.tensor(2)}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))
    uri = "memory://ckpt-test-torch/roundtrip"
    ck.to_uri(uri)
    back = Checkpoint.from_uri(uri, local_dir=str(tmp_path / "back"))
    r = back.load_state()
    assert int(r["step"]) == 2
    assert np.allclose(r["w"].numpy(), np.arange(8.0))
    storage.delete_at_uri(uri)
    assert not storage.exists_at_uri(uri)


def test_manager_uri_eviction_and_fresh_node_resume():
    uri = "memory://ckpt-test-torch/mgr"
    storage.delete_at_uri(uri)
    shutil.rmtree(storage.local_staging_dir(uri), ignore_errors=True)
    mgr = CheckpointManager(uri, num_to_keep=2)
    for i in range(3):
        p = mgr.new_dir()
        Checkpoint.from_state({"step": torch.tensor(i)}, p)
        mgr.register(p)
    # num_to_keep evicted the oldest both locally and remotely
    assert storage.list_at_uri(uri) == ["checkpoint_000001",
                                        "checkpoint_000002"]
    # fresh node: local staging wiped, manager resumes from the URI
    shutil.rmtree(mgr.run_dir)
    mgr2 = CheckpointManager(uri, num_to_keep=2)
    latest = mgr2.latest()
    assert latest is not None and int(latest.load_state()["step"]) == 2
    assert mgr2.new_dir().endswith("checkpoint_000003")
    storage.delete_at_uri(uri)


def test_scalar_leaf_with_abstract_target(tmp_path):
    """Python-scalar leaves (int step counters) restore with a target
    tree: they ride aux.pkl, the tensors load into the target's
    allocation."""
    state = {"w": torch.arange(4.0), "step": 3}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))
    r = ck.load_state({"w": torch.zeros(4), "step": 0})
    assert int(r["step"]) == 3
    assert np.allclose(r["w"].numpy(), np.arange(4.0))
    with pytest.raises(ValueError, match="leaves"):
        ck.load_state({"w": torch.zeros(4)})


def test_pickled_checkpoint_redownloads_from_uri(tmp_path):
    """A pickled Checkpoint carries its URI; unpickling where the local
    path does not exist re-downloads (a worker restarted on another node
    resuming from cloud storage)."""
    state = {"step": torch.tensor(9)}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))
    uri = "memory://ckpt-test-torch/xnode"
    ck.to_uri(uri)
    blob = pickle.dumps(ck)
    shutil.rmtree(ck.path)  # "other node": local path gone
    ck2 = pickle.loads(blob)
    assert int(ck2.load_state()["step"]) == 9
    storage.delete_at_uri(uri)


def test_manager_partial_staging_falls_back_to_remote():
    """A half-written local checkpoint (crash mid-save) is not trusted:
    latest() re-downloads the complete remote copy."""
    uri = "memory://ckpt-test-torch/partial"
    storage.delete_at_uri(uri)
    shutil.rmtree(storage.local_staging_dir(uri), ignore_errors=True)
    mgr = CheckpointManager(uri, num_to_keep=None)
    p = mgr.new_dir()
    Checkpoint.from_state({"w": torch.arange(4.0),
                           "step": torch.tensor(1)}, p)
    mgr.register(p)
    # simulate a crash mid-save: aux.pkl present, DCP arrays dir gone
    shutil.rmtree(os.path.join(p, "arrays"))
    assert os.path.exists(os.path.join(p, "aux.pkl"))
    mgr2 = CheckpointManager(uri, num_to_keep=None)
    latest = mgr2.latest()
    assert latest is not None
    assert int(latest.load_state()["step"]) == 1  # came back from the URI
    storage.delete_at_uri(uri)


def test_manager_unmarked_remote_falls_back_to_older(tmp_path):
    """A remote mirror without the completion marker (crash mid-upload) is
    never restored from; latest() returns the older complete checkpoint."""
    uri = "memory://ckpt-test-torch/unmarked"
    storage.delete_at_uri(uri)
    shutil.rmtree(storage.local_staging_dir(uri), ignore_errors=True)
    mgr = CheckpointManager(uri)
    p0 = mgr.new_dir()
    Checkpoint.from_state({"step": torch.tensor(0)}, p0)
    mgr.register(p0)
    # a later "crashed" upload: files present remotely, marker missing
    p1 = mgr.new_dir()
    Checkpoint.from_state({"step": torch.tensor(1)}, p1)
    Checkpoint(p1).to_uri(storage.join_uri(uri, os.path.basename(p1)),
                          write_marker=False)
    mgr._kept.append(p1)
    shutil.rmtree(p1)  # local gone too: only the partial remote remains
    latest = mgr.latest()
    assert latest is not None
    assert int(latest.load_state()["step"]) == 0
    # stray download temps + marker files never break a resuming manager
    os.makedirs(os.path.join(mgr.run_dir, ".dl-checkpoint_000001-123"),
                exist_ok=True)
    mgr2 = CheckpointManager(uri)
    assert mgr2.new_dir().endswith("checkpoint_000002")
    storage.delete_at_uri(uri)


def test_storage_helpers(tmp_path):
    assert storage.is_uri("gs://b/p") and storage.is_uri("memory://x")
    assert not storage.is_uri("/tmp/x") and not storage.is_uri(None)
    assert not storage.is_uri("relative/path")
    # file:// URIs hit the same code path as cloud schemes
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("A")
    (src / "sub" / "b.txt").write_text("B")
    uri = f"file://{tmp_path}/dst"
    storage.upload_to_uri(str(src), uri)
    assert sorted(storage.list_at_uri(uri)) == ["a.txt", "sub"]
    storage.download_from_uri(uri, str(tmp_path / "out"))
    assert (tmp_path / "out" / "sub" / "b.txt").read_text() == "B"
    storage.delete_at_uri(uri)
    assert storage.list_at_uri(uri) == []


def _uri_loop(config):
    import torch

    from ray_tpu_torch.train import session

    ck = session.get_checkpoint()
    start = 0
    if ck is not None:
        start = int(ck.load_state(None)["step"])
    w = torch.arange(4.0) + start
    for i in range(start, config["steps"]):
        w = w + 1.0
        session.report({"step": i, "w0": float(w[0])},
                       state={"step": i + 1, "w": w})
        if config.get("die_at") == i and ck is None:
            os._exit(1)
    return {"done": True}


def test_trainer_uri_storage_path_crash_resume(ray_start_regular, tmp_path):
    """RunConfig.storage_path as a URI: checkpoints mirror to remote
    storage and a crashed worker group resumes from it (ref: air
    RunConfig.storage_path cloud URIs + FailureConfig)."""
    from ray_tpu_torch.train import (DataParallelTrainer, FailureConfig,
                                     RunConfig, ScalingConfig)

    uri = f"file://{tmp_path}/remote"
    trainer = DataParallelTrainer(
        _uri_loop, train_loop_config={"steps": 5, "die_at": 2},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="urirun", storage_path=uri,
                             failure_config=FailureConfig(max_failures=2)))
    result = trainer.fit()
    assert result.ok, result.error
    assert result.metrics["step"] == 4
    # checkpoints landed at the remote URI
    run_uri = f"{uri}/urirun"
    names = [n for n in storage.list_at_uri(run_uri)
             if n.startswith("checkpoint_")]
    assert names, storage.list_at_uri(run_uri)
    assert result.checkpoint is not None
    assert int(result.checkpoint.load_state(None)["step"]) == 5


def _collective_loop(config):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import spec_placements
    from ray_tpu_torch.train import session

    # 2 workers = one 2-rank gloo group (ProcessGroupBackend); the mesh
    # over it is the session's (dp = 2)
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    mesh = session.get_mesh("cpu")
    rank = session.world_rank()
    # the device is the group's: the CPU under gloo, another one refused
    assert session.get_device("cpu").type == "cpu"
    try:
        session.get_device("meta")
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    local = torch.stack([torch.full((2,), float(rank * 8 + i))
                         for i in range(8)])
    w = DTensor.from_local(local, mesh, spec_placements(("dp",), mesh))
    # every rank calls report(state=...); DCP saves collectively
    session.report({"rank": session.world_rank(), "refused": refused},
                   state={"w": w, "step": torch.tensor(1, dtype=torch.int32)})
    return {"world": dist.get_world_size()}


def test_trainer_collective_sharded_checkpoint(ray_start_regular, tmp_path):
    """2-worker gang under one gloo process group: session.report(state=...)
    runs the DCP save collectively on all ranks (each writes its shard of
    the DTensor) into rank 0's slot; the loops compute on the CPU, and a
    loop asking the gloo group's session for another device is refused."""
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    trainer = DataParallelTrainer(
        _collective_loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="collective", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.ok, result.error
    assert result.checkpoint is not None
    assert "process group is gloo" in result.metrics["refused"]
    assert result.checkpoint.saved_process_count() == 2
    r = result.checkpoint.load_state()  # host restore on the driver
    assert tuple(r["w"].shape) == (16, 2)
    # rank r wrote rows r*8 .. r*8+7: the whole tensor holds all 16
    assert sorted(r["w"][:, 0].tolist()) == [float(i) for i in range(16)]
    assert int(r["step"]) == 1


_MP_WORKER = textwrap.dedent("""
    import os, sys
    rank, nproc, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from ray_tpu_torch.train.checkpoint import Checkpoint

    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=nproc)
    mesh = init_device_mesh("cpu", (nproc,), mesh_dim_names=("dp",))
    local = torch.full((8, 4), float(rank))
    x = DTensor.from_local(local, mesh, [Shard(0)])
    state = {"w": x, "step": torch.tensor(5, dtype=torch.int32),
             "tag": "mh"}
    ck = Checkpoint.from_state(state, os.path.join(outdir, "ck"))
    target = {"w": DTensor.from_local(torch.zeros(8, 4), mesh, [Shard(0)]),
              "step": torch.tensor(0, dtype=torch.int32), "tag": ""}
    r = ck.load_state(target)
    assert isinstance(r["w"], DTensor)            # still sharded
    assert tuple(r["w"].shape) == (8 * nproc, 4)
    assert bool(torch.all(r["w"].to_local() == float(rank)))
    assert int(r["step"]) == 5 and r["tag"] == "mh"
    dist.barrier()
    dist.destroy_process_group()
    print(f"proc {rank} ok", flush=True)
""")


def test_multiprocess_sharded_save_restore(tmp_path):
    """Two gloo ranks: an (8 x 2, 4) DTensor sharded over the 2-rank mesh
    is saved by both processes (DCP writes each rank's shard) and
    restored sharded onto a DTensor target, each rank reading back its
    own block; the driver then restores it whole on the host."""
    script = tmp_path / "worker.py"
    script.write_text(_MP_WORKER)
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o}"
        assert f"proc {i} ok" in o
    ck = Checkpoint(str(out / "ck"))
    assert ck.saved_process_count() == 2
    r = ck.load_state()
    assert torch.equal(r["w"], torch.cat([torch.zeros(8, 4),
                                          torch.ones(8, 4)]))


_HOSTS_WORKER = textwrap.dedent("""
    import sys
    rank, uri, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from ray_tpu_torch.train import session

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("dp",))
    ctx = session.TrainContext(world_rank=rank, world_size=2, config={},
                               run_dir=uri, scaling=None, checkpoint=None)
    session._set_context(ctx)
    w = DTensor.from_local(torch.full((8, 4), float(rank)), mesh, [Shard(0)])
    session.report({"step": 1},
                   state={"w": w, "step": torch.tensor(1)})
    ctx.ckpt_mgr.flush()
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} ok", flush=True)
""")


def test_collective_save_without_shared_filesystem(tmp_path, monkeypatch):
    """Two gloo ranks as two hosts: each stages under its own home (no
    filesystem in common) and mirrors to one file:// run URI. Every rank
    commits its own ``arrays.tmp``, so the remote checkpoint holds both
    ranks' shards under ``arrays/`` and restores whole on a third host."""
    script = tmp_path / "host.py"
    script.write_text(_HOSTS_WORKER)
    uri = f"file://{tmp_path}/remote/run"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), uri, str(tmp_path / "store")],
        env=dict(os.environ, PYTHONPATH=str(REPO),
                 HOME=str(tmp_path / f"host{r}")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}"
    arrays = storage.list_at_uri(f"{uri}/checkpoint_000000/arrays")
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(arrays)
    assert "arrays.tmp" not in storage.list_at_uri(
        f"{uri}/checkpoint_000000")
    monkeypatch.setenv("HOME", str(tmp_path / "host2"))
    latest = CheckpointManager(uri).latest()
    assert latest is not None and latest.uri.endswith("checkpoint_000000")
    r = latest.load_state()
    assert torch.equal(r["w"], torch.cat([torch.zeros(8, 4),
                                          torch.ones(8, 4)]))
    assert int(r["step"]) == 1


@pytest.mark.cuda
def test_cuda_tensors_roundtrip_on_cuda(tmp_path):
    """On the card: CUDA tensors (f32 params, bf16, an AdamW state on
    CUDA) saved with DCP come back on CUDA, bit for bit, when the target
    tree is on CUDA; without a target they come back on the CPU."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 32, device="cuda", generator=g, requires_grad=True)
    opt = torch.optim.AdamW([w], lr=1e-3)
    w.grad = torch.randn(64, 32, device="cuda", generator=g)
    opt.step()
    state = {"w": w, "h": w.detach().to(torch.bfloat16),
             "opt": opt.state_dict(), "step": 1}
    ck = Checkpoint.from_state(state, str(tmp_path / "ck"))
    r = ck.load_state(state)
    assert r["w"].device.type == "cuda" and r["h"].device.type == "cuda"
    assert torch.equal(r["w"], w.detach()) and torch.equal(r["h"], state["h"])
    ea = r["opt"]["state"][0]["exp_avg"]
    assert ea.device.type == "cuda" and torch.equal(ea, opt.state[w]["exp_avg"])
    host = ck.load_state()
    assert host["w"].device.type == "cpu"
    assert torch.equal(host["w"], w.detach().cpu())
