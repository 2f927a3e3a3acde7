"""``DataIterator.iter_device_batches``: the data layer's one device path.

On the card (``cuda``-marked; they skip without one, run them there with
``python3 -m pytest -m cuda tests/test_torch_data_device.py``):
- the device batches equal ``iter_batches`` bit for bit, in order;
- a consumer that writes into batch i while batch i+1 copies corrupts
  neither: 64 MiB batches and a step made slow with ``torch.cuda._sleep``,
  checked on the consumer's stream. It fails if the consumer does not wait
  on a batch's event (a half-copied read), if a staging buffer is refilled
  before the copy that read it completed, or if a batch's memory is handed
  to a later copy while the step still reads it (no ``record_stream``);
- the staging buffers are pinned, and the copies run on a stream other
  than the consumer's;
- ``sharding=`` on a 1-rank NCCL mesh gives DTensors;
- ``BatchPredictor`` on the card gives the CPU's greedy tokens at the tiny
  Llama preset in f32.

Here and there: with CUDA hidden, ``device=None`` raises rather than
running on the CPU; ``device="cpu"`` (no pinning, no streams) gives the
``iter_batches`` batches, issues batch i+1 before it yields batch i, and
names a non-numeric column in its TypeError; ``sharding=`` on a 1-rank
gloo mesh gives DTensors. No JAX here: the card's machine has none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.dataset import _DeviceFeed
from test_torch_support import require_cuda
from torch_runtime_support import reap_orphans  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def _ds(rows=40, blocks=5, seed=0):
    rng = np.random.default_rng(seed)
    return rd.from_numpy({"x": rng.standard_normal((rows, 3)),
                          "i": np.arange(rows, dtype=np.int32),
                          "f": rng.standard_normal(rows).astype(np.float32)},
                         num_blocks=blocks)


def _iterator(ds):
    return ds.streaming_split(1)[0]


def _assert_batches_equal(dev_batches, host_batches):
    assert len(dev_batches) == len(host_batches)
    for d, h in zip(dev_batches, host_batches):
        assert list(d) == list(h)
        for k in h:
            got = d[k].cpu().numpy()
            assert got.dtype == h[k].dtype and got.shape == h[k].shape
            assert got.tobytes() == np.ascontiguousarray(h[k]).tobytes()


# --- on the CPU and on the card ----------------------------------------------

def test_device_none_without_cuda_raises():
    code = ("from ray_tpu_torch.data.dataset import DataIterator\n"
            "it = DataIterator([], []).iter_device_batches(batch_size=2)\n"
            "try:\n"
            "    next(it)\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n"
            "else:\n"
            "    print('ran')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "raised: CUDA is not available" in out.stdout, out.stdout


@pytest.mark.parametrize("drop_last", [True, False])
def test_cpu_device_batches_equal_iter_batches(cluster, drop_last):
    it = _iterator(_ds())
    host = list(it.iter_batches(batch_size=6, drop_last=drop_last))
    dev = list(it.iter_device_batches(batch_size=6, drop_last=drop_last,
                                      device="cpu"))
    _assert_batches_equal(dev, host)
    assert all(t.device.type == "cpu" for b in dev for t in b.values())


def test_next_batch_is_issued_before_a_batch_is_yielded(cluster,
                                                        monkeypatch):
    log = []
    put, ready = _DeviceFeed.put, _DeviceFeed.ready

    def logged_put(self, batch):
        log.append(("put", int(batch["i"][0])))
        return put(self, batch)

    def logged_ready(self, item):
        out = ready(self, item)
        log.append(("yield", int(out["i"][0])))
        return out

    monkeypatch.setattr(_DeviceFeed, "put", logged_put)
    monkeypatch.setattr(_DeviceFeed, "ready", logged_ready)
    list(_iterator(_ds(rows=24, blocks=3)).iter_device_batches(
        batch_size=8, device="cpu"))
    assert log == [("put", 0), ("put", 8), ("yield", 0), ("put", 16),
                   ("yield", 8), ("yield", 16)]


def test_non_numeric_column_raises_naming_it(cluster):
    ds = rd.from_numpy({"x": np.arange(4.0),
                        "name": np.asarray(["a", "b", "c", "d"])},
                       num_blocks=1)
    with pytest.raises(TypeError, match="'name'"):
        list(_iterator(ds).iter_device_batches(batch_size=2, device="cpu"))


def test_cpu_sharding_gives_dtensors(cluster):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec

    started = not dist.is_initialized()
    mesh = local_mesh(MeshSpec(dp=-1), device="cpu")
    try:
        it = _iterator(_ds())
        host = list(it.iter_batches(batch_size=8, drop_last=True))
        dev = list(it.iter_device_batches(
            batch_size=8, device="cpu",
            sharding=NamedSharding(mesh, PartitionSpec("dp"))))
        assert all(isinstance(t, DTensor) for b in dev for t in b.values())
        _assert_batches_equal([{k: t.full_tensor() for k, t in b.items()}
                               for b in dev], host)
    finally:
        if started:
            dist.destroy_process_group()


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_device_batches_equal_iter_batches(cluster):
    require_cuda()
    it = _iterator(_ds(rows=203, blocks=7))
    host = list(it.iter_batches(batch_size=16))
    dev = list(it.iter_device_batches(batch_size=16))
    assert all(t.is_cuda for b in dev for t in b.values())
    _assert_batches_equal(dev, [h for h in host if len(h["i"]) == 16])


@pytest.mark.cuda
def test_staging_is_pinned_and_copies_use_a_side_stream():
    require_cuda()
    import torch

    feed = _DeviceFeed(ray_tpu_torch.resolve_device(None))
    batch = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
             "b": np.arange(3, dtype=np.int64)}
    item = feed.put(batch)
    assert all(t.is_pinned() for t in feed._staging[0].values())
    assert feed.stream.cuda_stream != \
        torch.cuda.current_stream().cuda_stream
    assert feed._copied[0] is not None
    out = feed.ready(item)
    _assert_batches_equal([out], [batch])


# a copy stream held back this long before each batch's copy (longer than
# the host takes to stage the next batch, so a batch is yielded before its
# copy ran), and a step this long on the consumer's stream (longer than two
# held-back copies, so the copy after next lands while the step still
# reads its batch): clock cycles of torch.cuda._sleep, ~100 and ~350 ms
# on an H100
SLOW_COPY_CYCLES, SLOW_STEP_CYCLES = 200_000_000, 700_000_000


def race_feed(monkeypatch):
    """Hold the copy stream back before every copy, so that a batch's copy
    is still running when the host yields it and refills the other
    staging buffer."""
    import torch

    put = _DeviceFeed.put

    def slow_put(self, batch):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(SLOW_COPY_CYCLES)
        return put(self, batch)

    monkeypatch.setattr(_DeviceFeed, "put", slow_put)


def write_while_copying(ds, rows, expect):
    """The consumer of the race: on its stream, check batch i against the
    expected values, sleep (the next copies run under it), write into the
    batch and check the write, then drop the batch while that work is
    still queued. Per batch (read ok, write ok) after a synchronize."""
    import torch

    read_ok, write_ok = [], []
    for i, b in enumerate(ds.streaming_split(1)[0].iter_device_batches(
            batch_size=rows)):
        want = expect[i * rows:(i + 1) * rows]
        read_ok.append((b["a"] == want).all())
        torch.cuda._sleep(SLOW_STEP_CYCLES)
        b["a"].add_(1.0)
        write_ok.append((b["a"] == want + 1.0).all())
        del b
    torch.cuda.synchronize()
    return [(bool(r), bool(w)) for r, w in zip(read_ok, write_ok)]


@pytest.mark.cuda
def test_write_while_next_batch_copies_corrupts_nothing(cluster,
                                                        monkeypatch):
    """64 MiB batches with slow copies and a slow step. It fails if the
    consumer does not wait on a batch's event (it reads the batch before
    its held-back copy ran), if a staging buffer is refilled before the
    copy that read it completed (that copy then moves the next batch's
    rows), or if a dropped batch's memory goes to the next copy while the
    step still reads it (no record_stream: its write check sees that
    copy's rows)."""
    require_cuda()
    import torch

    rows, cols, n = 4096, 4096, 6                 # 64 MiB of f32 a batch
    arr = np.random.default_rng(5).standard_normal((rows * n, cols),
                                                   dtype=np.float32)
    ds = rd.from_numpy({"a": arr}, num_blocks=n)
    expect = torch.from_numpy(arr).cuda()
    torch.cuda.synchronize()
    race_feed(monkeypatch)
    assert write_while_copying(ds, rows, expect) == [(True, True)] * n


@pytest.mark.cuda
def test_card_sharding_gives_dtensors(cluster):
    require_cuda()
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec

    started = not dist.is_initialized()
    mesh = local_mesh(MeshSpec(dp=-1))
    try:
        it = _iterator(_ds())
        host = list(it.iter_batches(batch_size=8, drop_last=True))
        dev = list(it.iter_device_batches(
            batch_size=8, sharding=NamedSharding(mesh, PartitionSpec("dp"))))
        assert all(isinstance(t, DTensor) and t.device.type == "cuda"
                   for b in dev for t in b.values())
        _assert_batches_equal([{k: t.full_tensor() for k, t in b.items()}
                               for b in dev], host)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_batch_predictor_on_the_card_gives_the_cpus_tokens(cluster,
                                                           tmp_path):
    require_cuda()
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import (BatchPredictor, Checkpoint,
                                     FunctionPredictor)

    cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    ckpt = Checkpoint.from_state({"params": params}, str(tmp_path / "ck"))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               size=(16, 32))
    ds = rd.from_numpy({"features": tokens}, num_blocks=4)

    def apply_fn(p, x):       # local: the actor gets it by value
        return llama.forward(p, x.long(), cfg)[:, -1].argmax(-1)

    def predict(**kw):
        out = BatchPredictor(ckpt, FunctionPredictor, apply_fn=apply_fn,
                             **kw.pop("pred", {})).predict(ds, **kw)
        return np.concatenate([b["predictions"]
                               for b in out.iter_batches(batch_size=4)])

    card = predict(num_replicas=1, resources_per_replica={"GPU": 1})
    cpu = predict(num_replicas=1, pred={"device": "cpu"})
    np.testing.assert_array_equal(card, cpu)
