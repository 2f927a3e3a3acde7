"""Object spilling: shm pressure → disk, restore on get, delete on free.

Reference behavior mirrored: src/ray/raylet/local_object_manager.h:41
(spill under pressure, restore on demand) and
python/ray/_private/external_storage.py:72 (FileSystemStorage).

Port of tests/test_core_spilling.py, aimed at ray_tpu_torch.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.external_storage import FilesystemStorage
from ray_tpu_torch.core.ids import ObjectID
from torch_runtime_support import reap_orphans  # noqa: F401


def test_filesystem_storage_roundtrip(tmp_path):
    st = FilesystemStorage(str(tmp_path))
    oid = ObjectID.from_random()
    data = b"x" * 1000
    url = st.spill(oid, data)
    assert url.startswith("file://")
    assert st.contains(oid)
    assert st.restore(oid) == data
    total, chunk = st.read_range(oid, 100, 50)
    assert total == 1000 and chunk == b"x" * 50
    assert st.bytes_spilled() == 1000
    st.delete(oid)
    assert not st.contains(oid)
    assert st.restore(oid) is None
    assert st.bytes_spilled() == 0


def test_spill_idempotent(tmp_path):
    st = FilesystemStorage(str(tmp_path))
    oid = ObjectID.from_random()
    st.spill(oid, b"abc")
    st.spill(oid, b"abc")
    assert st.num_spilled() == 1
    assert st.bytes_spilled() == 3


@pytest.fixture
def small_store_cluster():
    """Cluster whose shm store is tiny, forcing spills."""
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "object_store_memory": 16 * 1024 * 1024,
            "object_spill_threshold": 0.7,
            "object_spill_low_water": 0.4,
        },
    )
    yield
    ray_tpu_torch.shutdown()


def test_put_beyond_capacity_all_retrievable(small_store_cluster):
    """Put 32 MiB of values through a 16 MiB store: primaries spill to disk
    (the nodelet owns their pins) and restore on get. Refs are dropped as
    they are consumed, releasing read pins as a real pipeline would."""
    refs = [ray_tpu_torch.put(np.full((2 * 1024 * 1024,), i, dtype=np.uint8))
            for i in range(16)]
    i = 0
    while refs:
        out = ray_tpu_torch.get(refs.pop(0))
        assert out.shape == (2 * 1024 * 1024,)
        assert out[0] == i and out[-1] == i
        del out
        i += 1
    assert i == 16


def test_task_outputs_spill_and_restore(small_store_cluster):
    @ray_tpu_torch.remote
    def make(i):
        return np.full((2 * 1024 * 1024,), i % 251, dtype=np.uint8)

    refs = list(enumerate(make.remote(i) for i in range(12)))
    # Consumes in reverse (newest first) to defeat LRU luck; total output
    # (24 MiB) exceeds the 16 MiB store.
    while refs:
        i, r = refs.pop()
        out = ray_tpu_torch.get(r)
        assert out[0] == i % 251
        del out, r


def test_spill_stats_surface(small_store_cluster):
    import time

    from ray_tpu_torch.core.runtime import get_runtime

    refs = [ray_tpu_torch.put(np.zeros((2 * 1024 * 1024,), dtype=np.uint8))
            for _ in range(8)]
    # 16 MiB of live puts in a 16 MiB store: some objects must spill.
    rt = get_runtime()
    deadline = time.time() + 10
    spilled = 0
    while time.time() < deadline:
        stats = rt._run(rt.pool.get(rt.nodelet_addr).call("node_stats"))
        spilled = stats.get("spilled_objects", 0)
        if spilled > 0:
            break
        time.sleep(0.2)
    assert spilled > 0
    assert stats.get("spilled_bytes", 0) > 0
    del refs


def test_device_tier_full_spill_chain():
    """The complete device -> shm -> disk -> get chain (SURVEY §7 step 2):
    tensor puts over the device-tier watermark demote LRU objects into a
    tiny shm store, whose own watermark spills them to disk; gets restore
    every value intact (as host tensors — demotion is one-way)."""
    import torch

    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "object_store_memory": 16 * 1024 * 1024,
            "object_spill_threshold": 0.7,
            "object_spill_low_water": 0.4,
            # device tier holds ~2 x 2 MiB objects before demoting
            "device_object_store_bytes": 5 * 1024 * 1024,
        },
    )
    try:
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        refs = [ray_tpu_torch.put(torch.full((2 * 1024 * 1024 // 4,),
                                             float(i), dtype=torch.float32))
                for i in range(12)]   # 24 MiB through a 5 MiB device budget
        assert rt.device_store.stats()["bytes"] \
            <= rt.device_store.capacity
        # the early objects were demoted out of the device tier; pushing
        # 24 MiB through the 16 MiB shm store forced disk spills too
        assert not rt.device_store.contains(refs[0].id)
        i = 0
        while refs:
            out = ray_tpu_torch.get(refs.pop(0))
            assert isinstance(out, torch.Tensor)
            assert float(out[0]) == float(i)
            assert float(out[-1]) == float(i)
            del out
            i += 1
        assert i == 12
    finally:
        ray_tpu_torch.shutdown()
