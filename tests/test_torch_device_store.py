"""Device object tier (core/device_store.py; SURVEY §7 step 2).

Port of tests/test_device_store.py, with CPU tensors where it has CPU jax
arrays. The inversion of plasma (ref:
src/ray/object_manager/plasma/store.h:55 — host shm as the only tier):
put(tensor) keeps the tensor where it is; the D2H copy happens only on
first REMOTE need (host-staging through the shm store) or on device
pressure (spill chain device -> shm -> disk). The tier admits CPU
tensors as the reference admits CPU jax arrays, so these tests run on
the CPU the code the card runs (chip_smoke.py's ``runtime`` phase puts a
CUDA tensor through it).
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def _buf_ptr(arr):
    return arr.data_ptr()


def test_same_process_put_get_zero_copy(ray_start_regular):
    """Owner-side get returns the IDENTICAL tensor — no D2H, no copy
    (assert via the device buffer pointer), and no shm write happened."""
    rt = ray_tpu_torch.core.runtime.get_runtime()
    arr = torch.arange(1 << 16, dtype=torch.float32)  # 256 KiB > inline max
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    assert out is arr
    assert _buf_ptr(out) == _buf_ptr(arr)
    assert rt.device_store.contains(ref.id)
    assert not rt.store.contains(ref.id)      # staging was never needed
    assert rt.device_store.stats()["bytes"] == arr.nbytes


def test_remote_consumer_host_stages(ray_start_regular):
    """A remote worker's get triggers lazy staging: the consumer sees a
    host tensor with the right contents; the owner's shm store now holds
    the staged copy (from where the transfer plane serves it)."""
    rt = ray_tpu_torch.core.runtime.get_runtime()
    arr = torch.arange(1 << 15, dtype=torch.float32) * 2.0
    ref = ray_tpu_torch.put(arr)

    @ray_tpu_torch.remote
    def consume(x):
        import torch

        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        return float(x.sum()), tuple(x.shape)

    total, shape = ray_tpu_torch.get(consume.remote(ref), timeout=60)
    assert total == float(arr.sum())
    assert shape == tuple(arr.shape)
    # staged to shm, but the device copy is still the local fast path
    assert rt.store.contains(ref.id)
    assert rt.device_store.contains(ref.id)
    assert ray_tpu_torch.get(ref) is arr


def test_capacity_watermark_spills_lru_to_host(ray_start_regular):
    """Over-budget device tier demotes oldest-first to shm; the demoted
    object's get returns the host copy (a tensor of its own), the
    survivor stays device-resident."""
    rt = ray_tpu_torch.core.runtime.get_runtime()
    old_cap = rt.device_store.capacity
    arr_a = torch.ones((256, 1024), dtype=torch.float32)        # 1 MiB
    arr_b = torch.full((256, 1024), 3.0, dtype=torch.float32)   # 1 MiB
    try:
        rt.device_store.capacity = int(1.5 * arr_a.nbytes)
        ref_a = ray_tpu_torch.put(arr_a)
        assert rt.device_store.contains(ref_a.id)
        ref_b = ray_tpu_torch.put(arr_b)                    # pushes over budget
        assert not rt.device_store.contains(ref_a.id)  # LRU victim staged
        assert rt.store.contains(ref_a.id)
        assert rt.device_store.contains(ref_b.id)
        a = ray_tpu_torch.get(ref_a)
        assert isinstance(a, torch.Tensor) and float(a[0, 0]) == 1.0
        assert a is not arr_a and a.dtype == arr_a.dtype
        assert ray_tpu_torch.get(ref_b) is arr_b
    finally:
        rt.device_store.capacity = old_cap


def test_free_releases_device_bytes(ray_start_regular):
    rt = ray_tpu_torch.core.runtime.get_runtime()
    before = rt.device_store.stats()["bytes"]
    ref = ray_tpu_torch.put(torch.zeros(1 << 15, dtype=torch.float32))
    assert rt.device_store.stats()["bytes"] > before
    oid = ref.id
    del ref
    import gc

    gc.collect()
    deadline = __import__("time").time() + 10
    while __import__("time").time() < deadline:
        if not rt.device_store.contains(oid):
            break
        __import__("time").sleep(0.1)
    assert not rt.device_store.contains(oid)
    assert rt.device_store.stats()["bytes"] == before


def test_take_transfers_ownership_for_donation(ray_start_regular):
    """Donation-aware get (train hot path): take() hands the caller the
    live tensor and withdraws it from the tiers, so writing it in place
    cannot corrupt a stored copy behind other readers."""
    rt = ray_tpu_torch.core.runtime.get_runtime()
    arr = torch.arange(1 << 15, dtype=torch.float32)
    ref = ray_tpu_torch.put(arr)
    got = rt.take(ref)
    assert got is arr
    assert not rt.device_store.contains(ref.id)
    with pytest.raises(ray_tpu_torch.exceptions.ObjectLostError):
        ray_tpu_torch.get(ref, timeout=5)
    # the owner can now safely update the tensor in place
    out = got.mul_(2)
    assert out is arr and float(out[1]) == 2.0


def test_non_array_values_unaffected(ray_start_regular):
    """Plain host values keep the classic path (inline or shm)."""
    rt = ray_tpu_torch.core.runtime.get_runtime()
    ref = ray_tpu_torch.put({"x": np.ones(1 << 15, np.float32)})
    assert not rt.device_store.contains(ref.id)
    out = ray_tpu_torch.get(ref)
    assert float(out["x"].sum()) == float(1 << 15)


def test_pytree_put_get_zero_copy(ray_start_regular):
    """A params-style pytree of tensors takes the device tier whole:
    same-process get returns the identical tree (leaf buffers shared),
    the train/serve weight-sync hot path."""
    rt = ray_tpu_torch.core.runtime.get_runtime()
    params = {"layers": {"w": torch.ones((256, 256), dtype=torch.float32),
                         "b": torch.zeros((256,), dtype=torch.float32)},
              "head": [torch.full((64, 64), 2.0, dtype=torch.float32)]}
    ref = ray_tpu_torch.put(params)
    assert rt.device_store.contains(ref.id)
    out = ray_tpu_torch.get(ref)
    # leaf BUFFERS are shared (zero-copy); the containers are a
    # snapshot, so mutating the caller's dict after put can't desync
    # the stored object
    assert out is not params
    assert out["layers"]["w"] is params["layers"]["w"]
    assert _buf_ptr(out["layers"]["w"]) == _buf_ptr(params["layers"]["w"])
    params["layers"]["b"] = "mutated"          # caller-side mutation...
    assert ray_tpu_torch.get(ref)["layers"]["b"] is not params["layers"]["b"]
    # tied weights count once in device-tier accounting
    before = rt.device_store.stats()["bytes"]
    w = torch.ones((512, 512), dtype=torch.float32)
    tied_ref = ray_tpu_torch.put({"emb": w, "head": w})
    assert rt.device_store.contains(tied_ref.id)
    assert rt.device_store.stats()["bytes"] - before == w.nbytes

    @ray_tpu_torch.remote
    def consume(p):
        return float(p["layers"]["w"].sum()) + float(p["head"][0][0, 0])

    assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == 256 * 256 + 2.0
    # mixed host/device trees keep the classic path
    mixed = {"a": torch.ones(1 << 15), "b": np.ones(1 << 15, np.float32)}
    ref2 = ray_tpu_torch.put(mixed)
    assert not rt.device_store.contains(ref2.id)
