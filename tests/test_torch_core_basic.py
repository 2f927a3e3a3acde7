"""Core API basics: tasks, objects, wait, errors.

Reference test model: python/ray/tests/test_basic.py.

Port of tests/test_core_basic.py, aimed at ray_tpu_torch.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.status import TaskError
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def test_put_get(ray_start_regular):
    ref = ray_tpu_torch.put({"x": 1, "y": [1, 2, 3]})
    assert ray_tpu_torch.get(ref) == {"x": 1, "y": [1, 2, 3]}


def test_put_get_large_numpy(ray_start_regular):
    arr = np.arange(1_000_000, dtype=np.float32)
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    assert np.array_equal(out, arr)
    # big objects come back zero-copy from the shm store
    assert not out.flags.owndata


def test_simple_task(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    assert ray_tpu_torch.get(f.remote(21)) == 42


def test_task_with_ref_arg(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    a = f.remote(1)
    b = f.remote(a)
    c = f.remote(b)
    assert ray_tpu_torch.get(c) == 4


def test_task_large_return_and_arg(ray_start_regular):
    @ray_tpu_torch.remote
    def make():
        return np.ones(500_000, dtype=np.float64)

    @ray_tpu_torch.remote
    def total(x):
        return float(x.sum())

    ref = make.remote()
    assert ray_tpu_torch.get(total.remote(ref)) == 500_000.0


def test_put_ref_as_task_arg(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x["k"]

    ref = ray_tpu_torch.put({"k": 7})
    assert ray_tpu_torch.get(f.remote(ref)) == 7


def test_multiple_returns(ray_start_regular):
    @ray_tpu_torch.remote(num_returns=3)
    def f():
        return 1, 2, 3

    a, b, c = f.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_task_error_propagates(ray_start_regular):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(boom.remote())
    assert "kaboom" in str(ei.value)


def test_wait(ray_start_regular):
    import time

    @ray_tpu_torch.remote
    def fast():
        return 1

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return 2

    f, s = fast.remote(), slow.remote()
    ready, pending = ray_tpu_torch.wait([f, s], num_returns=1, timeout=10)
    assert ready == [f] and pending == [s]


def test_nested_tasks(ray_start_regular):
    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) + 10

    assert ray_tpu_torch.get(outer.remote(0)) == 11


def test_many_small_tasks(ray_start_regular):
    @ray_tpu_torch.remote
    def f(i):
        return i

    refs = [f.remote(i) for i in range(50)]
    assert ray_tpu_torch.get(refs) == list(range(50))


def test_get_timeout(ray_start_regular):
    import time

    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.5)


def test_cluster_resources(ray_start_regular):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 4.0


def test_resource_accounting_no_leak_under_churn(ray_start_regular):
    """Pending-lease drain must reserve synchronously: one freed CPU
    admits one queued lease, not the whole queue (regression: available
    CPU went negative by ~100 under batch churn and the worker pool
    exploded)."""
    import time

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def noop():
        return None

    t0 = time.time()
    while time.time() - t0 < 1.5:
        ray_tpu_torch.get([noop.remote() for _ in range(80)])
    avail = ray_tpu_torch.available_resources()
    assert avail.get("CPU", 0) >= 0, avail
    # leases drain back to the full node shortly after the churn stops
    deadline = time.time() + 10
    while time.time() < deadline:
        if ray_tpu_torch.available_resources().get("CPU") == 4.0:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources().get("CPU") == 4.0


def test_lease_reuse_grace_window(ray_start_regular):
    """A sequential submit->get loop must ride ONE parked lease instead
    of an acquire/return RPC pair per task (lease_reuse_grace_s; ref:
    idle leased-worker reuse). Regression: r2 paid ~3 lease RPCs/task."""
    from ray_tpu_torch import _rt

    rt = _rt.get_runtime()

    @ray_tpu_torch.remote(num_cpus=0.1)
    def f(x):
        return x

    assert ray_tpu_torch.get(f.remote(0)) == 0       # warm worker + function

    calls = {"n": 0}
    orig = rt._acquire_lease

    async def counting(*a, **k):
        calls["n"] += 1
        return await orig(*a, **k)

    rt._acquire_lease = counting
    try:
        for i in range(20):
            assert ray_tpu_torch.get(f.remote(i)) == i
    finally:
        rt._acquire_lease = orig
    # the whole loop should fit in a handful of leases, not one per task
    assert calls["n"] <= 5, calls["n"]
