"""Actor semantics: creation, ordering, named actors, restart, async actors.

Reference test model: python/ray/tests/test_actor*.py.

Port of tests/test_core_actor.py, aimed at ray_tpu_torch.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.status import ActorDiedError, TaskError
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n

    def fail(self):
        raise RuntimeError("actor method failure")

    def pid(self):
        import os

        return os.getpid()


def test_actor_basic(ray_start_regular):
    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.incr.remote()) == 11
    assert ray_tpu_torch.get(c.incr.remote(5)) == 16
    assert ray_tpu_torch.get(c.value.remote()) == 16


def test_actor_ordering(ray_start_regular):
    c = Counter.remote()
    refs = [c.incr.remote() for _ in range(20)]
    assert ray_tpu_torch.get(refs) == list(range(1, 21))


def test_actor_method_error(ray_start_regular):
    c = Counter.remote()
    with pytest.raises(TaskError):
        ray_tpu_torch.get(c.fail.remote())
    # actor still alive after method error
    assert ray_tpu_torch.get(c.value.remote()) == 0


def test_two_actors_isolated(ray_start_regular):
    a, b = Counter.remote(), Counter.remote(100)
    ray_tpu_torch.get([a.incr.remote(), b.incr.remote()])
    assert ray_tpu_torch.get(a.value.remote()) == 1
    assert ray_tpu_torch.get(b.value.remote()) == 101


def test_named_actor(ray_start_regular):
    Counter.options(name="counter1").remote(5)
    h = ray_tpu_torch.get_actor("counter1")
    assert ray_tpu_torch.get(h.value.remote()) == 5


def test_actor_handle_passed_to_task(ray_start_regular):
    @ray_tpu_torch.remote
    def bump(handle):
        return ray_tpu_torch.get(handle.incr.remote())

    c = Counter.remote()
    assert ray_tpu_torch.get(bump.remote(c)) == 1
    assert ray_tpu_torch.get(c.value.remote()) == 1


def test_kill_actor(ray_start_regular):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.value.remote()) == 0
    ray_tpu_torch.kill(c)
    time.sleep(0.5)
    with pytest.raises((ActorDiedError, ray_tpu_torch.exceptions.ActorUnavailableError)):
        ray_tpu_torch.get(c.value.remote())


def test_actor_restart(ray_start_regular):
    @ray_tpu_torch.remote
    class Flaky:
        def __init__(self):
            self.calls = 0

        def die(self):
            import os

            os._exit(1)

        def ping(self):
            return "pong"

    # max_task_retries=0: the `die` call must NOT be re-executed after the
    # restart (it would kill the fresh instance and exhaust the budget —
    # matching the reference's retry semantics, actor.py:332-351).
    a = Flaky.options(max_restarts=1, max_task_retries=0).remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    try:
        ray_tpu_torch.get(a.die.remote())
    except Exception:
        pass
    # GCS restarts the actor; later calls land on the new instance
    deadline = time.time() + 30
    ok = False
    while time.time() < deadline:
        try:
            if ray_tpu_torch.get(a.ping.remote()) == "pong":
                ok = True
                break
        except (ray_tpu_torch.exceptions.ActorUnavailableError,
                ray_tpu_torch.exceptions.ActorDiedError):
            time.sleep(0.3)
    assert ok, "actor did not come back after restart"


def test_async_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.05)
            return x * 2

    a = AsyncWorker.options(max_concurrency=4).remote()
    t0 = time.time()
    refs = [a.work.remote(i) for i in range(8)]
    assert ray_tpu_torch.get(refs) == [i * 2 for i in range(8)]
    # 8 calls of 50ms at concurrency 4 should take well under 8*50ms
    assert time.time() - t0 < 3.0


def test_actor_in_placement_context_gets_big_object(ray_start_regular):
    import numpy as np

    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.arr = None

        def load(self, arr):
            self.arr = arr
            return float(arr.sum())

    h = Holder.remote()
    big = np.ones(400_000, dtype=np.float64)
    ref = ray_tpu_torch.put(big)
    assert ray_tpu_torch.get(h.load.remote(ref)) == 400_000.0
