"""util: ActorPool, Queue, collective ops, metrics, state API.

Port of tests/test_util.py, aimed at ray_tpu_torch.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import ActorPool, Queue
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def test_actor_pool(ray_start_regular):
    @ray_tpu_torch.remote
    class W:
        def double(self, x):
            return x * 2

    pool = ActorPool([W.remote(), W.remote()])
    out = sorted(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
    assert out == [2, 4, 6, 8]


def test_queue(ray_start_regular):
    q = Queue()
    q.put({"a": 1})
    q.put(2)
    assert q.get() == {"a": 1}
    assert q.get() == 2
    assert q.empty()
    q.shutdown()


def test_collective_allreduce(ray_start_regular):
    from ray_tpu_torch.util import collective as col

    @ray_tpu_torch.remote
    class Member:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def run(self):
            col.init_collective_group(self.world, self.rank, "g1")
            x = np.full((4,), float(self.rank + 1))
            total = col.allreduce(x, "g1")
            gathered = col.allgather(x, "g1")
            col.barrier("g1")
            return total.tolist(), len(gathered)

    world = 3
    members = [Member.options(num_cpus=0.5).remote(i, world)
               for i in range(world)]
    # 3 worker spawns (~5 s of framework import each) + the rendezvous must
    # survive a loaded box (the suite runs under a deliberate CPU hog)
    outs = ray_tpu_torch.get([m.run.remote() for m in members], timeout=240)
    for total, n in outs:
        assert total == [6.0, 6.0, 6.0, 6.0]   # 1+2+3
        assert n == world


def test_metrics_and_state(ray_start_regular):
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.metrics import Counter, Gauge, prometheus_text

    c = Counter("reqs_total", description="requests", tag_keys=("route",))
    c.inc(1, {"route": "/a"})
    c.inc(2, {"route": "/a"})
    g = Gauge("temperature")
    g.set(42.0)

    text = prometheus_text()
    assert "reqs_total" in text and "temperature 42.0" in text

    s = state.cluster_summary()
    assert s["nodes_alive"] >= 1
    assert state.memory_summary()["store_capacity"] > 0

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    ray_tpu_torch.get(a.ping.remote())
    actors = state.list_actors(state="ALIVE")
    assert any(x["class_name"] == "A" for x in actors)


def test_log_streaming_to_driver(ray_start_regular, capfd):
    import time

    @ray_tpu_torch.remote
    def noisy():
        print("hello-from-worker-xyz")
        return 1

    assert ray_tpu_torch.get(noisy.remote()) == 1
    deadline = time.time() + 10
    seen = False
    while time.time() < deadline and not seen:
        time.sleep(0.5)
        out, _ = capfd.readouterr()
        seen = "hello-from-worker-xyz" in out
    assert seen, "worker stdout did not stream to driver"
