"""Multi-actor worker lanes: fractional-CPU actors (0 < num_cpus < 1,
no other resources) pack into shared lane-host workers instead of paying
a full interpreter spawn each (ref: the reference's 40k-actor density
benchmark runs num_cpus=0.001 actors across its per-CPU worker fleet,
release/benchmarks/README.md:12; here one process hosts
actor_lanes_per_worker lanes, each with dedicated-worker semantics:
FIFO ordering, isolated kill, restart FSM).

Port of tests/test_actor_lanes.py, aimed at ray_tpu_torch.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.status import ActorDiedError
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def test_fractional_actors_share_worker(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=0.05)
    class A:
        def pid(self):
            import os

            return os.getpid()

        def val(self, x):
            return x * 2

    actors = [A.remote() for _ in range(8)]
    pids = ray_tpu_torch.get([a.pid.remote() for a in actors], timeout=120)
    # 8 fractional actors, 16 lanes/worker: they share processes rather
    # than each paying an interpreter spawn
    assert len(set(pids)) < len(pids), pids
    got = ray_tpu_torch.get([a.val.remote(i) for i, a in enumerate(actors)],
                      timeout=60)
    assert got == [2 * i for i in range(8)]


def test_lane_actor_kill_spares_host(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=0.05)
    class A:
        def pid(self):
            import os

            return os.getpid()

        def ping(self):
            return "pong"

    a, b = A.remote(), A.remote()
    pa, pb = ray_tpu_torch.get([a.pid.remote(), b.pid.remote()], timeout=120)
    assert pa == pb, "expected both lanes on one host worker"
    ray_tpu_torch.kill(a)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(a.ping.remote(), timeout=30)
    # the host process (and b's lane) survives the kill
    assert ray_tpu_torch.get(b.ping.remote(), timeout=30) == "pong"
    assert ray_tpu_torch.get(b.pid.remote(), timeout=30) == pb


def test_lane_actor_restartable(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=0.05, max_restarts=1)
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote(), timeout=120) == 1
    assert ray_tpu_torch.get(c.incr.remote(), timeout=30) == 2
    ray_tpu_torch.kill(c, no_restart=False)
    # the actor FSM restarts it in a fresh lane with fresh state
    deadline = time.time() + 60
    got = None
    while time.time() < deadline:
        try:
            got = ray_tpu_torch.get(c.incr.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.2)
    assert got == 1, f"restarted lane should reset state, got {got}"


def test_lane_fifo_ordering(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=0.05)
    class Seq:
        def __init__(self):
            self.log = []

        def add(self, i):
            time.sleep(0.005)
            self.log.append(i)
            return i

        def snapshot(self):
            return list(self.log)

    s = Seq.remote()
    refs = [s.add.remote(i) for i in range(20)]
    ray_tpu_torch.get(refs, timeout=120)
    assert ray_tpu_torch.get(s.snapshot.remote(), timeout=30) == list(range(20))


def test_lane_and_dedicated_coexist(ray_start_regular):
    """A num_cpus>=1 actor still gets its own worker process while lane
    actors share one."""
    @ray_tpu_torch.remote(num_cpus=0.05)
    class Small:
        def pid(self):
            import os

            return os.getpid()

    @ray_tpu_torch.remote(num_cpus=1)
    class Big:
        def pid(self):
            import os

            return os.getpid()

    s1, s2, b = Small.remote(), Small.remote(), Big.remote()
    p1, p2, pb = ray_tpu_torch.get(
        [s1.pid.remote(), s2.pid.remote(), b.pid.remote()], timeout=120)
    assert p1 == p2, "fractional actors share a lane host"
    assert pb not in (p1, p2), "dedicated actor keeps its own process"
