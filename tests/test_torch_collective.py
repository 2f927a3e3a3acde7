"""ray_tpu_torch.collective: cross-backend equivalence, bandwidth accounting,
member-failure detection, lifecycle, and the legacy-bug regressions.

Equivalence data is integer-valued (cast to float) so summation is
exact: ring accumulates chunks in rotated rank order, gather/hier in
ascending rank order — with exact arithmetic every order gives the same
bits, which is what lets the suite demand bitwise-identical results
across backends.

Port of tests/test_collective.py, aimed at ray_tpu_torch (its WorkerGroup
case since the train layer was ported; its bench sweep waits with
bench.py, ROADMAP.md queue 1 item 11.5).
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.collective.topology import Topology
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def _payload(rank: int, shape=(6, 4), dtype=np.float64, seed=3):
    rng = np.random.default_rng(seed + rank)
    return rng.integers(-50, 50, size=shape).astype(dtype)


@ray_tpu_torch.remote
class Member:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def equivalence_run(self, backend, group):
        """One full op sweep on `backend`; returns everything the driver
        compares across backends."""
        from ray_tpu_torch import collective as col

        col.init_collective_group(self.world, self.rank, group,
                                  backend=backend, timeout_s=60)
        x = _payload(self.rank)
        tree = {"w": _payload(self.rank, (5, 3)),
                "b": [_payload(self.rank, (4,), np.float32),
                      np.float64(self.rank + 1)]}
        out = {
            "allreduce": col.allreduce(x, group),
            "tree": col.allreduce(tree, group),
            "allgather": col.allgather(self.rank * 11, group),
            "broadcast": np.asarray(col.broadcast(
                np.arange(5) * 7 if self.rank == 1 else None,
                src_rank=1, group_name=group)),
            "reducescatter": col.reducescatter(
                _payload(self.rank, (self.world * 2, 3)), group),
        }
        # ragged reducescatter must refuse loudly, not return ragged chunks
        try:
            col.reducescatter(_payload(self.rank, (self.world * 2 + 1, 3)),
                              group)
            out["ragged"] = "no error"
        except ValueError as e:
            out["ragged"] = str(e)
        # async variant overlaps with caller compute
        fut = col.allreduce_async(x, group)
        out["async_allreduce"] = fut.result(timeout=120)
        col.barrier(group)
        # transfer accounting for ONE large allreduce (the bandwidth claim)
        col.reset_transfer_stats(group)
        big = np.ones(64 * 1024, dtype=np.float64) * (self.rank + 1)  # 512 KiB
        out["big"] = col.allreduce(big, group)[:4]
        out["stats"] = col.transfer_stats(group)
        out["big_nbytes"] = big.nbytes
        if backend == "gather":
            out["coord"] = col.coordinator_stats(group)
        return out

    def chaos_run(self, backend, group, timeout_s, die_after_round1):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective import CollectiveError

        col.init_collective_group(self.world, self.rank, group,
                                  backend=backend, timeout_s=timeout_s)
        col.allreduce(np.ones(4), group)           # round 1: everyone alive
        if die_after_round1:
            return {"outcome": "left"}
        t0 = time.time()
        try:
            col.allreduce(np.ones(4), group)       # round 2: rank 1 is gone
            return {"outcome": "no error", "elapsed": time.time() - t0}
        except CollectiveError as e:
            return {"outcome": "collective_error",
                    "elapsed": time.time() - t0,
                    "is_timeout": isinstance(e, col.CollectiveTimeoutError),
                    "suspects": e.suspect_ranks}


def test_cross_backend_equivalence(ray_start_regular):
    """gather / ring / hier produce bitwise-identical results for arrays
    and pytrees, and ring's per-rank traffic is ~2(N-1)/N of the payload
    vs the gather coordinator's N x fan-in."""
    world = 3
    members = [Member.options(num_cpus=0.5).remote(i, world)
               for i in range(world)]
    results = {}
    for backend in ("gather", "ring", "hier"):
        group = f"eq_{backend}"
        results[backend] = ray_tpu_torch.get(
            [m.equivalence_run.remote(backend, group) for m in members],
            timeout=240)

    # every rank of every backend agrees bitwise with gather's rank 0
    ref = results["gather"][0]
    for backend, outs in results.items():
        for out in outs:
            assert np.array_equal(out["allreduce"], ref["allreduce"]), backend
            assert np.array_equal(out["tree"]["w"], ref["tree"]["w"]), backend
            assert np.array_equal(out["tree"]["b"][0], ref["tree"]["b"][0])
            assert out["tree"]["b"][1] == ref["tree"]["b"][1]
            assert out["allgather"] == [0, 11, 22], backend
            assert np.array_equal(out["broadcast"], np.arange(5) * 7)
            assert np.array_equal(out["async_allreduce"], ref["allreduce"])
            assert np.array_equal(out["big"], ref["big"])
            assert "not divisible by world_size" in out["ragged"], backend
        # reducescatter: rank r gets the r-th axis-0 block of the sum
        total = sum(_payload(r, (world * 2, 3)) for r in range(world))
        for rank, out in enumerate(outs):
            assert np.array_equal(out["reducescatter"],
                                  total[rank * 2:(rank + 1) * 2]), backend

    # transfer accounting: ring is bandwidth-optimal per rank...
    P = ref["big_nbytes"]
    ring_bound = 2 * (world - 1) / world * P
    for out in results["ring"]:
        assert out["stats"]["bytes_sent"] <= ring_bound * 1.05 + 4096, \
            out["stats"]
    # ...while the gather coordinator funnels world x payload through one
    # process (bytes_in counts every array the fleet sent it)
    assert results["gather"][0]["coord"]["bytes_in"] >= world * P


def test_chaos_member_death_raises(ray_start_regular):
    """Killing a rank mid-round surfaces CollectiveError on every
    survivor within the configured timeout — no deadlock."""
    world, timeout_s = 3, 6.0
    members = [Member.options(num_cpus=0.5).remote(i, world)
               for i in range(world)]
    refs = [m.chaos_run.remote("ring", "chaos", timeout_s,
                               die_after_round1=(i == 1))
            for i, m in enumerate(members)]
    # rank 1 exits after round 1; kill its actor AND mailbox (process
    # death takes both in production)
    assert ray_tpu_torch.get(refs[1], timeout=240)["outcome"] == "left"
    ray_tpu_torch.kill(members[1])
    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor("_collective_chaos_mbx1"))
    except ValueError:
        pass
    survivors = ray_tpu_torch.get([refs[0], refs[2]], timeout=240)
    for out in survivors:
        assert out["outcome"] == "collective_error", out
        # rank 2 waits on rank 1 directly (1 timeout); rank 0 waits on
        # rank 2's next hop (up to 2 chained timeouts) + probe slack
        assert out["elapsed"] < 4 * timeout_s + 15, out


def test_broadcast_all_none_regression(ray_start_regular):
    """Legacy bug: broadcast with no contributing src raised a bare
    StopIteration inside the coordinator's async handler."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective import api

    col.init_collective_group(1, 0, "bc_none", backend="gather")
    try:
        with pytest.raises(ValueError, match="no source rank provided data"):
            # rank != src_rank would send None; simulate by calling the
            # backend directly with a None payload for src
            api._group("bc_none")._instance("gather").broadcast(None, 0)
    finally:
        col.destroy_collective_group("bc_none")


def test_destroy_kills_named_actors(ray_start_regular):
    """destroy_collective_group must reap the coordinator AND mailboxes
    (the legacy version leaked one named actor per group name)."""
    from ray_tpu_torch import collective as col

    col.init_collective_group(1, 0, "lifecycle", backend="gather")
    col.barrier("lifecycle")
    assert ray_tpu_torch.get_actor("_collective_lifecycle") is not None
    assert ray_tpu_torch.get_actor("_collective_lifecycle_mbx0") is not None
    col.destroy_collective_group("lifecycle")
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            ray_tpu_torch.get_actor("_collective_lifecycle")
            time.sleep(0.2)
        except ValueError:
            break
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("_collective_lifecycle")
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("_collective_lifecycle_mbx0")


def test_topology_grouping_and_mesh_map():
    topo = Topology.build({0: "nA", 1: "nA", 2: "nB", 3: "nB", 4: "nB"})
    assert topo.num_nodes == 2 and topo.multi_node
    assert topo.leader_ranks() == (0, 2)
    assert topo.peers_on_node(4) == (2, 3, 4)
    assert topo.leader_of(1) == 0 and topo.is_leader(2)
    m = topo.mesh_axis_map()
    assert m["inter_node"]["size"] == 2
    assert m["inter_node"]["axes"] == ["dp", "pp"]
    assert "tp" in m["intra_node"]["axes"]
    assert not m["intra_node"]["uniform"]       # 2 vs 3 ranks per node
    single = Topology.build({0: "n", 1: "n"})
    assert not single.multi_node and single.leader_ranks() == (0,)


def test_backend_registry_and_auto_selection():
    from ray_tpu_torch.collective import (available_backends, register_backend,
                                    select_backend)
    from ray_tpu_torch.collective.registry import SMALL_PAYLOAD_BYTES, _BACKENDS

    assert {"gather", "ring", "hier"} <= set(available_backends())
    one_node = Topology.build({r: "n0" for r in range(8)})
    two_node = Topology.build({r: f"n{r % 2}" for r in range(8)})
    # cost-model selection under priors: latency-bound ops funnel through
    # the coordinator; bulk world-2 rides ring (zero-copy era: bytes
    # dominate and a 2-ring halves them); bulk with co-located ranks
    # rides hier — inside one shared-memory domain the ring's "parallel"
    # chunk copies contend for the same shm, so the funnel's O(1) rounds
    # price cheaper than the ring's O(N)
    assert select_backend("allreduce", 2, one_node, 1 << 30) == "ring"
    assert select_backend("allreduce", 2, one_node, 4 * 1024) == "gather"
    assert select_backend("allreduce", 8, one_node,
                          SMALL_PAYLOAD_BYTES - 1) == "gather"
    assert select_backend("allreduce", 8, one_node, 1 << 20) == "hier"
    assert select_backend("allreduce", 8, two_node, 1 << 20) == "hier"
    assert select_backend("barrier", 8, one_node) == "gather"
    assert select_backend("allgather", 8, one_node) == "gather"

    class FakeBackend:
        def __init__(self, ctx):
            self.ctx = ctx

    register_backend("fake", FakeBackend)
    try:
        assert "fake" in available_backends()
    finally:
        _BACKENDS.pop("fake", None)


def test_host_collective_without_a_free_cpu_raises(ray_start_regular):
    """Q2: a gang whose workers hold every CPU leaves none for the group's
    helper actors (HELPER_CPUS each). Setting the group up raises a
    CollectiveError naming the shortfall within the group's timeout; it
    does not block in the bootstrap allgather."""
    from ray_tpu_torch.collective.errors import CollectiveError
    from ray_tpu_torch.train.worker_group import WorkerGroup

    cpus = ray_tpu_torch.cluster_resources()["CPU"]
    wg = WorkerGroup(num_workers=int(cpus),
                     resources_per_worker={"CPU": 1.0})
    try:
        t0 = time.monotonic()
        with pytest.raises(CollectiveError, match="0 CPU free") as info:
            try:
                wg.init_host_collective("no_cpu", timeout_s=5.0)
            except ray_tpu_torch.exceptions.TaskError as e:
                raise e.cause
        took = time.monotonic() - t0
        assert "not placed within 5.0s" in str(info.value)
        assert took < 5.0 + 20.0, took
    finally:
        wg.shutdown()


def test_train_worker_group_host_collective(ray_start_regular, tmp_path):
    """WorkerGroup routes host-side exchanges through
    ray_tpu_torch.collective: after init_host_collective every gang member
    can allreduce."""
    from ray_tpu_torch.train.worker_group import WorkerGroup

    wg = WorkerGroup(num_workers=2, resources_per_worker={"CPU": 0.5})
    try:
        assert wg.init_host_collective("wg_col", backend="gather") == [True,
                                                                       True]

        def loop():
            from ray_tpu_torch import collective as col
            from ray_tpu_torch.train.session import get_context

            rank = get_context().world_rank
            total = col.allreduce(np.full((3,), float(rank + 1)), "wg_col")
            return total.tolist()

        wg.broadcast("setup", config={}, run_dir=str(tmp_path / "wg_col"),
                     scaling=None, checkpoint=None, datasets=None)
        outs = wg.broadcast("run", loop, {})
        assert outs == [[3.0, 3.0, 3.0]] * 2     # 1 + 2 on both ranks
        wg.destroy_host_collective("wg_col")
    finally:
        wg.shutdown()
