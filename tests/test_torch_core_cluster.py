"""Multi-node behavior: spillback scheduling, object transfer, placement
groups, node failure + actor restart, lineage reconstruction.

Reference test models: python/ray/tests/test_multinode_failures*.py,
test_reconstruction*.py, test_placement_group*.py.

Port of tests/test_core_cluster.py, aimed at ray_tpu_torch.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy, placement_group)
from torch_runtime_support import ray_start_cluster, reap_orphans  # noqa: F401


def test_spillback_across_nodes(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 1.0})
    cluster.add_node(resources={"CPU": 1.0, "gadget": 1.0})
    cluster.connect()

    @ray_tpu_torch.remote(num_cpus=1, resources={"gadget": 1})
    def where():
        import os

        return os.getpid()

    # must run on the gadget node even though the driver's local node lacks it
    assert isinstance(ray_tpu_torch.get(where.remote()), int)


def test_object_transfer_between_nodes(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 1.0, "a": 1.0})
    cluster.add_node(resources={"CPU": 1.0, "b": 1.0})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"a": 1})
    def produce():
        return np.arange(300_000, dtype=np.float64)

    @ray_tpu_torch.remote(resources={"b": 1})
    def consume(arr):
        return float(arr.sum())

    ref = produce.remote()
    expected = float(np.arange(300_000, dtype=np.float64).sum())
    assert ray_tpu_torch.get(consume.remote(ref)) == expected
    # and the driver can read it too (pull to its node)
    assert float(ray_tpu_torch.get(ref).sum()) == expected


def test_placement_group_pack_and_task(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 2.0})
    cluster.add_node(resources={"CPU": 2.0})
    cluster.connect()

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=15)

    @ray_tpu_torch.remote(num_cpus=1,
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=0))
    def inside():
        return "ok"

    assert ray_tpu_torch.get(inside.remote()) == "ok"


def test_placement_group_strict_spread(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 1.0})
    cluster.add_node(resources={"CPU": 1.0})
    cluster.connect()

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=15)
    table = pg.table()
    nodes = {b["node_id"].hex() for b in table["bundles"]}
    assert len(nodes) == 2


def test_placement_group_infeasible_pending(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 1.0})
    cluster.connect()

    pg = placement_group([{"CPU": 64}], strategy="PACK")
    # Poll to the condition instead of one fixed-length ready() gamble:
    # first wait until the GCS has registered the PG at all (under load
    # the create RPC + scheduler pass can outlast a fixed 1.5s), then
    # assert it sits PENDING — 64 CPUs can never fit on this cluster.
    deadline = time.time() + 10
    pg_state = None
    while time.time() < deadline:
        table = pg.table()
        pg_state = table["state"] if table else None
        if pg_state is not None:
            break
        time.sleep(0.05)
    assert pg_state == "PENDING", pg_state
    assert not pg.ready(timeout=0.5)


@pytest.mark.slow
def test_node_death_actor_restart(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 2.0})           # driver's node
    doomed = cluster.add_node(resources={"CPU": 2.0, "doomed": 1.0})
    cluster.connect()

    @ray_tpu_torch.remote
    class Survivor:
        def where(self):
            import os

            return os.getpid()

    a = Survivor.options(
        max_restarts=2, max_task_retries=4,
        resources={"doomed": 0.001}).remote()
    pid1 = ray_tpu_torch.get(a.where.remote())
    cluster.remove_node(doomed)
    # After the health-check threshold the GCS restarts the actor elsewhere —
    # but "doomed" only existed there, so give the restart a fallback:
    # (actor resources keep requiring doomed; expect DEAD instead)
    deadline = time.time() + 20
    saw_failure = False
    while time.time() < deadline:
        try:
            ray_tpu_torch.get(a.where.remote(), timeout=5)
        except Exception:
            saw_failure = True
            break
        time.sleep(0.3)
    assert saw_failure


def test_lineage_reconstruction(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 2.0})           # stable node (driver)
    volatile = cluster.add_node(resources={"CPU": 2.0, "volatile": 1.0})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"volatile": 0.001}, max_retries=2)
    def produce():
        return np.ones(300_000, dtype=np.float64)     # big -> store-resident

    ref = produce.remote()
    assert float(ray_tpu_torch.get(ref).sum()) == 300_000.0
    # Kill the node holding the only copy. The object is lost; a later get
    # must re-execute the producing task via lineage — but the task needs
    # "volatile", which died with the node, so reconstruction must surface
    # ObjectLostError... unless we give it somewhere to go:
    cluster.add_node(resources={"CPU": 2.0, "volatile": 1.0})

    def _alive_nodes():
        from ray_tpu_torch.util import state

        return sum(1 for n in state.list_nodes() if n["alive"])

    def _wait(pred, timeout=20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.1)
        return False

    # the replacement node must be REGISTERED before the volatile one dies,
    # or reconstruction has nowhere to go (fixed sleeps here were flaky
    # under load)
    assert _wait(lambda: _alive_nodes() == 3), "replacement never registered"
    cluster.remove_node(volatile)
    assert _wait(lambda: _alive_nodes() == 2), "node death never detected"
    out = ray_tpu_torch.get(ref, timeout=60)
    assert float(out.sum()) == 300_000.0


def test_locality_aware_lease_target(ray_start_cluster):
    """DEFAULT-strategy tasks lease from the node holding their big args
    (ref: lease_policy.h LocalityAwareLeasePolicy)."""
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 2.0})                 # driver's node
    remote_node = cluster.add_node(resources={"CPU": 2.0, "b": 1.0})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"b": 0.001})
    def produce():
        return np.ones(300_000, dtype=np.float64)   # big -> store-resident

    @ray_tpu_torch.remote
    def where(arr):
        from ray_tpu_torch.core.runtime import get_runtime

        return (float(arr.sum()), tuple(get_runtime().nodelet_addr))

    ref = produce.remote()
    ray_tpu_torch.wait([ref], timeout=30)
    total, addr = ray_tpu_torch.get(where.remote(ref), timeout=60)
    assert total == 300_000.0
    assert addr == tuple(remote_node.addr)          # followed the data

    # Small (inlined) args don't steer placement off the local node.
    from ray_tpu_torch.core.runtime import get_runtime as _grt

    driver_nodelet = tuple(_grt().nodelet_addr)
    small = ray_tpu_torch.put(3)

    @ray_tpu_torch.remote
    def where_small(x):
        from ray_tpu_torch.core.runtime import get_runtime

        return tuple(get_runtime().nodelet_addr)

    assert ray_tpu_torch.get(where_small.remote(small),
                       timeout=60) == driver_nodelet

    # Mixed locality in the same scheduling class: each task follows its
    # own data, so pipelined leases never drag a task off its data's node.
    local_big = ray_tpu_torch.put(np.ones(300_000))
    ref2 = produce.remote()
    a = where.remote(ref2)
    b = where.remote(local_big)
    (_, addr_a), (_, addr_b) = ray_tpu_torch.get([a, b], timeout=60)
    assert addr_a == tuple(remote_node.addr)
    assert addr_b == driver_nodelet


def test_broadcast_copies_register_and_spread(ray_start_cluster):
    """Large-object fan-out (ref: release/benchmarks 1 GiB broadcast to
    50+ nodes): pulled copies register with the owner so later pullers
    spread across existing holders instead of hammering the producer."""
    import numpy as np

    from ray_tpu_torch import _rt

    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 1.0, "producer": 1.0})
    for _ in range(3):
        # consumers pinned off the producer node (locality targeting
        # would otherwise pipeline every consumer onto the producer —
        # zero-copy, but nothing to broadcast)
        cluster.add_node(resources={"CPU": 2.0, "consumer": 2.0})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"producer": 1})
    def make_big():
        return np.arange(600_000, dtype=np.float64)  # ~4.8 MB, store tier

    @ray_tpu_torch.remote(num_cpus=1, resources={"consumer": 1})
    def consume(a):
        return float(a[123]) + float(a[-1])

    ref = make_big.remote()
    ray_tpu_torch.wait([ref], timeout=60)

    out = ray_tpu_torch.get([consume.remote(ref) for _ in range(9)], timeout=120)
    assert out == [123.0 + 599_999.0] * 9

    # the owner's directory now lists secondary copies beyond the
    # producer's node (the emergent broadcast tree)
    rt = _rt.get_runtime()
    entry = rt.directory.get(ref.id)
    assert entry is not None
    assert len(entry.locations) >= 2, entry.locations


def test_native_transfer_plane_carries_pull(ray_start_cluster):
    """Inter-node pulls ride the native xfer plane when available; the
    transferred bytes must be intact (regression for the shm->socket
    zero-staging path in native/xfer.cc)."""
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 1.0, "a": 1.0})
    cluster.add_node(resources={"CPU": 1.0, "b": 1.0})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"a": 1})
    def produce():
        # big enough to skip the inline/memory-store path
        return np.arange(1_500_000, dtype=np.int64)

    @ray_tpu_torch.remote(resources={"b": 1})
    def consume(arr):
        return int(arr.sum())

    ref = produce.remote()
    n = 1_500_000
    assert ray_tpu_torch.get(consume.remote(ref)) == n * (n - 1) // 2

    # prove the native plane carried it (not the chunk-RPC fallback)
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    native_pulls = 0
    for n in ray_tpu_torch.nodes():
        stats = rt._run(rt.pool.get(tuple(n["NodeletAddress"])).call(
            "node_stats"))
        assert stats["xfer_port"] > 0
        native_pulls += stats["native_pulls"]
    assert native_pulls >= 1


def test_placement_group_task_on_remote_bundle_node(ray_start_cluster):
    """PG-task leases must target the BUNDLE's node: with the bundle
    forced onto a node other than the driver's, the lease request would
    loop "bundle not here" against the driver's nodelet forever
    (regression: surfaced when bundle packing switched to
    least-utilized placement; ref: PG dispatch against the reserving
    raylet)."""
    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 0.5})    # head = driver's node
    cluster.add_node(resources={"CPU": 2.0})    # only here bundles fit
    cluster.connect()

    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=15)
    table = pg.table()
    bundle_node = table["bundles"][0]["node_id"]

    from ray_tpu_torch.core.runtime import get_runtime

    nodes = get_runtime().gcs_call("get_nodes")
    bundle_addr = next(tuple(n.nodelet_addr) for n in nodes
                       if n.node_id == bundle_node)

    @ray_tpu_torch.remote(num_cpus=1,
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=0))
    def where():
        from ray_tpu_torch.core.runtime import get_runtime

        return tuple(get_runtime().nodelet_addr)

    assert ray_tpu_torch.get(where.remote(), timeout=60) == bundle_addr


def test_node_affinity_targets_each_node(ray_start_cluster):
    """NODE_AFFINITY must land the task on ITS node even when a parked
    lease from a different node's affinity task is available for reuse
    (regression: scheduling_class omitted the target node, so every
    affinity task reused the first lease and ran on the driver's node —
    which also silently faked the broadcast benchmark)."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    cluster = ray_start_cluster
    cluster.add_node(resources={"CPU": 2.0})
    cluster.add_node(resources={"CPU": 2.0})
    cluster.connect()

    @ray_tpu_torch.remote(num_cpus=0.5)
    def who():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    import time

    deadline = time.time() + 30
    nodes = []
    while time.time() < deadline and len(nodes) < 2:
        nodes = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
        time.sleep(0.2)
    assert len(nodes) >= 2
    # back-to-back so the previous task's parked lease is warm — the
    # reuse path, not the fresh-lease path, is what regressed
    for n in nodes:
        got = ray_tpu_torch.get(who.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=n["NodeID"])).remote(), timeout=120)
        assert got == n["NodeID"], f"ran on {got[:8]}, wanted {n['NodeID'][:8]}"


def test_peer_sourced_pull_under_busy_source():
    """Serve-cap busy replies route a pull to a PEER holder: with the
    primary's single serve slot deliberately occupied, a second node's
    pull must complete by fetching the registered copy from the first
    puller's node — the broadcast distribution tree forming WITHIN one
    fan-in, not just across sequential waves (ref: pull_manager.h:52
    pulls spread across every holder; VERDICT r4 weak #8)."""
    import socket
    import threading

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.runtime import get_runtime

    cluster = Cluster(
        initialize_head=True, head_resources={"CPU": 2.0},
        system_config={"object_serve_concurrency": 1,
                       "health_check_period_s": 0.2})
    try:
        cluster.add_node(resources={"CPU": 1.0, "b": 1.0})
        cluster.add_node(resources={"CPU": 1.0, "c": 1.0})
        cluster.connect()

        rt = get_runtime()
        primary_addr = tuple(rt.nodelet_addr)

        # 64 MiB: big enough that an in-flight serve holds its slot for
        # the whole window the slow-reader trick needs
        arr = np.arange(8 * 1024 * 1024, dtype=np.float64)
        ref = ray_tpu_torch.put(arr)
        expected = float(arr[123])

        @ray_tpu_torch.remote(num_cpus=0.5)
        def pull_and_report(refs):
            import ray_tpu_torch as rtpu
            from ray_tpu_torch.core.runtime import get_runtime as gr

            val = rtpu.get(refs[0])
            src = gr()._pull_sources.get(refs[0].id)
            return float(val[123]), src

        # phase 1: node b pulls unencumbered -> primary-sourced, and the
        # owner learns b now holds a copy
        v, src_b = ray_tpu_torch.get(
            pull_and_report.options(resources={"b": 1}).remote([ref]),
            timeout=120)
        assert v == expected
        assert tuple(src_b) == primary_addr

        # phase 2: occupy the primary's ONLY serve slot (cap 1) with a
        # slow reader: send the id, read the 8-byte size, then stall —
        # the server blocks in the payload write
        xa = rt._run(rt.pool.get(rt.nodelet_addr).call("xfer_addr"))
        assert xa["port"] > 0
        hog = socket.create_connection((xa["host"], xa["port"]), timeout=30)
        hog.sendall(ref.id.binary())
        hdr = b""
        while len(hdr) < 8:
            chunk = hog.recv(8 - len(hdr))
            assert chunk
            hdr += chunk
        release = threading.Event()

        def _hold():
            release.wait(timeout=120)
            hog.close()

        t = threading.Thread(target=_hold, daemon=True)
        t.start()

        try:
            # deterministic protocol check: with the only slot held, a
            # second raw request must get the kBusy sentinel (2^64-2)
            import struct

            probe = socket.create_connection((xa["host"], xa["port"]),
                                             timeout=30)
            probe.sendall(ref.id.binary())
            hdr2 = b""
            while len(hdr2) < 8:
                chunk = probe.recv(8 - len(hdr2))
                assert chunk
                hdr2 += chunk
            probe.close()
            assert struct.unpack("<Q", hdr2)[0] == (1 << 64) - 2, \
                "expected a busy reply while the serve slot was held"

            # phase 3: node c pulls WHILE the primary is saturated. The
            # busy reply + location refresh must route it to b's copy
            # (c may also shuffle straight to b — either way the pull
            # must complete peer-sourced while the primary is wedged).
            v, src_c = ray_tpu_torch.get(
                pull_and_report.options(resources={"c": 1}).remote([ref]),
                timeout=120)
            assert v == expected
            assert src_c is not None and tuple(src_c) != primary_addr, \
                f"expected a peer-sourced pull, got {src_c}"
        finally:
            release.set()
            t.join(timeout=10)

        stats = rt._run(rt.pool.get(rt.nodelet_addr).call("node_stats"))
        assert stats["serve_busy_rejections"] >= 1
    finally:
        cluster.shutdown()
