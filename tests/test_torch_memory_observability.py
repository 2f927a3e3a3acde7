"""Memory attribution plane (observability/memory.py).

Tracker/aggregator units run without a cluster; the cluster half checks
the end-to-end invariants: attributed store bytes cover the store's used
bytes, temperature orders by staggered reads, and the leak detector
flags a deliberately orphaned pin (and never a live one).

Port of tests/test_memory_observability.py, aimed at ray_tpu_torch.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.observability.memory import (MemoryAggregator, MemoryTracker,
                                          tracker)
from torch_runtime_support import reap_orphans  # noqa: F401


def _poll(fn, timeout=10.0, interval=0.1):
    """Poll fn() until truthy; returns the last value (truthy or not)."""
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out or time.monotonic() >= deadline:
            return out
        time.sleep(interval)


# ---------------------------------------------------------------- tracker


def test_tracker_attribute_and_retag():
    t = MemoryTracker()
    t.attribute("obj1", "user", 100)
    t.attribute("obj2", "kv", 50, store=False)
    assert t.subsystem_bytes() == {"user": 100, "kv": 50}
    # re-attribute resizes in place
    t.attribute("obj1", "user", 300)
    assert t.subsystem_bytes()["user"] == 300
    # retag upgrades user -> specific and moves the bytes
    t.retag("obj1", "data", op="map")
    sub = t.subsystem_bytes()
    assert sub["data"] == 300 and sub.get("user", 0) == 0
    # a later generic re-attribute must NOT downgrade back to user
    t.attribute("obj1", "user", 300)
    assert t.subsystem_bytes()["data"] == 300
    snap = t.snapshot()
    rec = {r["key"]: r for r in snap["records"]}
    assert rec["obj1"]["subsystem"] == "data"
    assert rec["obj1"]["detail"]["op"] == "map"
    assert snap["retags"]["obj1"]["subsystem"] == "data"


def test_tracker_pin_counts_and_release():
    t = MemoryTracker()
    t.attribute("o", "user", 10)
    t.pin("o", "read")
    t.pin("o", "read")
    t.pin("o", "await_ack", ack_key="k1", waiter_rank=3)
    snap = t.snapshot()
    pins = snap["records"][0]["pins"]
    assert pins["read"]["count"] == 2
    assert pins["await_ack"] == {"count": 1, "ack_key": "k1",
                                 "waiter_rank": 3}
    t.unpin("o", "read")
    t.unpin("o", "read")
    t.unpin("o", "await_ack")
    assert not t.snapshot()["records"][0]["pins"]
    t.release("o")
    assert t.snapshot() is None
    assert t.subsystem_bytes().get("user", 0) == 0


def test_tracker_orphan_lifecycle():
    t = MemoryTracker()
    # owner dies with no pins: record just drops
    t.attribute("clean", "user", 5)
    t.owner_ref_dead("clean")
    assert t.snapshot() is None
    # owner dies while pinned: record orphans, ships an orphan age,
    # and the LAST unpin finally drops it
    t.attribute("leak", "user", 7)
    t.pin("leak", "read")
    t.owner_ref_dead("leak")
    rec = t.snapshot()["records"][0]
    assert rec["orphan_s"] >= 0.0 and rec["pins"]
    t.unpin("leak", "read")
    assert t.snapshot() is None


def test_tracker_snapshot_validates_against_store():
    class Oid:                       # ObjectID-shaped key (hashable + .hex)
        def __init__(self, h):
            self._h = h

        def hex(self):
            return self._h

    t = MemoryTracker()
    t.attribute(Oid("gone"), "user", 10)     # pin-free: prunable
    held = Oid("held")
    t.attribute(held, "user", 20)
    t.pin(held, "primary")                   # pinned: never pruned
    t.attribute("synth", "kv", 30, store=False)   # synthetic: never pruned
    snap = t.snapshot(validate=lambda k: False)
    keys = {r["key"] for r in snap["records"]}
    assert keys == {"held", "synth"}
    assert t.subsystem_bytes() == {"user": 20, "kv": 30}


def test_tracker_temperature_ordering_staggered_touches():
    t = MemoryTracker()
    t.attribute("cold", "user", 1)
    t.attribute("hot", "user", 1)
    t.touch("cold")
    time.sleep(0.05)
    for _ in range(3):
        t.touch("hot")
    rec = {r["key"]: r for r in t.snapshot()["records"]}
    assert rec["hot"]["idle_s"] < rec["cold"]["idle_s"]
    assert rec["hot"]["access_count"] == 3
    assert rec["cold"]["access_count"] == 1


def test_tracker_disabled_is_inert():
    t = MemoryTracker()
    t.enabled = False
    t.attribute("o", "user", 10)
    t.pin("o", "read")
    assert t.snapshot() is None


# ------------------------------------------------------------- aggregator


def _payload(records, retags=None, sub=None):
    return {"ts": time.time(), "pid": 1,
            "subsystems": sub or {}, "subsystems_hwm": sub or {},
            "records": records, "records_total": len(records),
            "records_overflow": 0,
            **({"retags": retags} if retags else {})}


def test_aggregator_merges_and_classifies():
    agg = MemoryAggregator(leak_suspect_s=5.0, cold_after_s=10.0)
    # owner sees the object as plain user bytes with a primary pin...
    agg.update("w1", "nodeA", _payload([
        {"key": "aa", "subsystem": "user", "nbytes": 100, "store": True,
         "owner": "w1", "task": None, "pins": {"primary": {"count": 1}},
         "age_s": 1.0, "idle_s": 1.0, "access_count": 1}]))
    # ...the collective layer on the same node knows better
    agg.update("w2", "nodeA", _payload([
        {"key": "aa", "subsystem": "collective", "nbytes": 100,
         "store": True, "owner": None, "task": None,
         "pins": {"await_ack": {"count": 1, "ack_key": "k",
                                "waiter_rank": 2}},
         "age_s": 0.5, "idle_s": 0.2, "access_count": 4},
        {"key": "bb", "subsystem": "user", "nbytes": 40, "store": True,
         "owner": "w2", "task": None, "pins": {},
         "age_s": 30.0, "idle_s": 30.0, "access_count": 0},
        {"key": "cc", "subsystem": "user", "nbytes": 7, "store": True,
         "owner": "w2", "task": None, "pins": {"read": {"count": 1}},
         "age_s": 30.0, "idle_s": 9.0, "access_count": 1,
         "orphan_s": 20.0}]))
    rep = agg.report(node_stats={"nodeA": {"store_bytes": 147,
                                           "store_capacity": 1000}})
    assert rep["records"] == 3
    # merge: specific subsystem won, pins unioned, freshest access kept
    merged = {r["key"]: r for r in rep["top_holders"]}
    assert merged["aa"]["subsystem"] == "collective"
    assert set(merged["aa"]["pins"]) == {"primary", "await_ack"}
    assert merged["aa"]["pins"]["await_ack"]["ack_key"] == "k"
    assert merged["aa"]["idle_s"] < 1.0
    assert rep["subsystem_store_bytes"] == {"collective": 100, "user": 47}
    # bb: unpinned and idle past cold_after_s -> the spill candidate
    assert [r["key"] for r in rep["spill_candidates"]] == ["bb"]
    assert rep["spill_candidate_bytes"] == 40
    # cc: still pinned, owner dead past leak_suspect_s -> the leak
    assert [r["key"] for r in rep["leak_suspects"]] == ["cc"]
    # coverage: 147 of 147 store bytes attributed
    assert rep["nodes"]["nodeA"]["coverage"] == 1.0
    agg.forget_node("nodeA")
    assert agg.report()["records"] == 0


def test_aggregator_applies_cross_process_retags():
    agg = MemoryAggregator()
    agg.update("worker", "n", _payload([
        {"key": "blk", "subsystem": "user", "nbytes": 64, "store": True,
         "owner": "worker", "task": None, "pins": {},
         "age_s": 0.0, "idle_s": 0.0, "access_count": 0}]))
    agg.update("driver", "n", _payload(
        [], retags={"blk": {"subsystem": "data"}}))
    rep = agg.report()
    assert rep["top_holders"][0]["subsystem"] == "data"
    assert rep["subsystem_store_bytes"] == {"data": 64}


def test_aggregator_drops_stale_reporters():
    """A payload not refreshed within stale_after_s means the reporter
    died — its pins (read views, staged chunks) died with it, so its
    records must not linger as false leak suspects."""
    agg = MemoryAggregator(leak_suspect_s=1.0, stale_after_s=30.0)
    agg.update("dead", "n", _payload([
        {"key": "gone", "subsystem": "user", "nbytes": 64, "store": True,
         "owner": "dead", "task": None, "pins": {"read": {"count": 1}},
         "age_s": 5.0, "idle_s": 5.0, "access_count": 1,
         "orphan_s": 5.0}]))
    agg.update("live", "n", _payload([
        {"key": "here", "subsystem": "user", "nbytes": 32, "store": True,
         "owner": "live", "task": None, "pins": {},
         "age_s": 1.0, "idle_s": 1.0, "access_count": 1}]))
    # backdate the dead reporter's receipt past the staleness horizon
    node, _, payload = agg._payloads["dead"]
    agg._payloads["dead"] = (node, time.time() - 60.0, payload)
    rep = agg.report()
    assert [r["key"] for r in rep["top_holders"]] == ["here"]
    assert rep["leak_suspects"] == []
    assert "dead" not in agg._payloads


# ------------------------------------------------- non-store producers


def test_pagepool_registers_kv_bytes():
    from ray_tpu_torch.serve.paged_kv import PagePool

    pool = PagePool(num_pages=9, page_size=4, max_slots=2,
                    max_pages_per_slot=4, page_nbytes=1024)
    t = tracker()
    pool.grow(0, 10)          # 3 pages
    rec = t._recs.get(pool._mem_key)
    assert rec is not None and rec.subsystem == "kv"
    assert rec.nbytes == 3 * 1024
    pool.grow(1, 8)           # +2 pages
    assert t._recs[pool._mem_key].nbytes == 5 * 1024
    pool.release(0)
    pool.release(1)
    assert pool._mem_key not in t._recs


def test_data_opbuffer_retags_blocks():
    from ray_tpu_torch.data.execution.interfaces import (BlockMeta, OpBuffer,
                                                         RefBundle)

    class FakeRef:
        def __init__(self, key):
            self.id = key

    t = tracker()
    t.attribute("blk0", "user", 256)
    buf = OpBuffer()
    buf.append(RefBundle(FakeRef("blk0"), BlockMeta(nbytes=256, rows=4), 0))
    assert t._recs["blk0"].subsystem == "data"
    assert buf.nbytes == 256
    buf.popleft()
    assert t._recs["blk0"].access_count == 1
    t.release("blk0")


# ---------------------------------------------------------------- cluster


@pytest.fixture(scope="module")
def mem_cluster():
    info = ray_tpu_torch.init(
        num_cpus=4, ignore_reinit_error=True,
        _system_config={"health_check_period_s": 0.2,
                        "telemetry_report_interval_s": 0.2,
                        "metrics_report_interval_s": 0.4,
                        "memory_leak_suspect_s": 1.0,
                        "memory_cold_after_s": 0.5})
    yield info
    ray_tpu_torch.shutdown()


def _report(**kw):
    from ray_tpu_torch.util import state

    return state.memory_report(**kw)


def test_attribution_covers_store_bytes(mem_cluster):
    """The tentpole invariant: after a mixed workload the per-subsystem
    store-backed attribution decomposes (>=99% of) the store's used
    bytes, and a data-plane subsystem actually appears."""
    from ray_tpu_torch import data as rd

    refs = [ray_tpu_torch.put(np.full(1 << 18, i, np.uint8)) for i in range(4)]

    @ray_tpu_torch.remote
    def produce(i):
        return np.full(1 << 17, i, np.uint8)

    task_refs = [produce.remote(i) for i in range(3)]
    _ = [ray_tpu_torch.get(r) for r in task_refs]   # read pins + temperature
    # a small streaming-data run drives OpBuffer retags ("data")
    ds = rd.from_items(list(range(200)), num_blocks=4).map(lambda x: x * 2)
    assert len(ds.take_all()) == 200

    def covered():
        rep = _report()
        nodes = rep.get("nodes") or {}
        if not nodes:
            return None
        # compare against the LIVE store occupancy, not the sampled one:
        # node_stats lags by a report interval
        rt = ray_tpu_torch._rt.get_runtime()
        used = rt.store.bytes_in_use()
        attributed = sum(n.get("attributed_store_bytes", 0)
                         for n in nodes.values())
        if used and attributed >= 0.99 * used:
            return rep
        return None

    rep = _poll(covered, timeout=15.0)
    assert rep, "attribution never covered >=99% of store bytes"
    assert sum(rep["subsystem_store_bytes"].values()) > 0
    del refs, task_refs


def test_temperature_orders_staggered_reads(mem_cluster):
    cold_ref = ray_tpu_torch.put(np.zeros(1 << 18, np.uint8))
    hot_ref = ray_tpu_torch.put(np.zeros(1 << 18, np.uint8))
    time.sleep(0.6)
    for _ in range(3):
        ray_tpu_torch.get(hot_ref)

    def ordered():
        rep = _report(top_n=200)
        recs = {r["key"]: r for r in rep["top_holders"]}
        hot = recs.get(hot_ref.id.hex())
        cold = recs.get(cold_ref.id.hex())
        if hot and cold and hot["idle_s"] < cold["idle_s"] \
                and hot["access_count"] > cold["access_count"]:
            return (hot, cold)
        return None

    assert _poll(ordered, timeout=10.0), \
        "staggered reads did not order temperature"
    del cold_ref, hot_ref


def test_leak_detector_flags_orphaned_pin(mem_cluster):
    """Positive: a zero-copy read view outliving every owner ref is a
    pinned object with a dead owner — flagged within
    memory_leak_suspect_s. Negative: the same shape with the ref still
    alive never shows up."""
    live_ref = ray_tpu_torch.put(np.ones(1 << 18, np.uint8))
    live_view = ray_tpu_torch.get(live_ref)          # read-pinned, owner alive

    leak_ref = ray_tpu_torch.put(np.ones(1 << 18, np.uint8))
    leak_hex = leak_ref.id.hex()
    leak_view = ray_tpu_torch.get(leak_ref)          # read-pinned...
    del leak_ref                               # ...owner ref dropped

    def flagged():
        rep = _report(top_n=200)
        return [r for r in rep["leak_suspects"]
                if r["key"] == leak_hex] or None

    suspects = _poll(flagged, timeout=10.0)
    assert suspects, "orphaned pin was never flagged as a leak suspect"
    assert "read" in suspects[0]["pins"]
    assert suspects[0]["orphan_s"] >= 1.0

    # negative: the live object must not be a suspect
    rep = _report(top_n=200)
    assert not any(r["key"] == live_ref.id.hex()
                   for r in rep["leak_suspects"])
    assert live_view.sum() == len(live_view)
    del live_ref, live_view, leak_view
