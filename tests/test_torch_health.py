"""Health plane: progress beacons, stall watchdog, straggler detection,
flight recorder, compiled-channel gauges (observability/health.py,
observability/flight.py).

The integration tests drive the acceptance path end to end: an injected
collective stall must surface as a StallEvent naming the suspect rank
within a couple of telemetry report intervals, and the stalled process
must leave a flight-recorder post-mortem behind.

Port of tests/test_health.py, aimed at ray_tpu_torch.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.observability import flight, health
from ray_tpu_torch.util import state
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def _poll(fn, timeout=10.0, interval=0.1):
    """Poll `fn` until it returns truthy or the deadline passes."""
    deadline = time.time() + timeout
    while True:
        out = fn()
        if out or time.time() > deadline:
            return out
        time.sleep(interval)


# --------------------------------------------------------------------------
# unit: beacons
# --------------------------------------------------------------------------

def test_beacon_lifecycle_and_registry():
    health._reset_for_tests()
    b = health.beacon("unit:loop", deadline_s=5.0)
    assert health.beacon("unit:loop", deadline_s=9.0) is b
    assert b.deadline_s == 9.0            # re-registration adopts deadline
    assert not b.busy and b.count == 0

    b.tick()
    b.arm(op="allreduce", waiting_on_rank=2)
    snap = b.snapshot()
    assert snap["count"] == 1 and snap["busy"]
    assert snap["context"] == {"op": "allreduce", "waiting_on_rank": 2}
    assert snap["age_s"] < 1.0

    b.disarm()
    assert not b.busy and b.context == {}

    assert [s["component"] for s in health.snapshot_beacons()] == ["unit:loop"]
    health.drop_beacon("unit:loop")
    assert health.snapshot_beacons() == []


def test_aggregator_stall_transition_and_recovery():
    agg = health.HealthAggregator()
    t0 = 1000.0
    busy = {"component": "collective:g:r1", "deadline_s": 2.0,
            "count": 7, "busy": True, "age_s": 0.1,
            "context": {"waiting_on_rank": 0}}

    assert agg.update("w1", "n1", [busy], now=t0) == []
    # same count, age past deadline -> stalled, exactly one event
    stale = dict(busy, age_s=2.5)
    assert agg.update("w1", "n1", [stale], now=t0 + 1) == ["collective:g:r1"]
    assert agg.update("w1", "n1", [stale], now=t0 + 2) == ["collective:g:r1"]
    events = agg.drain_fresh()
    assert len(events) == 1               # one event per stall episode
    ev = events[0]
    assert isinstance(ev, health.StallEvent)
    assert ev["kind"] == "stall" and ev["worker"] == "w1"
    assert ev.context["waiting_on_rank"] == 0
    assert agg.drain_fresh() == []

    # progress clears the stall; a NEW stall emits a new event
    assert agg.update("w1", "n1", [dict(busy, count=8)], now=t0 + 3) == []
    agg.update("w1", "n1", [dict(stale, count=8)], now=t0 + 4)
    assert len(agg.drain_fresh()) == 1

    report = agg.report(now=t0 + 5)
    assert report["beacons"][0]["component"] == "collective:g:r1"
    assert len(report["events"]) == 2


def test_aggregator_sweep_catches_dead_reporter():
    """A process whose agent died mid-stall stops reporting; the age as
    seen by the GCS keeps growing from the last report timestamp."""
    agg = health.HealthAggregator()
    t0 = 2000.0
    agg.update("w1", None, [{"component": "c", "deadline_s": 3.0,
                             "count": 1, "busy": True, "age_s": 0.0}], now=t0)
    assert agg.check(now=t0 + 1.0) == []
    fresh = agg.check(now=t0 + 5.0)       # 5s since last report > 3s deadline
    assert len(fresh) == 1 and fresh[0]["component"] == "c"
    # idle beacons never stall, no matter how old
    agg.update("w2", None, [{"component": "idle", "deadline_s": 1.0,
                             "count": 0, "busy": False,
                             "age_s": 99.0}], now=t0)
    assert agg.check(now=t0 + 100.0) == []


def test_aggregator_forget_worker_and_node():
    agg = health.HealthAggregator()
    snap = {"component": "c", "deadline_s": 1.0, "count": 1,
            "busy": True, "age_s": 0.0}
    agg.update("w1", "n1", [snap], now=0.0)
    agg.update("w2", "n2", [snap], now=0.0)
    agg.forget_worker("w1")
    agg.forget_node("n2")
    assert agg.check(now=1000.0) == []    # nothing left to stall


def test_straggler_flagged_once_against_peer_p95():
    agg = health.HealthAggregator(straggler_k=3.0, straggler_min_peers=5)
    t0 = 3000.0
    # five peers complete in ~0.1s
    for i in range(5):
        tid = f"t{i}"
        agg.observe_task_event({"task_id": tid, "name": "map", "ts": t0,
                                "state": "RUNNING", "worker": "w"})
        agg.observe_task_event({"task_id": tid, "name": "map",
                                "ts": t0 + 0.1, "state": "FINISHED"})
    # the sixth is still RUNNING way past k * p95
    agg.observe_task_event({"task_id": "t9", "name": "map", "ts": t0,
                            "state": "RUNNING", "worker": "w"})
    assert agg.check_stragglers(now=t0 + 0.2) == []       # not yet
    out = agg.check_stragglers(now=t0 + 10.0)
    assert len(out) == 1
    ev = out[0]
    assert ev["kind"] == "straggler" and ev["component"] == "task:map"
    assert ev.context["task_id"] == "t9" and ev.context["peers"] == 5
    assert ev.context["p95_s"] <= 0.25
    # flagged once, and completion clears the candidacy
    assert agg.check_stragglers(now=t0 + 20.0) == []
    agg.observe_task_event({"task_id": "t9", "name": "map",
                            "ts": t0 + 21.0, "state": "FINISHED"})
    assert "t9" not in agg._running


def test_straggler_needs_min_peers():
    agg = health.HealthAggregator(straggler_k=3.0, straggler_min_peers=5)
    agg.observe_task_event({"task_id": "a", "name": "m", "ts": 0.0,
                            "state": "RUNNING", "worker": "w"})
    agg.observe_task_event({"task_id": "a", "name": "m", "ts": 0.1,
                            "state": "FINISHED"})
    agg.observe_task_event({"task_id": "b", "name": "m", "ts": 0.0,
                            "state": "RUNNING", "worker": "w"})
    assert agg.check_stragglers(now=1000.0) == []         # 1 peer < 5


# --------------------------------------------------------------------------
# unit: flight recorder
# --------------------------------------------------------------------------

class _FakeRuntime:
    class _Wid:
        @staticmethod
        def hex():
            return "deadbeef0123"

    def __init__(self, tmp, size=64):
        from ray_tpu_torch.core.config import Config

        self.cfg = Config.load({"flight_recorder_size": size,
                                "flight_recorder_dir": str(tmp)})
        self.worker_id = self._Wid()
        self.node_id = "n1"
        self.mode = "worker"


def test_flight_recorder_ring_dump_and_rate_limit(tmp_path):
    fr = flight.FlightRecorder(_FakeRuntime(tmp_path, size=64))
    for i in range(100):
        fr.record({"kind": "span", "name": f"s{i}", "ts": float(i)})
    p1 = fr.dump("collective:allreduce:timeout", extra={"suspects": [2]})
    assert p1 and os.path.exists(p1)
    doc = flight.load_dump(p1)
    assert doc["reason"] == "collective:allreduce:timeout"
    assert doc["extra"]["suspects"] == [2]
    assert len(doc["events"]) == 64                        # ring bound
    assert doc["events"][-1]["name"] == "s99"
    assert doc["worker"] == "deadbeef0123"

    # same reason prefix inside the min interval -> rate-limited
    assert fr.dump("collective:other") is None
    # a different prefix and force both bypass the limit
    assert fr.dump("uncaught:ValueError") is not None
    assert fr.dump("collective:again", force=True) is not None
    assert fr.dumps_written == 3
    assert len(flight.list_dumps(str(tmp_path))) == 3


def test_flight_recorder_disabled_by_config(tmp_path):
    fr = flight.FlightRecorder(_FakeRuntime(tmp_path, size=0))
    fr.record({"kind": "span"})
    assert fr.dump("anything", force=True) is None
    assert flight.list_dumps(str(tmp_path)) == []


def test_flight_render_summary_and_chrome(tmp_path):
    fr = flight.FlightRecorder(_FakeRuntime(tmp_path))
    fr.record({"kind": "span", "name": "op::step", "ts": 1.0, "dur": 0.5,
               "worker": "w1"})
    fr.record({"kind": "channel_frame", "ts": 1.6, "channel": "ch1",
               "seq": 3, "frame_kind": "data", "nbytes": 128})
    fr.record({"kind": "instant", "name": "stall::collective:g:r1",
               "ts": 2.0, "worker": "w1"})
    path = fr.dump("stall:collective:g:r1")
    doc = flight.load_dump(path)
    text = flight.render_summary(doc)
    assert "stall:collective:g:r1" in text
    assert "channel_frame=1" in text and "span=1" in text
    assert "op::step" in text

    trace = flight.to_chrome(doc)
    phases = {e.get("ph") for e in trace}
    assert "i" in phases                  # instants + channel frames render
    names = {e.get("name") for e in trace}
    assert "stall::collective:g:r1" in names


def test_chrome_trace_renders_instants_and_channel_frames():
    from ray_tpu_torch.observability.timeline import chrome_trace

    trace = chrome_trace([
        {"kind": "instant", "name": "stall::c", "ts": 1.0, "worker": "w1",
         "component": "c", "age_s": 3.2},
        {"kind": "channel_frame", "ts": 1.1, "worker": "w1",
         "channel": "abcd", "seq": 0, "frame_kind": "data", "nbytes": 64},
    ])
    marks = [e for e in trace if e.get("ph") == "i"]
    assert len(marks) == 2
    stall = next(e for e in marks if e["name"] == "stall::c")
    assert stall["args"]["age_s"] == 3.2


# --------------------------------------------------------------------------
# integration: the acceptance path
# --------------------------------------------------------------------------

@ray_tpu_torch.remote
class _RingMember:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def run(self, group, straggle_s):
        from ray_tpu_torch import collective as col

        col.init_collective_group(self.world, self.rank, group,
                                  backend="ring", timeout_s=120)
        col.allreduce(np.ones(4), group)          # round 1: everyone alive
        if straggle_s:
            time.sleep(straggle_s)                # rank 0 stalls the ring
        return col.allreduce(np.ones(4), group).tolist()


@pytest.mark.slow
def test_collective_stall_names_suspect_rank_and_dumps(tmp_path):
    """Rank 0 goes quiet mid-round; the others' beacons (armed with the
    rank they wait on) must cross the stall deadline and surface as
    StallEvents — well before the collective's own 120s timeout — and
    the stalled workers must write flight-recorder post-mortems."""
    flight_dir = str(tmp_path / "flight")
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "collective_stall_deadline_s": 1.0,
        "flight_recorder_dir": flight_dir,
        "health_check_period_s": 0.2})
    try:
        world = 4
        members = [_RingMember.options(num_cpus=0.5).remote(i, world)
                   for i in range(world)]
        futs = [m.run.remote("stall_g", 8.0 if i == 0 else 0.0)
                for i, m in enumerate(members)]

        def _stalls():
            return [e for e in state.health_report()["events"]
                    if e["kind"] == "stall"
                    and e["component"].startswith("collective:stall_g")]

        events = _poll(_stalls, timeout=8.0)
        assert events, "no StallEvent within the detection window"
        # rank 1 waits on rank 0's chunk: the suspect is named
        assert any(e["context"].get("waiting_on_rank") == 0
                   for e in events), events
        comp = {e["component"] for e in events}
        assert any(c.endswith(":r1") for c in comp), comp

        # the GCS reply named the stalled components -> post-mortem dumps
        dumps = _poll(lambda: flight.list_dumps(flight_dir), timeout=8.0)
        assert dumps, "stalled worker wrote no flight dump"
        doc = flight.load_dump(dumps[-1])
        assert doc["reason"].startswith("stall:")
        assert any("collective:stall_g" in str(c)
                   for c in doc["extra"].get("stalled", []))

        # stall events render as timeline instants
        names = [e.get("name", "") for e in ray_tpu_torch.timeline(limit=5000)]
        assert any(str(n).startswith("stall::collective:stall_g")
                   for n in names)

        # the ring recovers once rank 0 wakes: correctness is unharmed
        assert all(out == [4.0] * 4
                   for out in ray_tpu_torch.get(futs, timeout=60))
        # recovery clears the stalled flag in the beacon view
        assert _poll(lambda: all(
            not b["stalled"] for b in state.health_report()["beacons"]),
            timeout=10.0)
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _peer_task(secs):
    time.sleep(secs)
    return os.getpid()


def test_slow_task_flagged_straggler(ray_start_regular):
    # six fast peers build the per-name duration histogram
    ray_tpu_torch.get([_peer_task.remote(0.02) for _ in range(6)], timeout=30)
    slow = _peer_task.remote(5.0)          # >> 3 x p95(0.02s peers)

    def _stragglers():
        return [e for e in state.health_report()["events"]
                if e["kind"] == "straggler"
                and e["component"] == "task:_peer_task"]

    events = _poll(_stragglers, timeout=10.0)
    assert events, "slow task never flagged"
    ev = events[0]
    assert ev["context"]["peers"] >= 5
    assert ev["age_s"] > ev["deadline_s"]
    # straggler instants reach the timeline too
    names = [e.get("name", "") for e in ray_tpu_torch.timeline(limit=5000)]
    assert any(str(n).startswith("straggler::task:_peer_task")
               for n in names)
    ray_tpu_torch.get(slow, timeout=30)


def test_actor_death_writes_flight_dump_blackbox_renders(tmp_path, capsys):
    flight_dir = str(tmp_path / "flight")
    ray_tpu_torch.init(num_cpus=2,
                 _system_config={"flight_recorder_dir": flight_dir,
                                 "health_check_period_s": 0.2})
    try:
        @ray_tpu_torch.remote
        class Victim:
            def pid(self):
                return os.getpid()

            def boom(self):
                os._exit(1)

        v = Victim.remote()
        ray_tpu_torch.get(v.pid.remote(), timeout=30)
        with pytest.raises(Exception):
            ray_tpu_torch.get(v.boom.remote(), timeout=30)

        def _dump_after_death():
            # keep poking the corpse: once the GCS registers the death,
            # the failing call dumps the driver-side black box
            try:
                ray_tpu_torch.get(v.pid.remote(), timeout=5)
            except Exception:
                pass
            return flight.list_dumps(flight_dir)

        dumps = _poll(_dump_after_death, timeout=15.0, interval=0.3)
        assert dumps, "actor death left no post-mortem"
        doc = flight.load_dump(dumps[-1])
        assert doc["reason"].split(":")[0] in (
            "actor_died", "worker_crashed", "uncaught")

        # cli blackbox: list, render, chrome export
        from ray_tpu_torch import cli

        cli.cmd_blackbox(argparse.Namespace(
            dir=flight_dir, list=True, index=None, chrome=None, tail=20))
        listing = capsys.readouterr().out
        assert "[0]" in listing and "reason=" in listing

        cli.cmd_blackbox(argparse.Namespace(
            dir=flight_dir, list=False, index=0, chrome=None, tail=20))
        rendered = capsys.readouterr().out
        assert "reason" in rendered and "events" in rendered

        out_json = str(tmp_path / "bb_trace.json")
        cli.cmd_blackbox(argparse.Namespace(
            dir=flight_dir, list=False, index=0, chrome=out_json, tail=20))
        with open(out_json) as f:
            trace = json.load(f)
        assert isinstance(trace, list)
        # driver-side dumps hold submission states (PENDING -> terminal,
        # no RUNNING) — they must still render, not merge to empty
        assert [e for e in trace if e.get("ph") in ("X", "i")], \
            "flight dump rendered to an empty chrome trace"
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Echo:
    def fwd(self, x):
        return x


def test_channel_gauges_and_dag_spans_after_compiled_execute(
        ray_start_regular):
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.util import metrics

    with InputNode() as inp:
        dag = _Echo.bind().fwd.bind(inp)
    compiled = dag.experimental_compile()
    try:
        for i in range(5):
            assert compiled.execute(i).get(timeout=30) == i

        # worker-side channel instruments reach the merged metrics plane
        text = _poll(
            lambda: (lambda t: t if "ray_tpu_channel_queue_depth" in t
                     and "ray_tpu_channel_hop_seconds" in t else "")(
                metrics.prometheus_text()),
            timeout=10.0)
        assert text, "channel gauges never reached the metrics plane"
        assert "ray_tpu_channel_inflight_seq" in text

        # every compiled execute leaves a driver-side span on the timeline
        def _spans():
            return [e for e in ray_tpu_torch.timeline(limit=5000)
                    if str(e.get("name", "")).startswith("dag::")]

        spans = _poll(_spans, timeout=10.0)
        assert len(spans) >= 5
        assert all(e.get("attrs", {}).get("ok") for e in spans[:5])
    finally:
        compiled.teardown()


def test_list_placement_groups_and_cli(ray_start_regular):
    from ray_tpu_torch.util.placement_group import placement_group

    pg = placement_group([{"CPU": 1}], strategy="PACK", name="health_pg")
    assert pg.ready(timeout=15)
    pending = placement_group([{"CPU": 4096}], strategy="PACK")

    def _view():
        pgs = {p["pg_id"]: p for p in state.list_placement_groups()}
        mine = pgs.get(pg.id.hex())
        infeasible = pgs.get(pending.id.hex())
        if mine and mine["state"] == "CREATED" \
                and infeasible and infeasible["state"] == "PENDING":
            return mine, infeasible
        return None

    got = _poll(_view, timeout=10.0)
    assert got, state.list_placement_groups()
    mine, infeasible = got
    assert mine["name"] == "health_pg" and mine["strategy"] == "PACK"
    assert mine["bundles"][0]["node_id"]          # placed -> node assigned
    assert mine["bundles"][0]["resources"] == {"CPU": 1.0}
    assert infeasible["bundles"][0]["node_id"] is None


def test_memory_summary_spilling_gauges(ray_start_regular):
    ref = ray_tpu_torch.put(np.ones(64 * 1024))
    ms = state.memory_summary()
    for key in ("store_occupancy", "store_pinned_bytes",
                "store_pinned_objects", "store_pin_count_distribution"):
        assert key in ms, key
    assert isinstance(ms["store_pin_count_distribution"], dict)
    assert ms["store_bytes_in_use"] > 0
    del ref
    # per-node view fills in once nodelet agents push node_stats
    nodes = _poll(lambda: state.memory_summary()["nodes"], timeout=12.0)
    assert nodes, "no node_stats reached the GCS KV"
    node = next(iter(nodes.values()))
    assert "store_occupancy" in node and "store_capacity" in node


def test_cluster_summary_drop_counters(ray_start_regular):
    summary = state.cluster_summary()
    assert summary["task_events_dropped"] == 0.0
    assert summary["telemetry_reports_dropped"] == 0.0


def test_cli_doctor_healthy_cluster(ray_start_regular):
    addr = ray_start_regular["address"]
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "doctor", "--address", addr],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "doctor: all checks passed" in out.stdout
    assert "[ok] nodes alive" in out.stdout
    assert "[ok] drop counters zero" in out.stdout
