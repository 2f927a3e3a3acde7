"""ray_tpu_torch.observability: batched TelemetryAgent, percentile histograms,
per-edge transfer telemetry, and the unified Chrome-trace timeline.

Reference test model: python/ray/tests/test_metrics_agent.py (batched
push, drop accounting) + test_task_events (buffer bounds) applied to the
single-channel telemetry design here.

Port of tests/test_observability.py, aimed at ray_tpu_torch.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import metrics, tracing
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


# --------------------------------------------------------------- hot path


def test_counter_inc_zero_sync_rpcs(ray_start_regular, monkeypatch):
    """Counter.inc() in a hot loop must never issue a synchronous RPC
    from the calling thread — batching is the whole point."""
    rt = ray_tpu_torch._rt.get_runtime()
    me = threading.get_ident()
    calls = []
    orig = rt.gcs_call

    def spy(method, *a, **kw):
        if threading.get_ident() == me:
            calls.append(method)
        return orig(method, *a, **kw)

    monkeypatch.setattr(rt, "gcs_call", spy)
    c = metrics.Counter("obs_hot_counter", description="hot loop")
    before = list(calls)
    for _ in range(10_000):
        c.inc()
    assert calls == before
    # read-your-writes: prometheus_text flushes the agent synchronously
    monkeypatch.setattr(rt, "gcs_call", orig)
    assert "obs_hot_counter 10000.0" in metrics.prometheus_text()


def test_agent_batches_one_report_per_flush(ray_start_regular):
    """Thousands of increments collapse into a couple of batched
    reports, not one RPC per increment (the pre-agent behavior)."""
    rt = ray_tpu_torch._rt.get_runtime()
    agent = rt.telemetry
    agent.flush(wait=True)  # drain startup events
    sent0 = agent.reports_sent
    c = metrics.Counter("obs_batched_counter")
    for _ in range(5000):
        c.inc()
    agent.flush(wait=True)
    # at most: one interval tick during the loop + the explicit flush
    assert 1 <= agent.reports_sent - sent0 <= 3
    assert "obs_batched_counter 5000.0" in metrics.prometheus_text()


def test_agent_one_report_per_interval(ray_start_regular, monkeypatch):
    """A steady stream of recordings ships once per
    telemetry_report_interval_s, not per recording."""
    rt = ray_tpu_torch._rt.get_runtime()
    agent = rt.telemetry
    monkeypatch.setattr(rt.cfg, "telemetry_report_interval_s", 0.15)
    agent.flush(wait=True)
    agent.flush()  # wait=False: just ensures the reporter thread runs
    g = metrics.Gauge("obs_interval_gauge")
    sent0 = agent.reports_sent
    t_end = time.time() + 0.8
    n = 0
    while time.time() < t_end:
        g.set(float(n))
        n += 1
        time.sleep(0.005)
    sent = agent.reports_sent - sent0
    assert n > 50  # many recordings...
    assert 1 <= sent <= 10  # ...but ~one report per 0.15 s interval


def test_flush_on_shutdown_read_your_writes(ray_start_regular):
    """stop(flush=True) — what Runtime.shutdown calls — ships everything
    still buffered, so nothing recorded just before shutdown is lost."""
    rt = ray_tpu_torch._rt.get_runtime()
    tracing.enable()
    try:
        with tracing.span("pre_shutdown_span"):
            pass
    finally:
        tracing.disable()
    rt.telemetry.stop(flush=True)
    # neuter later flushes: the span must already be at the GCS
    rt.telemetry._ship = lambda: True
    names = [e.get("name") for e in ray_tpu_torch.timeline(limit=2000)]
    assert "pre_shutdown_span" in names


# ------------------------------------------------------- drop accounting


def test_failed_report_rebuffers_and_counts_drops(ray_start_regular,
                                                  monkeypatch):
    """GCS outage: reports fail -> contents re-buffer (bounded by
    task_event_buffer_size, oldest dropped AND counted); on recovery the
    retained events ship and the drop counters surface as metrics."""
    rt = ray_tpu_torch._rt.get_runtime()
    agent = rt.telemetry
    agent.flush(wait=True)  # drain pre-existing events
    orig = rt.gcs_call

    def failing(method, *a, **kw):
        if method == "telemetry_report":
            raise RuntimeError("gcs down")
        return orig(method, *a, **kw)

    monkeypatch.setattr(rt, "gcs_call", failing)
    monkeypatch.setattr(rt.cfg, "task_event_buffer_size", 50)
    dropped0 = agent.events_dropped
    for i in range(120):
        agent.record_event({"kind": "span", "name": f"obs_drop_ev{i}",
                            "ts": float(i), "dur": 0.0})
    rd0 = agent.reports_dropped
    agent.flush(wait=True)  # fails against the dead GCS
    assert agent.reports_dropped > rd0
    with agent._ship_lock, agent._lock:  # no ship in flight -> stable view
        assert len(agent._events) <= 50  # bounded re-buffer
        assert agent.events_dropped - dropped0 >= 70  # 120 into 50 slots
        assert any(e.get("name") == "obs_drop_ev119"
                   for e in agent._events)  # newest survive

    monkeypatch.setattr(rt, "gcs_call", orig)  # GCS recovers
    agent.flush(wait=True)
    names = [e.get("name") for e in ray_tpu_torch.timeline(limit=5000)]
    assert "obs_drop_ev119" in names
    text = metrics.prometheus_text()
    assert "ray_tpu_task_events_dropped" in text
    assert "ray_tpu_telemetry_reports_dropped" in text


# ----------------------------------------------- histograms / percentiles


def test_histogram_exposition_quantile_and_merge():
    h = metrics.Histogram("obs_lat_s", description="latency",
                          boundaries=[0.1, 1, 10])
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.quantile(0.5) == pytest.approx(1.0)
    assert h.quantile(0.99) == pytest.approx(10.0)

    delta = h._collect()
    assert delta is not None and delta["boundaries"] == [0.1, 1, 10]
    payload = metrics.merge_payload(None, delta)
    # a second process's delta merges bucket-wise (GCS-side view)
    payload = metrics.merge_payload(payload, {
        "kind": "histogram", "boundaries": [0.1, 1, 10],
        "series": [{"tags": {}, "sum": 0.2, "count": 1,
                    "buckets": [0, 1, 0, 0]}]})
    text = "\n".join(metrics.render_prometheus("obs_lat_s", payload))
    # conformant exposition: cumulative buckets ending at +Inf
    assert 'obs_lat_s_bucket{le="0.1"} 1' in text
    assert 'obs_lat_s_bucket{le="1"} 3' in text
    assert 'obs_lat_s_bucket{le="10"} 4' in text
    assert 'obs_lat_s_bucket{le="+Inf"} 5' in text
    assert "obs_lat_s_count 5" in text
    assert "# TYPE obs_lat_s histogram" in text
    s = payload["series"][0]
    q = metrics.quantile_from_buckets([0.1, 1, 10], s["buckets"], 0.99)
    assert q == pytest.approx(10.0)  # +Inf bucket clamps to last bound


def test_histogram_tagged_series_render_separately():
    h = metrics.Histogram("obs_tagged_s", boundaries=[1.0],
                          tag_keys=("replica",))
    h.observe(0.5, tags={"replica": "a"})
    h.observe(2.0, tags={"replica": "b"})
    payload = metrics.merge_payload(None, h._collect())
    text = "\n".join(metrics.render_prometheus("obs_tagged_s", payload))
    assert 'obs_tagged_s_bucket{replica="a",le="1"} 1' in text
    assert 'obs_tagged_s_bucket{replica="b",le="+Inf"} 1' in text


# ------------------------------------------------------------- edge model


def test_edge_model_ewma():
    from ray_tpu_torch.observability.edges import BW_BAND_BYTES, EdgeModel

    m = EdgeModel()
    m.observe("a", "b", 1000, 0.1, kind="object_pull")
    m.observe("a", "b", 1000, 0.3, kind="object_pull")
    s = m.stats()["a->b"]
    assert s["count"] == 2
    assert s["bytes_total"] == 2000.0
    # alpha=0.25: 0.25*0.3 + 0.75*0.1
    assert s["latency_ewma_s"] == pytest.approx(0.15)
    # size-banded: a small transfer's bytes/seconds is rendezvous noise,
    # so it must never touch the bandwidth EWMA
    assert s["bandwidth_ewma_bps"] is None
    # bulk observations update bandwidth only; latency EWMA unchanged
    nb = BW_BAND_BYTES
    m.observe("a", "b", nb, 1.0, kind="object_pull")
    m.observe("a", "b", nb, 3.0, kind="object_pull")
    s = m.stats()["a->b"]
    assert s["latency_ewma_s"] == pytest.approx(0.15)
    assert s["bandwidth_ewma_bps"] == pytest.approx(
        0.25 * (nb / 3.0) + 0.75 * (nb / 1.0))
    assert s["kinds"] == {"object_pull": 4}
    # malformed observations are ignored, never raise
    m.observe("", "b", 1, 0.1)
    m.observe("a", None, 1, 0.1)
    m.observe("a", "b", 1, -1.0)
    assert m.stats()["a->b"]["count"] == 4


def test_record_transfer_without_runtime_is_noop():
    from ray_tpu_torch.observability.edges import record_transfer

    record_transfer("a", "b", 100, 0.01)  # must not raise


def test_edge_stats_after_collective(ray_start_regular):
    """Acceptance: edge_stats() is populated after an allreduce — every
    transport round records a per-edge observation worker-side."""
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    class Member:
        def __init__(self, rank):
            self.rank = rank

        def run(self, group):
            import numpy as np

            from ray_tpu_torch import collective as col

            col.init_collective_group(2, self.rank, group, backend="ring",
                                      timeout_s=60)
            # 32KiB payload: 16KiB inline chunks feed the latency band;
            # 1MiB payload: 512KiB zero-copy chunks feed the bandwidth
            # band (the EWMAs are size-banded, observability/edges.py)
            x = col.allreduce(np.ones(4096, dtype=np.float64), group)
            y = col.allreduce(np.ones(131072, dtype=np.float64), group)
            ray_tpu_torch._rt.get_runtime().flush_task_events(wait=True)
            return float(x[0] + y[0])

    members = [Member.options(num_cpus=0.25).remote(i) for i in range(2)]
    try:
        out = ray_tpu_torch.get([m.run.remote("obs_edges") for m in members],
                          timeout=120)
        assert out == [4.0, 4.0]
        edges = state.edge_stats()
        assert edges, "allreduce produced no edge observations"
        coll = [e for e in edges.values()
                if e["kinds"].get("collective", 0) >= 1]
        assert coll, "no collective edge observations"
        e = max(coll, key=lambda d: d["count"])
        assert e["count"] >= 1
        assert e["latency_ewma_s"] > 0
        assert e["bandwidth_ewma_bps"] > 0
    finally:
        from ray_tpu_torch import collective as col

        try:
            col.destroy_collective_group("obs_edges")
        except Exception:
            pass
        for m in members:
            ray_tpu_torch.kill(m)


# ----------------------------------------------------------- chrome trace


def test_chrome_trace_lanes_and_slices():
    from ray_tpu_torch.observability import chrome_trace

    events = [
        {"kind": "span", "name": "user_span", "trace_id": "t" * 16,
         "span_id": "a1", "parent_id": None, "ts": 1.0, "dur": 0.5,
         "attrs": {"k": "v"}, "worker": "w1"},
        {"task_id": "task0001", "name": "f", "state": "RUNNING",
         "ts": 1.0, "worker": "w1"},
        {"task_id": "task0001", "name": "f", "state": "FINISHED",
         "ts": 2.0, "worker": "w1"},
        {"task_id": "task0002", "name": "g", "state": "RUNNING",
         "ts": 1.5, "worker": "w2"},
        {"kind": "span", "name": "driver_span", "trace_id": "u" * 16,
         "span_id": "b2", "parent_id": None, "ts": 0.5, "dur": 0.1,
         "attrs": {}},  # no worker -> driver lane
    ]
    trace = chrome_trace(events)
    slices = [e for e in trace if e["ph"] == "X"]
    metas = [e for e in trace if e["ph"] == "M"]
    instants = [e for e in trace if e["ph"] == "i"]
    assert len(slices) == 3  # 2 spans + 1 paired task
    assert len(instants) == 1  # still-RUNNING task is visible
    lane_names = {m["args"]["name"] for m in metas
                  if m["name"] == "process_name"}
    assert {"driver", "worker:w1", "worker:w2"} <= lane_names
    task_slice = next(e for e in slices if e["cat"] == "task")
    assert task_slice["dur"] == pytest.approx(1.0 * 1e6)  # microseconds
    assert task_slice["args"]["task_id"] == "task0001"
    # span slices keep trace linkage in args for trace-viewer queries
    user = next(e for e in slices if e["name"] == "user_span")
    assert user["args"]["trace_id"] == "t" * 16
    assert user["args"]["attrs"] == {"k": "v"}


def test_timeline_chrome_export(ray_start_regular):
    """ray_tpu_torch.timeline(chrome=True) end-to-end: a user span becomes an
    X slice with the worker/driver lane metadata present."""
    tracing.enable()
    try:
        with tracing.span("export_me"):
            time.sleep(0.01)
    finally:
        tracing.disable()
    trace = ray_tpu_torch.timeline(limit=2000, chrome=True)
    assert any(e.get("ph") == "X" and e.get("name") == "export_me"
               for e in trace)
    assert any(e.get("ph") == "M" and e.get("name") == "process_name"
               for e in trace)
