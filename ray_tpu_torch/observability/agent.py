"""Per-process TelemetryAgent: batch-and-ship observability reporter.

Reference: metrics_agent.py + task_event_buffer.h:199 — every process
accumulates metric deltas (util/metrics.py), task state events, tracing
spans, and transfer-edge observations locally, and a background reporter
thread ships them to the GCS as ONE `telemetry_report` RPC per
`telemetry_report_interval_s`. This replaces the per-increment metric
`kv_put` and the ad-hoc flush-every-100-events threshold the runtime
used to have.

Failure never drops telemetry silently: on a failed report the events
re-buffer (bounded by `task_event_buffer_size`, oldest dropped AND
counted) and metric deltas carry over into the next report; the drop
counters themselves ship as ordinary counters
(`ray_tpu_task_events_dropped`, `ray_tpu_telemetry_reports_dropped`).

Thread contract: record_* and flush(wait=False) are safe from ANY
thread including the runtime's event-loop thread (lock + append + Event
set, no RPC). flush(wait=True) performs a synchronous GCS call and so
must be called from an executor/user thread — the same rule as every
other blocking Runtime call.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core import rpc as _rpc
from ray_tpu_torch.observability import health as _health
from ray_tpu_torch.observability import memory as _memory
from ray_tpu_torch.util import metrics as _metrics

# Edge observations are tiny and summarized GCS-side; a modest bound.
_EDGE_BUFFER_CAP = 4096


class TelemetryAgent:
    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.Lock()       # guards buffers + drop counters
        self._ship_lock = threading.Lock()  # serializes report build/send
        self._events: List[dict] = []       # task events + spans, in order
        self._edges: List[dict] = []
        self._carry: List[dict] = []        # metric deltas from failed ships
        self._susp_carry: List[dict] = []   # rpc-timeout suspicions, same
        self.events_dropped = 0
        self.reports_dropped = 0
        self.reports_sent = 0
        self._events_dropped_shipped = 0
        self._reports_dropped_shipped = 0
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------- recording (hot path)

    def record_event(self, ev: dict) -> None:
        fl = getattr(self._rt, "flight", None)
        if fl is not None:
            fl.record(ev)
        cap = self._cap()
        with self._lock:
            self._events.append(ev)
            overflow = len(self._events) - cap
            if overflow > 0:
                del self._events[:overflow]
                self.events_dropped += overflow
            high_water = len(self._events) >= max(cap // 2, 1)
        if high_water:
            # ship early instead of waiting out the interval — bounded
            # memory beats strict batching under a burst
            self._wake.set()
        self._ensure_thread()

    def record_edge(self, src: str, dst: str, nbytes: float, seconds: float,
                    kind: str = "transfer") -> None:
        with self._lock:
            self._edges.append({"src": src, "dst": dst,
                                "nbytes": float(nbytes),
                                "seconds": float(seconds), "kind": kind})
            overflow = len(self._edges) - _EDGE_BUFFER_CAP
            if overflow > 0:
                del self._edges[:overflow]
        self._ensure_thread()

    def _cap(self) -> int:
        return int(getattr(self._rt.cfg, "task_event_buffer_size", 10000))

    def _interval(self) -> float:
        return float(getattr(self._rt.cfg, "telemetry_report_interval_s", 1.0))

    # --------------------------------------------------------- reporter thread

    def ensure_started(self) -> None:
        """Start the reporter without waiting for a first event — memory
        attribution needs a shipping cadence even in processes that never
        record a task event (put/get-only drivers)."""
        self._ensure_thread()

    def _ensure_thread(self) -> None:
        if self._thread is not None or self._stopped.is_set():
            return
        with self._ship_lock:
            if self._thread is None and not self._stopped.is_set():
                t = threading.Thread(target=self._loop, daemon=True,
                                     name="raytpu-telemetry")
                self._thread = t
                t.start()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            self._wake.wait(self._interval())
            self._wake.clear()
            if self._stopped.is_set():
                return
            try:
                self._ship()
            except Exception:
                pass  # _ship re-buffers on failure; the reporter never dies

    # ---------------------------------------------------------------- shipping

    def flush(self, wait: bool = False) -> None:
        """wait=True: synchronously ship everything pending (read-your-
        writes for timeline()/prometheus_text()). wait=False: just make
        sure the reporter is running — contents ship within one interval.
        The wait=False form is what the runtime calls from async task
        paths, so it must never block."""
        if wait:
            self._ship()
        else:
            self._ensure_thread()

    def stop(self, flush: bool = True) -> None:
        """Final flush-on-shutdown, then stop the reporter."""
        self._stopped.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        if flush:
            try:
                self._ship()
            except Exception:
                pass

    def _ship(self) -> bool:
        with self._ship_lock:
            with self._lock:
                events, self._events = self._events, []
                edges, self._edges = self._edges, []
                carry, self._carry = self._carry, []
                d_ev = self.events_dropped - self._events_dropped_shipped
                d_rep = self.reports_dropped - self._reports_dropped_shipped
            metric_deltas = carry + _metrics.collect_deltas()
            # Drop counters ship separately and are never carried — on a
            # failed report they are recomputed from the live counters, so
            # carrying them too would double-count.
            self_deltas = []
            if d_ev > 0:
                self_deltas.append(_counter_delta(
                    "ray_tpu_task_events_dropped",
                    "task events dropped by the telemetry agent "
                    "(buffer overflow past task_event_buffer_size)", d_ev))
            if d_rep > 0:
                self_deltas.append(_counter_delta(
                    "ray_tpu_telemetry_reports_dropped",
                    "batched telemetry reports that failed to reach the GCS "
                    "(contents re-buffered)", d_rep))
            # Beacon snapshots ride every report: the watchdog needs a
            # fresh age even when nothing else happened — that is
            # exactly the silent-stall case.
            beacons = _health.snapshot_beacons()
            # Memory attribution rides the same report (no new RPC
            # cadence): per-object ownership/pin/temperature records,
            # validated against the local store so stale ones prune.
            try:
                mem = _memory.snapshot_for_report(
                    getattr(self._rt, "store", None))
                _memory.publish_gauges()
            except Exception:
                mem = None
            # RPC-timeout suspicions (core/rpc.py deadline misses): the
            # caller can't tell a dead peer from a black-holed link, so
            # it reports *suspicion* and the GCS health plane aggregates
            # (gray-failure detection needs cross-observer evidence).
            suspicions = self._susp_carry + _rpc.drain_timeout_suspicions()
            self._susp_carry = []
            if not (events or edges or metric_deltas or self_deltas
                    or beacons or mem or suspicions):
                return True
            report = {"events": events, "edges": edges,
                      "metrics": metric_deltas + self_deltas,
                      "beacons": beacons,
                      "worker": self._rt.worker_id.hex()[:12],
                      "node": getattr(self._rt, "node_id", None)}
            if mem:
                report["memory"] = mem
            if suspicions:
                report["rpc_suspicions"] = suspicions
            try:
                reply = self._rt.gcs_call("telemetry_report", report=report,
                                          rpc_timeout=10.0)
            except Exception:
                with self._lock:
                    self.reports_dropped += 1
                    # re-buffer in original order, oldest dropped first
                    merged = events + self._events
                    cap = self._cap()
                    if len(merged) > cap:
                        self.events_dropped += len(merged) - cap
                        merged = merged[-cap:]
                    self._events = merged
                    self._edges = (edges + self._edges)[-_EDGE_BUFFER_CAP:]
                    self._carry = metric_deltas + self._carry
                    self._susp_carry = (suspicions + self._susp_carry)[-256:]
                return False
            with self._lock:
                self.reports_sent += 1
                self._events_dropped_shipped += d_ev
                self._reports_dropped_shipped += d_rep
            # The GCS watchdog names OUR stalled components in the
            # reply — write the black box while the evidence is still
            # in the ring (one dump per stall episode, rate-limited).
            stalled = (reply or {}).get("stalled") if isinstance(
                reply, dict) else None
            if stalled:
                fl = getattr(self._rt, "flight", None)
                if fl is not None:
                    fl.dump("stall:" + ",".join(map(str, stalled)),
                            extra={"stalled": stalled, "beacons": beacons})
            return True

    # ------------------------------------------------------- node resolution

    def node_of_addr(self, addr: Tuple[str, int]) -> Optional[str]:
        """nodelet address -> node id hex, for stamping pull edges. The
        cluster membership is fetched once and cached; a miss after
        refresh (node died between pull and stamp) returns None and the
        observation is skipped."""
        key = (addr[0], int(addr[1]))
        cache = getattr(self, "_addr_nodes", None)
        if cache is None:
            cache = self._addr_nodes = {}
        hit = cache.get(key)
        if hit is not None:
            return hit
        try:
            for n in self._rt.gcs_call("get_nodes", rpc_timeout=5.0):
                a = tuple(n.nodelet_addr)
                cache[(a[0], int(a[1]))] = n.node_id.hex()
        except Exception:
            return None
        return cache.get(key)


def _counter_delta(name: str, description: str, value: float) -> dict:
    return {"name": name, "kind": "counter", "description": description,
            "series": [{"tags": {}, "value": float(value), "count": 1}]}
