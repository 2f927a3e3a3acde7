"""Health plane: progress beacons, stall watchdog, straggler detection.

Reference: the C++ runtime pairs its metrics plane with liveness
machinery — per-component heartbeats feeding a GCS health manager
(gcs_health_check_manager.h), task-event state tables behind
`ray list`, and the in-flight task stall warnings printed by the core
worker. At scale the failure mode is not a crash but a *silent stall*:
a collective round waiting on one dead rank, a compiled channel whose
upstream stopped pushing, one straggling map task holding a barrier.

Design here:

* **Beacon** — a per-process monotonic progress counter registered by a
  long-running loop (collective round loop, streaming-executor rounds,
  compiled-channel reader, serve stream generators, train step loop).
  `tick()` is the hot-path call: one attribute bump + timestamp, no
  locks beyond the GIL, nothing shipped per tick. A loop entering a
  potentially-blocking wait calls `arm(**context)` (e.g. the collective
  op + round + rank it is waiting on); `disarm()` on exit. Only armed
  ("busy") beacons can stall — an idle loop is just idle.

* **Shipping** — the TelemetryAgent snapshots every beacon into the
  existing batched `telemetry_report` (one RPC per interval), so the
  watchdog adds ZERO new RPC streams.

* **HealthAggregator** — GCS-side. Folds beacon snapshots per
  (worker, component); flags any busy beacon whose progress counter has
  not advanced within its declared deadline and emits a typed
  `StallEvent` carrying component, node, last-progress age, and the
  beacon's context (suspect ranks for collectives). The
  `telemetry_report` reply names the reporter's own stalled components
  so the stalled process can dump its flight recorder within one
  report interval of detection.

* **Straggler detection** — per-task-name duration histograms built
  from the same task state events the GCS already stores (PR 6); a
  RUNNING task older than `straggler_k` × p95 of >= `straggler_min_peers`
  completed peers raises a straggler event and a timeline instant.

This module is import-light (stdlib only at module scope) because the
GCS imports it; `quantile_from_buckets` is pulled lazily inside the
straggler check.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# Log-scale duration boundaries (seconds) for the per-task-name
# completion histograms behind straggler p95 — same shape as the
# default Histogram boundaries in util/metrics but wider at the top
# so multi-minute training tasks still bucket meaningfully.
STRAGGLER_BOUNDARIES: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


# --------------------------------------------------------------------------
# process side: beacons
# --------------------------------------------------------------------------

class Beacon:
    """A progress counter for one long-running loop.

    tick() = the loop made progress. arm(**ctx) = the loop is entering
    a wait that can legitimately block but must not exceed deadline_s
    without progress; ctx describes what it waits on (shipped verbatim
    into any StallEvent). All methods are safe from any thread — the
    updates are single attribute stores, and the snapshot tolerates a
    torn read (one report of a slightly stale age, self-corrected next
    interval).
    """

    __slots__ = ("component", "deadline_s", "count", "busy",
                 "_last_progress", "context")

    def __init__(self, component: str, deadline_s: float):
        self.component = component
        self.deadline_s = float(deadline_s)
        self.count = 0
        self.busy = False
        self._last_progress = time.monotonic()
        self.context: Dict[str, Any] = {}

    def tick(self) -> None:
        self.count += 1
        self._last_progress = time.monotonic()

    def arm(self, **context: Any) -> None:
        self.context = context
        self._last_progress = time.monotonic()
        self.busy = True

    def disarm(self) -> None:
        self.busy = False
        self.context = {}

    def age_s(self) -> float:
        return time.monotonic() - self._last_progress

    def snapshot(self) -> dict:
        return {"component": self.component,
                "deadline_s": self.deadline_s,
                "count": self.count,
                "busy": self.busy,
                "age_s": round(self.age_s(), 4),
                "context": dict(self.context)}


_beacons: Dict[str, Beacon] = {}
_beacons_lock = threading.Lock()


def beacon(component: str, deadline_s: float) -> Beacon:
    """Get-or-create the process-wide beacon for `component`. Repeated
    registration keeps the existing counter (a re-created collective
    group continues its beacon) but adopts the new deadline."""
    with _beacons_lock:
        b = _beacons.get(component)
        if b is None:
            b = _beacons[component] = Beacon(component, deadline_s)
        else:
            b.deadline_s = float(deadline_s)
        return b


def drop_beacon(component: str) -> None:
    with _beacons_lock:
        _beacons.pop(component, None)


def snapshot_beacons() -> List[dict]:
    with _beacons_lock:
        beacons = list(_beacons.values())
    return [b.snapshot() for b in beacons]


def _reset_for_tests() -> None:
    with _beacons_lock:
        _beacons.clear()


# --------------------------------------------------------------------------
# GCS side: stall watchdog + straggler detection
# --------------------------------------------------------------------------

class StallEvent(dict):
    """A typed health event. Plain-dict subclass so it pickles across
    the RPC plane and json-dumps into flight-recorder files unchanged;
    the type carries intent (and isinstance checks in tests).

    Keys: kind ("stall" | "straggler"), component, worker, node, age_s,
    deadline_s, context, ts — plus task_id/name for stragglers.
    """

    @property
    def component(self) -> str:
        return self.get("component", "")

    @property
    def context(self) -> Dict[str, Any]:
        return self.get("context", {})


class _BeaconState:
    __slots__ = ("count", "busy", "age_s", "deadline_s", "context",
                 "node", "report_ts", "stalled")

    def __init__(self):
        self.count = -1
        self.busy = False
        self.age_s = 0.0
        self.deadline_s = 0.0
        self.context: Dict[str, Any] = {}
        self.node: Optional[str] = None
        self.report_ts = 0.0
        self.stalled = False


class HealthAggregator:
    """GCS-side fold of beacon snapshots + straggler detection.

    update() runs inline in rpc_telemetry_report (cheap: dict writes
    keyed by (worker, component)) and returns the reporter's own
    currently-stalled components for the RPC reply. check() runs from
    the GCS health loop and also inside update(), emitting StallEvents
    on the *transition* into stalled — one event per stall episode, not
    one per report interval.
    """

    def __init__(self, straggler_k: float = 3.0,
                 straggler_min_peers: int = 5,
                 max_events: int = 256):
        self.straggler_k = float(straggler_k)
        self.straggler_min_peers = int(straggler_min_peers)
        self._beacons: Dict[Tuple[str, str], _BeaconState] = {}
        self.events: deque = deque(maxlen=max_events)
        self._fresh: List[StallEvent] = []   # emitted since last drain
        # straggler state: task_id -> (name, start_ts, worker)
        self._running: Dict[str, Tuple[str, float, str]] = {}
        # task name -> per-bucket completion counts (STRAGGLER_BOUNDARIES)
        self._durations: Dict[str, List[int]] = {}
        self._flagged_stragglers: set = set()
        # peer addr -> rpc-deadline suspicion fold (gray-failure
        # evidence: callers whose calls to that peer timed out)
        self._rpc_susp: Dict[str, dict] = {}

    # ------------------------------------------------------------- beacons

    def update(self, worker: str, node: Optional[str],
               beacons: List[dict], now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        stalled_components: List[str] = []
        for snap in beacons:
            comp = str(snap.get("component", ""))
            st = self._beacons.setdefault((worker, comp), _BeaconState())
            advanced = int(snap.get("count", 0)) != st.count
            st.count = int(snap.get("count", 0))
            st.busy = bool(snap.get("busy", False))
            st.age_s = float(snap.get("age_s", 0.0))
            st.deadline_s = float(snap.get("deadline_s", 0.0))
            st.context = dict(snap.get("context", {}))
            st.node = node
            st.report_ts = now
            if advanced or not st.busy:
                st.stalled = False
            if self._is_stalled(st, now):
                if not st.stalled:
                    st.stalled = True
                    self._emit_stall(worker, comp, st, now)
                stalled_components.append(comp)
        return stalled_components

    def _is_stalled(self, st: _BeaconState, now: float) -> bool:
        if not st.busy or st.deadline_s <= 0:
            return False
        # age as seen by the reporter, plus time since the report landed
        # (covers a process whose agent itself died mid-stall)
        return st.age_s + max(0.0, now - st.report_ts) > st.deadline_s

    def _emit_stall(self, worker: str, comp: str, st: _BeaconState,
                    now: float) -> StallEvent:
        ev = StallEvent(kind="stall", component=comp, worker=worker,
                        node=st.node, age_s=round(
                            st.age_s + max(0.0, now - st.report_ts), 3),
                        deadline_s=st.deadline_s,
                        context=dict(st.context), ts=now)
        self.events.append(ev)
        self._fresh.append(ev)
        return ev

    def drain_fresh(self) -> List[StallEvent]:
        """Events emitted since the last drain — the GCS turns these
        into timeline instants and log lines exactly once each."""
        out, self._fresh = self._fresh, []
        return out

    def check(self, now: Optional[float] = None) -> List[StallEvent]:
        """Periodic sweep (GCS health loop): catches beacons whose owner
        stopped reporting entirely — the age keeps growing from the last
        report timestamp even with no fresh snapshots."""
        now = time.time() if now is None else now
        fresh: List[StallEvent] = []
        for (worker, comp), st in self._beacons.items():
            if self._is_stalled(st, now) and not st.stalled:
                st.stalled = True
                fresh.append(self._emit_stall(worker, comp, st, now))
        fresh.extend(self.check_stragglers(now))
        return fresh

    def forget_worker(self, worker: str) -> None:
        """A worker died for a *known* reason (kill, node loss) — its
        beacons are no longer stalls-in-waiting."""
        for key in [k for k in self._beacons if k[0] == worker]:
            del self._beacons[key]

    def forget_node(self, node: str) -> None:
        """Node death is already a loud, attributed event — its beacons
        must not ALSO fire as anonymous stalls afterwards."""
        for key in [k for k in self._beacons
                    if self._beacons[k].node == node]:
            del self._beacons[key]

    # ---------------------------------------------------------- stragglers

    def observe_task_event(self, ev: dict, now: Optional[float] = None) -> None:
        """Fed every task state event the GCS ingests. RUNNING opens a
        straggler candidate; any terminal state records the duration
        into the per-name histogram and closes it."""
        state = ev.get("state")
        tid = ev.get("task_id")
        if not tid:
            return
        now = time.time() if now is None else now
        if state == "RUNNING":
            self._running[tid] = (str(ev.get("name", "?")),
                                  float(ev.get("ts", now)),
                                  str(ev.get("worker", "")))
            return
        if state in ("FINISHED", "FAILED", "CANCELLED"):
            rec = self._running.pop(tid, None)
            self._flagged_stragglers.discard(tid)
            if rec is None or state != "FINISHED":
                return
            name, start_ts, _w = rec
            dur = max(0.0, float(ev.get("ts", now)) - start_ts)
            buckets = self._durations.get(name)
            if buckets is None:
                buckets = self._durations[name] = \
                    [0] * (len(STRAGGLER_BOUNDARIES) + 1)
            i = 0
            while (i < len(STRAGGLER_BOUNDARIES)
                   and dur > STRAGGLER_BOUNDARIES[i]):
                i += 1
            buckets[i] += 1

    def check_stragglers(self, now: Optional[float] = None) -> List[StallEvent]:
        now = time.time() if now is None else now
        out: List[StallEvent] = []
        for tid, (name, start_ts, worker) in list(self._running.items()):
            if tid in self._flagged_stragglers:
                continue
            buckets = self._durations.get(name)
            if buckets is None or sum(buckets) < self.straggler_min_peers:
                continue
            from ray_tpu_torch.util.metrics import quantile_from_buckets
            p95 = quantile_from_buckets(
                list(STRAGGLER_BOUNDARIES), buckets, 0.95)
            if p95 is None or p95 <= 0:
                continue
            age = now - start_ts
            if age > self.straggler_k * p95:
                self._flagged_stragglers.add(tid)
                ev = StallEvent(kind="straggler", component=f"task:{name}",
                                worker=worker, node=None,
                                age_s=round(age, 3),
                                deadline_s=round(self.straggler_k * p95, 3),
                                context={"task_id": tid, "name": name,
                                         "p95_s": round(p95, 4),
                                         "k": self.straggler_k,
                                         "peers": sum(buckets)},
                                ts=now)
                self.events.append(ev)
                self._fresh.append(ev)
                out.append(ev)
        return out

    # --------------------------------------------------------- remediations

    def observe_remediation(self, event: dict,
                            now: Optional[float] = None) -> StallEvent:
        """An elastic coordinator (ray_tpu_torch.train.elastic) reports what it
        DID about a stall/straggler/death — quarantine, shrink, refill,
        grow. Folded into the same event stream so `cli doctor` and the
        timeline show cause (stall) and effect (remediation) side by
        side; kind="remediation" so doctor's stall check skips them."""
        now = time.time() if now is None else now
        ev = StallEvent(
            kind="remediation",
            component=str(event.get("component", "")),
            worker=None, node=None, age_s=0.0, deadline_s=0.0,
            context={k: v for k, v in event.items()
                     if k not in ("kind", "component", "ts")},
            ts=float(event.get("ts", now)))
        self.events.append(ev)
        self._fresh.append(ev)
        return ev

    # ------------------------------------------------- rpc-timeout suspicion

    # A call that exceeds its deadline can't distinguish a dead peer
    # from a black-holed link or a slow server — gray failure. The
    # caller reports *suspicion* (core/rpc.py counters riding the
    # telemetry report); this fold turns repeated suspicion — ideally
    # from multiple observers — into a peer_suspect health event, once
    # per episode. An episode resets after a quiet window.
    _SUSP_THRESHOLD = 3
    _SUSP_QUIET_S = 60.0

    def observe_rpc_suspicions(self, reporter: str, node: Optional[str],
                               suspicions: List[dict],
                               now: Optional[float] = None) -> List[StallEvent]:
        now = time.time() if now is None else now
        fresh: List[StallEvent] = []
        for s in suspicions or []:
            peer = str(s.get("peer", "?"))
            n = int(s.get("count", 1))
            method = str(s.get("method", "?"))
            st = self._rpc_susp.get(peer)
            if st is None or now - st["last_ts"] > self._SUSP_QUIET_S:
                st = {"count": 0, "reporters": set(), "methods": {},
                      "last_ts": now, "flagged": False}
                self._rpc_susp[peer] = st
            st["count"] += n
            st["reporters"].add(reporter)
            st["methods"][method] = st["methods"].get(method, 0) + n
            st["last_ts"] = now
            if not st["flagged"] and st["count"] >= self._SUSP_THRESHOLD:
                st["flagged"] = True
                ev = StallEvent(
                    kind="peer_suspect", component=f"rpc:{peer}",
                    worker=reporter, node=node, age_s=0.0, deadline_s=0.0,
                    context={"count": st["count"],
                             "reporters": sorted(st["reporters"]),
                             "methods": dict(st["methods"])},
                    ts=now)
                self.events.append(ev)
                self._fresh.append(ev)
                fresh.append(ev)
        return fresh

    # ------------------------------------------------------------ reporting

    def report(self, now: Optional[float] = None) -> dict:
        """The state-API view: every known beacon + recent health events."""
        now = time.time() if now is None else now
        beacons = []
        for (worker, comp), st in sorted(self._beacons.items()):
            beacons.append({
                "worker": worker, "component": comp, "node": st.node,
                "count": st.count, "busy": st.busy,
                "age_s": round(st.age_s + max(0.0, now - st.report_ts), 3),
                "deadline_s": st.deadline_s, "stalled": st.stalled,
                "context": dict(st.context),
            })
        suspects = []
        for peer, st in sorted(self._rpc_susp.items()):
            if now - st["last_ts"] > self._SUSP_QUIET_S:
                continue
            suspects.append({"peer": peer, "count": st["count"],
                             "reporters": sorted(st["reporters"]),
                             "methods": dict(st["methods"]),
                             "quiet_s": round(now - st["last_ts"], 3),
                             "flagged": st["flagged"]})
        return {"beacons": beacons,
                "events": [dict(e) for e in self.events],
                "rpc_suspects": suspects,
                "running_tasks": len(self._running)}
