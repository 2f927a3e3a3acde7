"""Unified cluster timeline: task states + spans -> one Chrome trace.

ref: `ray timeline` chrome://tracing export. One lane (trace pid) per
executing worker plus a "driver" lane; task state events pair
RUNNING -> terminal into complete ("X") slices, and every span — user
`tracing.span`s, collective rounds (`collective::allreduce`),
streaming-executor ops (`data::<op>`) — lands in the lane of the worker
that recorded it. Load the JSON in chrome://tracing or Perfetto.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_TERMINAL = ("FINISHED", "FAILED", "CANCELLED")


def _jsonable(v):
    """Chrome trace args must survive json.dump — GCS events carry ID
    objects (JobID, ActorID) in some fields; stringify anything that is
    not already a JSON primitive/container."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


class _Lanes:
    """Stable pid per worker + tid per track, with name metadata."""

    def __init__(self):
        self.meta: List[dict] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[int, str], int] = {}

    def pid(self, worker: Optional[str]) -> int:
        name = worker or "driver"
        pid = self._pids.get(name)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[name] = pid
            label = "driver" if name == "driver" else f"worker:{name}"
            self.meta.append({"name": "process_name", "ph": "M", "pid": pid,
                              "tid": 0, "args": {"name": label}})
        return pid

    def tid(self, pid: int, track: str) -> int:
        tid = self._tids.get((pid, track))
        if tid is None:
            tid = sum(1 for (p, _) in self._tids if p == pid) + 1
            self._tids[(pid, track)] = tid
            self.meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                              "tid": tid, "args": {"name": track}})
        return tid


def chrome_trace(events: List[dict]) -> List[dict]:
    """Merge raw GCS telemetry events (`ray_tpu_torch.timeline()` output) into
    Chrome trace-event JSON (list form)."""
    lanes = _Lanes()
    out: List[dict] = []
    running: Dict[str, dict] = {}  # task_id -> RUNNING event
    for ev in sorted(events, key=lambda e: e.get("ts", 0.0)):
        if ev.get("kind") == "span":
            pid = lanes.pid(ev.get("worker"))
            track = f"trace:{str(ev.get('trace_id', ''))[:8]}"
            out.append({
                "name": ev.get("name", "span"), "cat": "span", "ph": "X",
                "pid": pid, "tid": lanes.tid(pid, track),
                "ts": ev.get("ts", 0.0) * 1e6,
                "dur": max(float(ev.get("dur", 0.0)), 1e-6) * 1e6,
                "args": _jsonable({"trace_id": ev.get("trace_id"),
                                    "span_id": ev.get("span_id"),
                                    "parent_id": ev.get("parent_id"),
                                    "attrs": ev.get("attrs", {})}),
            })
            continue
        if ev.get("kind") in ("instant", "channel_frame"):
            # health instants (stall::/straggler:: markers) and
            # flight-recorder channel-frame metadata render as Chrome
            # instant events so they line up against the slices around
            # them
            pid = lanes.pid(ev.get("worker"))
            kind = ev["kind"]
            track = ("health" if kind == "instant"
                     else f"channel:{str(ev.get('channel', ''))[:16]}")
            out.append({
                "name": ev.get("name", kind), "cat": kind, "ph": "i",
                "pid": pid, "tid": lanes.tid(pid, track),
                "ts": ev.get("ts", 0.0) * 1e6, "s": "p",
                "args": _jsonable({k: v for k, v in ev.items()
                                   if k not in ("kind", "ts", "worker")}),
            })
            continue
        state = ev.get("state")
        task_id = ev.get("task_id")
        if task_id is None:
            continue
        if state == "RUNNING" or (state == "PENDING"
                                  and task_id not in running):
            # PENDING opens the slice only when no RUNNING is seen, so
            # live timelines still measure execution time while
            # driver-side flight dumps (submission states only) render
            # instead of merging to an empty trace
            running[task_id] = ev
        elif state in _TERMINAL and task_id in running:
            start = running.pop(task_id)
            pid = lanes.pid(start.get("worker") or ev.get("worker"))
            track = f"task:{str(task_id)[:8]}"
            out.append({
                "name": ev.get("name", "task"), "cat": "task", "ph": "X",
                "pid": pid, "tid": lanes.tid(pid, track),
                "ts": start.get("ts", 0.0) * 1e6,
                "dur": max(ev.get("ts", 0.0) - start.get("ts", 0.0),
                           1e-6) * 1e6,
                "args": _jsonable({"task_id": task_id, "state": state,
                                    "actor_id": ev.get("actor_id"),
                                    "job_id": ev.get("job_id")}),
            })
    # still-running tasks appear as instant events so an in-flight
    # snapshot is not silently empty
    for task_id, start in running.items():
        pid = lanes.pid(start.get("worker"))
        out.append({
            "name": start.get("name", "task"), "cat": "task", "ph": "i",
            "pid": pid, "tid": lanes.tid(pid, f"task:{str(task_id)[:8]}"),
            "ts": start.get("ts", 0.0) * 1e6, "s": "t",
            "args": _jsonable({"task_id": task_id,
                               "state": start.get("state", "RUNNING")}),
        })
    return lanes.meta + out
