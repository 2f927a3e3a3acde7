"""Flight recorder: a bounded per-process ring of recent observability
events, dumped to a post-mortem file when something dies or stalls.

Reference: the C++ runtime's debug_state.txt + `ray debug` post-mortem
surface, and the "black box" pattern from flight-data recorders: the
hot path only ever appends to a fixed-size ring (deque, O(1), no I/O);
serialization happens exactly once, at dump time, when the process is
already off the fast path because something went wrong.

The ring mirrors what the TelemetryAgent ships (task state events,
spans) plus records that never leave the process at all — compiled
channel-frame metadata, collective round markers — so the dump shows
the last N things the process did even when the telemetry plane itself
was the casualty.

Dump triggers (all call FlightRecorder.dump(reason)):
  * the GCS names this process in the `telemetry_report` reply's
    `stalled` list (observability/agent.py)
  * `CollectiveError` / `CollectiveTimeoutError` raised in
    collective/group.py
  * an uncaught exception unwinds a worker task (core/worker.py)

Dumps are JSON files under `cfg.flight_recorder_dir` (default
`flight` under the session root, core/node.session_root), one per incident, rate-limited per reason prefix
so a stall flagged every report interval produces one file, not one
per interval. `cli blackbox` lists and renders them;
`cli blackbox --chrome out.json` merges a dump into the chrome trace
via observability/timeline.chrome_trace.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# One dump per (reason prefix) per this many seconds — a stall that
# stays stalled re-triggers on every telemetry reply otherwise.
_DUMP_MIN_INTERVAL_S = 30.0


def default_dir() -> str:
    from ray_tpu_torch.core.node import session_root

    return os.path.join(session_root(), "flight")


class FlightRecorder:
    def __init__(self, runtime):
        self._rt = runtime
        cap = int(getattr(runtime.cfg, "flight_recorder_size", 2048))
        self._disabled = cap <= 0
        self._ring: deque = deque(maxlen=max(cap, 16))
        self._lock = threading.Lock()
        self._last_dump: Dict[str, float] = {}
        self.dumps_written = 0

    # ------------------------------------------------------------- hot path

    def record(self, ev: dict) -> None:
        """Append one event. deque.append is atomic under the GIL; the
        lock only guards against a concurrent dump() snapshotting a
        half-rotated ring."""
        if self._disabled:
            return
        with self._lock:
            self._ring.append(ev)

    # ------------------------------------------------------------ dump path

    def _dir(self) -> str:
        d = str(getattr(self._rt.cfg, "flight_recorder_dir", "") or "")
        return d or default_dir()

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None,
             force: bool = False) -> Optional[str]:
        """Write the ring to a post-mortem file; returns the path, or
        None when rate-limited or the write failed (a dying process must
        never die *harder* because its black box could not be written)."""
        if self._disabled:
            return None
        prefix = reason.split(":", 1)[0]
        now = time.time()
        with self._lock:
            last = self._last_dump.get(prefix, 0.0)
            if not force and now - last < _DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump[prefix] = now
            events = list(self._ring)
        try:
            worker = self._rt.worker_id.hex()[:12]
        except Exception:
            worker = "?"
        doc = {
            "version": 1,
            "reason": reason,
            "ts": now,
            "pid": os.getpid(),
            "worker": worker,
            "node": getattr(self._rt, "node_id", None),
            "mode": getattr(self._rt, "mode", None),
            "extra": extra or {},
            "events": events,
        }
        try:
            d = self._dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight-{worker}-{os.getpid()}-{int(now * 1000)}"
                   f"-{self.dumps_written}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            self.dumps_written += 1
            return path
        except Exception:
            return None


# --------------------------------------------------------------------------
# reading side (cli blackbox)
# --------------------------------------------------------------------------

def list_dumps(directory: Optional[str] = None) -> List[str]:
    d = directory or default_dir()
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("flight-") and n.endswith(".json")]
    except OSError:
        return []
    names.sort(key=lambda n: os.path.getmtime(os.path.join(d, n)))
    return [os.path.join(d, n) for n in names]


def load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def render_summary(doc: dict, tail: int = 20) -> str:
    """Human-readable incident summary: header, event-kind census, the
    last `tail` ring entries."""
    events = doc.get("events", [])
    by_kind: Dict[str, int] = {}
    for ev in events:
        k = ev.get("kind") or ev.get("state") or "event"
        by_kind[k] = by_kind.get(k, 0) + 1
    lines = [
        f"reason   {doc.get('reason')}",
        f"when     {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(doc.get('ts', 0)))}",
        f"process  pid={doc.get('pid')} worker={doc.get('worker')} "
        f"node={doc.get('node')} mode={doc.get('mode')}",
        f"events   {len(events)} "
        f"({', '.join(f'{k}={n}' for k, n in sorted(by_kind.items()))})",
    ]
    extra = doc.get("extra") or {}
    if extra:
        lines.append("extra    " + json.dumps(extra, default=str))
    lines.append(f"--- last {min(tail, len(events))} events ---")
    for ev in events[-tail:]:
        ts = ev.get("ts", 0.0)
        k = ev.get("kind") or ev.get("state") or "event"
        name = ev.get("name", "")
        detail = {kk: vv for kk, vv in ev.items()
                  if kk not in ("ts", "kind", "state", "name")}
        lines.append(f"  {ts:.6f}  {k:<12} {name:<28} "
                     + json.dumps(detail, default=str)[:120])
    return "\n".join(lines)


def to_chrome(doc: dict) -> List[dict]:
    """Merge a dump into Chrome trace-event JSON (same renderer as
    `ray_tpu_torch.timeline(chrome=True)`, so a black box can be loaded next
    to — or concatenated with — the live cluster trace)."""
    from ray_tpu_torch.observability.timeline import chrome_trace
    return chrome_trace(doc.get("events", []))
