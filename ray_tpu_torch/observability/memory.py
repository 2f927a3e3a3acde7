"""Memory attribution plane: who holds which bytes, and why.

Reference: the raylet's pin/primary-copy accounting behind `ray memory`
(LocalObjectManager + reference table dumps) — the visibility that makes
LRU spill-to-disk *possible*: a spiller needs to know which resident
bytes are safe (unpinned), cheap (non-primary), and worthless-in-cache
(cold) before it touches anything.

Two halves, mirroring observability/health.py:

- MemoryTracker (process side, module singleton): every store-resident
  object this process created or reads gets an attribution record —
  holder subsystem (data | kv | collective | channel | user), owner
  worker, creating task, pin reasons (each with a count and free-form
  detail such as a collective ack_key), and temperature (last-access
  tick + access count, bumped by `touch()` at pin/read time). Non-store
  byte holders (paged-KV pool pages, channel reorder buffers) register
  synthetic records with store=False so the per-subsystem totals cover
  them without polluting store-coverage math. Snapshots ride the
  existing batched TelemetryAgent report — no new RPC cadence.

- MemoryAggregator (GCS side): folds per-process snapshots into one
  cluster view keyed (node, object). Records for the same object from
  different processes merge: a specific subsystem beats the "user"
  default, pin reasons union, the freshest access wins. `report()`
  joins against per-node store occupancy (node_stats) to produce
  coverage, top holders, the spill-candidate list
  (unpinned AND cold AND non-primary) and leak suspects (still pinned
  with no live owner ref for longer than `memory_leak_suspect_s`).

Hot-path contract: `touch()` is a dict lookup plus two attribute writes
with NO lock (GIL-atomic; a lost access-count increment under a race is
acceptable — temperature is a heuristic). `attribute()`/`pin()` take a
lock but run once per object event, not per byte.

Import-light on purpose (stdlib only at module scope): the GCS, the
nodelet, and the shm store binding all import this module.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

SUBSYSTEMS = ("data", "kv", "collective", "channel", "user")

# Snapshot bound: the biggest records ship, pinned/orphaned records ship
# unconditionally (they are the ones an operator must see), the rest is
# summarized into per-subsystem overflow bytes.
_SNAPSHOT_RECORD_CAP = 512
# Bounded retag map (object -> subsystem overrides shipped for records
# another process owns, e.g. the data layer retagging worker-produced
# blocks it queues).
_RETAG_CAP = 4096


def _key_hex(key) -> str:
    return key if isinstance(key, str) else key.hex()


class _Record:
    __slots__ = ("key", "hex", "subsystem", "nbytes", "store", "owner",
                 "task", "detail", "created", "last_access", "access_count",
                 "pins", "orphaned")

    def __init__(self, key, hex_key: str, subsystem: str, nbytes: int,
                 store: bool, owner: Optional[str], task: Optional[str],
                 detail: dict, now: float):
        self.key = key
        self.hex = hex_key
        self.subsystem = subsystem
        self.nbytes = int(nbytes)
        self.store = store
        self.owner = owner
        self.task = task
        self.detail = detail
        self.created = now
        self.last_access = now
        self.access_count = 0
        # pin reason -> {"count": n, ...detail}
        self.pins: Dict[str, dict] = {}
        self.orphaned: Optional[float] = None   # monotonic ts owner refs died


class MemoryTracker:
    """Per-process attribution registry (module singleton via tracker())."""

    def __init__(self):
        self._lock = threading.Lock()
        self._recs: Dict[Any, _Record] = {}
        self._retags: Dict[str, dict] = {}
        self._sub_bytes: Dict[str, int] = {}
        self._sub_hwm: Dict[str, int] = {}
        self.enabled = True

    # ------------------------------------------------------------- hot path

    def touch(self, key) -> None:
        """Temperature bump at pin/read time. Lock-free by design."""
        rec = self._recs.get(key)
        if rec is not None:
            rec.last_access = time.monotonic()
            rec.access_count += 1

    # --------------------------------------------------------- record events

    def attribute(self, key, subsystem: str, nbytes: int, *,
                  store: bool = True, owner: Optional[str] = None,
                  task: Optional[str] = None, **detail) -> None:
        """Create or resize the attribution record for `key` (an ObjectID
        for store objects, a synthetic string for non-store aggregates).
        Re-attributing an existing key updates bytes/detail in place and
        never downgrades a specific subsystem back to "user"."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                rec = _Record(key, _key_hex(key), subsystem, nbytes, store,
                              owner, task, dict(detail), now)
                self._recs[key] = rec
                self._add_bytes_locked(subsystem, rec.nbytes)
                return
            delta = int(nbytes) - rec.nbytes
            rec.nbytes = int(nbytes)
            if detail:
                rec.detail.update(detail)
            if subsystem != "user" and rec.subsystem != subsystem:
                self._add_bytes_locked(rec.subsystem, -(rec.nbytes - delta))
                rec.subsystem = subsystem
                self._add_bytes_locked(subsystem, rec.nbytes)
            elif delta:
                self._add_bytes_locked(rec.subsystem, delta)

    def attribute_pin_many(self, entries, subsystem: str = "user",
                           reason: str = "primary", *,
                           owner: Optional[str] = None) -> None:
        """Batched attribute()+pin() for a wave of (key, nbytes) pairs —
        one lock acquisition for the whole batch. Hot path: the nodelet
        pinning every sub-chunk of a collective put or every page group
        of a KV handoff in one rpc_pin_objects sweep."""
        if not self.enabled or not entries:
            return
        now = time.monotonic()
        with self._lock:
            for key, nbytes in entries:
                rec = self._recs.get(key)
                if rec is None:
                    rec = _Record(key, _key_hex(key), subsystem,
                                  int(nbytes), True, owner, None, {}, now)
                    self._recs[key] = rec
                    self._add_bytes_locked(subsystem, rec.nbytes)
                else:
                    delta = int(nbytes) - rec.nbytes
                    rec.nbytes = int(nbytes)
                    if delta:
                        self._add_bytes_locked(rec.subsystem, delta)
                p = rec.pins.get(reason)
                if p is None:
                    rec.pins[reason] = {"count": 1}
                else:
                    p["count"] += 1

    def retag(self, key, subsystem: str, **detail) -> None:
        """Claim `key` for a subsystem. Applies to the local record when
        this process owns one; always also recorded in the bounded retag
        map shipped with snapshots, so the GCS can re-attribute records
        created by another process (e.g. worker-produced data blocks the
        driver's streaming executor queues)."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._recs.get(key)
            if rec is not None:
                if rec.subsystem != subsystem:
                    self._add_bytes_locked(rec.subsystem, -rec.nbytes)
                    rec.subsystem = subsystem
                    self._add_bytes_locked(subsystem, rec.nbytes)
                if detail:
                    rec.detail.update(detail)
            if len(self._retags) < _RETAG_CAP:
                self._retags[_key_hex(key)] = {"subsystem": subsystem,
                                               **detail}

    def pin(self, key, reason: str, **detail) -> None:
        """Register one pin of `key` for `reason` (counted: N concurrent
        readers are one reason with count N)."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                return
            p = rec.pins.get(reason)
            if p is None:
                rec.pins[reason] = {"count": 1, **detail}
            else:
                p["count"] += 1
                if detail:
                    p.update(detail)

    def unpin(self, key, reason: str) -> None:
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                return
            p = rec.pins.get(reason)
            if p is not None:
                p["count"] -= 1
                if p["count"] <= 0:
                    rec.pins.pop(reason, None)
            if rec.orphaned is not None and not rec.pins:
                # last pin of an owner-dead record released: done leaking
                self._drop_locked(key, rec)

    def release(self, key) -> None:
        """Drop the record unconditionally (bytes left the process)."""
        with self._lock:
            rec = self._recs.get(key)
            if rec is not None:
                self._drop_locked(key, rec)

    def owner_ref_dead(self, key) -> None:
        """All owner refs for `key` died. A record with no active pins is
        simply dropped; one still pinned becomes an orphan — the leak
        detector's positive signal (`pinned with no live owner ref`)."""
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                return
            if rec.pins:
                rec.orphaned = time.monotonic()
            else:
                self._drop_locked(key, rec)

    # -------------------------------------------------------------- internals

    def _drop_locked(self, key, rec: _Record) -> None:
        self._recs.pop(key, None)
        self._retags.pop(rec.hex, None)
        self._add_bytes_locked(rec.subsystem, -rec.nbytes)

    def _add_bytes_locked(self, subsystem: str, delta: int) -> None:
        b = self._sub_bytes.get(subsystem, 0) + delta
        self._sub_bytes[subsystem] = max(b, 0)
        if b > self._sub_hwm.get(subsystem, 0):
            self._sub_hwm[subsystem] = b

    def reset(self) -> None:
        with self._lock:
            self._recs.clear()
            self._retags.clear()
            self._sub_bytes.clear()
            self._sub_hwm.clear()

    # -------------------------------------------------------------- snapshots

    def subsystem_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._sub_bytes)

    def snapshot(self, limit: int = _SNAPSHOT_RECORD_CAP,
                 validate=None) -> Optional[dict]:
        """The per-process payload that rides the TelemetryAgent report.
        None when there is nothing to say (keeps quiet processes quiet).
        Ages ship as seconds (monotonic clocks do not compare across
        processes).

        `validate(key) -> bool` is consulted for pin-free, non-orphaned
        store records and prunes the ones whose bytes left the store —
        a worker that wrote a task return never sees the owner free it,
        so without this sweep its records outlive the object."""
        now = time.monotonic()
        with self._lock:
            if validate is not None:
                for key in [k for k, r in self._recs.items()
                            if r.store and not r.pins
                            and r.orphaned is None
                            and not isinstance(k, str)
                            and not validate(k)]:
                    self._drop_locked(key, self._recs[key])
            if not self._recs and not any(self._sub_bytes.values()):
                return None
            recs = list(self._recs.values())
            retags = dict(self._retags)
            sub = dict(self._sub_bytes)
            hwm = dict(self._sub_hwm)
        must = [r for r in recs if r.pins or r.orphaned is not None]
        rest = [r for r in recs if not (r.pins or r.orphaned is not None)]
        if len(must) + len(rest) > limit:
            rest.sort(key=lambda r: r.nbytes, reverse=True)
            rest = rest[:max(0, limit - len(must))]
        shipped = must + rest
        overflow = len(recs) - len(shipped)
        out = {
            "ts": time.time(),
            "pid": os.getpid(),
            "subsystems": sub,
            "subsystems_hwm": hwm,
            "records": [self._rec_dict(r, now) for r in shipped],
            "records_total": len(recs),
            "records_overflow": overflow,
        }
        if retags:
            out["retags"] = retags
        return out

    @staticmethod
    def _rec_dict(r: _Record, now: float) -> dict:
        d = {
            "key": r.hex,
            "subsystem": r.subsystem,
            "nbytes": r.nbytes,
            "store": r.store,
            "owner": r.owner,
            "task": r.task,
            "pins": {k: dict(v) for k, v in r.pins.items()},
            "age_s": round(now - r.created, 3),
            "idle_s": round(now - r.last_access, 3),
            "access_count": r.access_count,
        }
        if r.orphaned is not None:
            d["orphan_s"] = round(now - r.orphaned, 3)
        if r.detail:
            d["detail"] = dict(r.detail)
        return d


_TRACKER = MemoryTracker()


def tracker() -> MemoryTracker:
    return _TRACKER


def set_enabled(on: bool) -> None:
    _TRACKER.enabled = bool(on)


def touch(key) -> None:
    _TRACKER.touch(key)


def snapshot_for_report(store=None) -> Optional[dict]:
    """Snapshot with staleness validation against the local shm store
    (the TelemetryAgent passes its runtime's store)."""
    validate = None
    if store is not None:
        def validate(key, _s=store):
            try:
                return _s.contains(key)
            except Exception:
                return True   # store teardown: keep the record
    return _TRACKER.snapshot(validate=validate)


_GAUGES: Optional[tuple] = None


def publish_gauges() -> None:
    """Per-subsystem resident + high-water-mark gauges, set off the hot
    path (once per telemetry interval, from the agent's reporter thread).
    The instruments are cached module-wide: the metrics registry holds
    them weakly, so throwaway instances would vanish before collection."""
    from ray_tpu_torch.util import metrics  # lazy: keep module scope stdlib-only

    global _GAUGES
    if _GAUGES is None:
        _GAUGES = (
            metrics.Gauge("ray_tpu_mem_subsystem_bytes",
                          "attributed resident bytes per holder subsystem",
                          ("subsystem",)),
            metrics.Gauge("ray_tpu_mem_subsystem_hwm_bytes",
                          "high-water mark of attributed bytes per subsystem",
                          ("subsystem",)),
        )
    g, gh = _GAUGES
    with _TRACKER._lock:
        cur = dict(_TRACKER._sub_bytes)
        hwm = dict(_TRACKER._sub_hwm)
    for name in set(cur) | set(hwm):
        g.set(float(cur.get(name, 0)), {"subsystem": name})
        gh.set(float(hwm.get(name, 0)), {"subsystem": name})


# ---------------------------------------------------------------------------
# GCS side
# ---------------------------------------------------------------------------

class MemoryAggregator:
    """Folds per-process MemoryTracker snapshots into the cluster view.

    State is in-memory only (telemetry, re-learned after failover, like
    EdgeModel / HealthAggregator)."""

    def __init__(self, leak_suspect_s: float = 60.0,
                 cold_after_s: float = 30.0,
                 stale_after_s: float = 60.0):
        self.leak_suspect_s = float(leak_suspect_s)
        self.cold_after_s = float(cold_after_s)
        # a live agent re-ships every report interval; a payload this
        # far past its receipt means the reporter died and its pins
        # (read views, staged chunks) physically died with it
        self.stale_after_s = float(stale_after_s)
        # worker -> (node, received_at, payload)
        self._payloads: Dict[str, Tuple[Optional[str], float, dict]] = {}

    def update(self, worker: str, node: Optional[str], payload: dict) -> None:
        self._payloads[worker] = (node, time.time(), payload)

    def forget_worker(self, worker: str) -> None:
        self._payloads.pop(worker, None)

    def forget_node(self, node: str) -> None:
        for w in [w for w, (n, _, _) in self._payloads.items() if n == node]:
            self._payloads.pop(w, None)

    # ------------------------------------------------------------------ fold

    def _merged(self) -> Tuple[Dict[Tuple[Optional[str], str], dict],
                               Dict[str, int], Dict[str, int]]:
        """Merge records keyed (node, object). Ages are re-aged by the
        time since their payload arrived, so a process that went quiet
        keeps aging its orphans instead of freezing them."""
        now = time.time()
        for worker, (_, rx, _) in list(self._payloads.items()):
            if now - rx > self.stale_after_s:
                self._payloads.pop(worker, None)
        merged: Dict[Tuple[Optional[str], str], dict] = {}
        retags: Dict[str, dict] = {}
        overflow: Dict[str, int] = {}
        hwm: Dict[str, int] = {}
        for worker, (node, rx, payload) in self._payloads.items():
            age_add = max(0.0, now - rx)
            for name, v in (payload.get("subsystems_hwm") or {}).items():
                if v > hwm.get(name, 0):
                    hwm[name] = v
            if payload.get("records_overflow"):
                overflow[worker] = payload["records_overflow"]
            retags.update(payload.get("retags") or {})
            for rec in payload.get("records") or []:
                k = (node, rec.get("key"))
                r = dict(rec)
                r["node"] = node
                r["reporter"] = worker
                for f in ("age_s", "idle_s", "orphan_s"):
                    if f in r:
                        r[f] = round(r[f] + age_add, 3)
                cur = merged.get(k)
                if cur is None:
                    merged[k] = r
                    continue
                # same object seen by several processes on one node:
                # specific subsystem wins, pins union, freshest access
                if cur.get("subsystem") == "user" \
                        and r.get("subsystem") != "user":
                    cur["subsystem"] = r["subsystem"]
                cur["nbytes"] = max(cur.get("nbytes", 0),
                                    r.get("nbytes", 0))
                cur["store"] = bool(cur.get("store")) or bool(r.get("store"))
                cur["idle_s"] = min(cur.get("idle_s", 1e18),
                                    r.get("idle_s", 1e18))
                cur["access_count"] = (cur.get("access_count", 0)
                                       + r.get("access_count", 0))
                if r.get("orphan_s") is not None:
                    cur["orphan_s"] = max(cur.get("orphan_s") or 0.0,
                                          r["orphan_s"])
                if r.get("owner") and not cur.get("owner"):
                    cur["owner"] = r["owner"]
                if r.get("task") and not cur.get("task"):
                    cur["task"] = r["task"]
                pins = cur.setdefault("pins", {})
                for reason, p in (r.get("pins") or {}).items():
                    q = pins.get(reason)
                    if q is None:
                        pins[reason] = dict(p)
                    else:
                        q["count"] = q.get("count", 0) + p.get("count", 0)
                        q.update({kk: vv for kk, vv in p.items()
                                  if kk != "count"})
                if r.get("detail"):
                    cur.setdefault("detail", {}).update(r["detail"])
        for rec in merged.values():
            tag = retags.get(rec.get("key"))
            if tag and rec.get("subsystem") == "user":
                rec["subsystem"] = tag["subsystem"]
                extra = {kk: vv for kk, vv in tag.items()
                         if kk != "subsystem"}
                if extra:
                    rec.setdefault("detail", {}).update(extra)
        return merged, overflow, hwm

    def report(self, node_stats: Optional[Dict[str, dict]] = None,
               top_n: int = 20) -> dict:
        """The state-API / doctor / dashboard view."""
        merged, overflow, hwm = self._merged()
        records = list(merged.values())
        sub_bytes: Dict[str, int] = {}
        sub_store: Dict[str, int] = {}
        per_node_attr: Dict[Optional[str], int] = {}
        for r in records:
            s = r.get("subsystem", "user")
            n = int(r.get("nbytes", 0))
            sub_bytes[s] = sub_bytes.get(s, 0) + n
            if r.get("store"):
                sub_store[s] = sub_store.get(s, 0) + n
                per_node_attr[r.get("node")] = \
                    per_node_attr.get(r.get("node"), 0) + n

        spill = [r for r in records
                 if r.get("store") and not r.get("pins")
                 and r.get("idle_s", 0.0) >= self.cold_after_s]
        leaks = [r for r in records
                 if r.get("pins")
                 and (r.get("orphan_s") or 0.0) >= self.leak_suspect_s]
        top = sorted(records, key=lambda r: r.get("nbytes", 0),
                     reverse=True)[:top_n]

        nodes: Dict[str, dict] = {}
        spill_tier = {"spilled_objects": 0, "spilled_bytes": 0,
                      "spilled_then_dropped": 0, "restored_objects": 0,
                      "spill_bytes_total": 0, "restore_bytes_total": 0}
        for node_hex, st in (node_stats or {}).items():
            used = int(st.get("store_bytes") or 0)
            attributed = per_node_attr.get(node_hex, 0)
            # per-node spill-tier lifecycle (nodelet rpc_node_stats):
            # what the spill loop actually moved, not just candidates
            node_spill = {k: int(st.get(k) or 0) for k in spill_tier}
            for k, v in node_spill.items():
                spill_tier[k] += v
            nodes[node_hex] = {
                "store_bytes": used,
                "store_capacity": st.get("store_capacity"),
                "store_pinned_bytes": st.get("store_pinned_bytes"),
                "attributed_store_bytes": attributed,
                "coverage": (min(1.0, attributed / used) if used else 1.0),
                **node_spill,
            }
        return {
            "ts": time.time(),
            "records": len(records),
            "records_overflow": sum(overflow.values()),
            "subsystem_bytes": sub_bytes,
            "subsystem_store_bytes": sub_store,
            "subsystem_hwm_bytes": hwm,
            "nodes": nodes,
            "spill_tier": spill_tier,
            "top_holders": top,
            "spill_candidates": sorted(
                spill, key=lambda r: r.get("idle_s", 0.0), reverse=True),
            "spill_candidate_bytes": sum(
                int(r.get("nbytes", 0)) for r in spill),
            "leak_suspects": leaks,
            "leak_suspect_s": self.leak_suspect_s,
            "cold_after_s": self.cold_after_s,
        }
