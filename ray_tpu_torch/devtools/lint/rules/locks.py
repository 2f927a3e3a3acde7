"""Static lockset analysis: lock-order-inversion + blocking-under-lock.

Both rules run over the project lock-acquisition graph built from
function summaries. A *section* is a ``with <lock>:`` body (or a bare
``.acquire()``) whose receiver resolves to a known ``threading.Lock /
RLock / Condition`` site — module-level or ``self.<attr>`` assigned in
the owning class. Unresolvable receivers are dropped: better to miss a
hand-rolled lock wrapper than to spray false positives through the
tier-1 gate.

**lock-order-inversion**: edge A -> B whenever B is acquired inside a
section holding A — directly, via a second ``with`` item, or through
any function transitively reachable from the section body (depth-
capped). A cycle in that graph means two threads can each hold one
lock and wait for the other. A self-edge on a non-reentrant ``Lock``
(re-acquiring the lock you hold, possibly through a helper) is the
degenerate single-thread deadlock — the ``_DEVICE_LOCK`` XLA-rendezvous
hang fixed in PR 6 was this class.

**blocking-under-lock**: a section body that performs — directly or
transitively — a blocking operation: ``ray_tpu_torch.get``/``wait``, a
thread ``join``, a ``Condition.wait`` on a *different* condition, or a
``time.sleep`` of a second or more. Every other thread touching that
lock now inherits the stall (watchdogs fire, actors miss heartbeats).
Call sites whose callee cannot be resolved are ignored; genuinely-safe
sites go in ``ALLOW_UNDER_LOCK`` with a written justification or get a
line suppression.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

# (lock key glob, blocked-op glob) pairs that are known-safe, each with
# a reason. Keep this list short and justified — it is the rule-level
# escape hatch the per-line suppression syntax cannot express (e.g. a
# pattern that recurs across call paths through one lock).
ALLOW_UNDER_LOCK: List[Tuple[str, str, str]] = [
    # collective mailbox: cv.wait with per-round timeout IS the rendezvous
    # protocol; the cv lock is released while waiting by definition.
    ("*._cv", "*.wait", "condition-wait releases its own lock"),
]


def _allowed(lock_key: str, op_name: str) -> bool:
    return any(fnmatch.fnmatch(lock_key, lk) and fnmatch.fnmatch(op_name,
                                                                 opk)
               for lk, opk, _ in ALLOW_UNDER_LOCK)


class _Section:
    __slots__ = ("lock", "kind", "nid", "summary", "raw")

    def __init__(self, lock, kind, nid, summary, raw):
        self.lock, self.kind = lock, kind
        self.nid, self.summary, self.raw = nid, summary, raw


def _sections(graph):
    """Resolved lock sections across the project."""
    out: List[_Section] = []
    for nid, s in graph.functions.items():
        module = nid.split(":", 1)[0]
        for raw in s.lock_sections:
            key, kind = graph.resolve_lock(module, s.cls, raw["expr"])
            if key:
                out.append(_Section(key, kind, nid, s, raw))
    return out


def _contains(section_raw: dict, line: int) -> bool:
    lo, hi = section_raw["span"]
    return lo <= line <= hi


def _locks_reachable(graph, nid: str, cache: Dict[str, Dict[str, list]]
                     ) -> Dict[str, list]:
    """{lock key: call path} for every lock some function reachable
    from ``nid`` acquires (anywhere in its body)."""
    if nid in cache:
        return cache[nid]
    out: Dict[str, list] = {}
    for rnid, path in graph.reach(nid, include_start=False):
        rs = graph.summary(rnid)
        if rs is None:
            continue
        rmod = rnid.split(":", 1)[0]
        for raw in rs.lock_sections:
            key, _ = graph.resolve_lock(rmod, rs.cls, raw["expr"])
            if key and key not in out:
                out[key] = path + [[f"{rs.qualname}:{raw['line']}",
                                    raw["line"], raw["col"]]]
    cache[nid] = out
    return out


def _blocking_reachable(graph, nid: str,
                        cache: Dict[str, List[tuple]]) -> List[tuple]:
    """Blocking ops in functions reachable from ``nid``:
    [(op dict, owning summary, call path)]."""
    if nid in cache:
        return cache[nid]
    out: List[tuple] = []
    for rnid, path in graph.reach(nid, include_start=False):
        rs = graph.summary(rnid)
        if rs is None:
            continue
        for b in rs.blocking:
            if _is_blocking(graph, rnid, rs, b):
                out.append((b, rs, path))
    cache[nid] = out
    return out


def _is_blocking(graph, nid: str, s, b: dict) -> bool:
    """Is this recorded op a real stall? (filters the heuristics)."""
    kind = b["kind"]
    if kind in ("get", "wait"):
        return True
    if kind == "sleep":
        secs = b.get("seconds")
        return secs is not None and secs >= 1.0
    if kind == "join":
        recv = b.get("recv", "")
        parts = recv.split(".")
        module = nid.split(":", 1)[0]
        if parts[0] == "self" and len(parts) == 2 and s.cls:
            tag, _, _ = graph.attr_type(s.cls, parts[1],
                                        prefer_module=module)
            return tag == "thread"
        if len(parts) == 1:
            return s.local_types.get(parts[0], "") == "thread"
        return False
    return False   # cond-wait handled at the section level


def _cond_wait_key(graph, nid: str, s, b: dict) -> Optional[str]:
    """Lock key of a cond-wait receiver, None if unresolved."""
    module = nid.split(":", 1)[0]
    key, kind = graph.resolve_lock(module, s.cls, b.get("recv", ""))
    return key if kind == "cond" else None


@register
class LockOrderInversion(Rule):
    id = "lock-order-inversion"
    doc = ("cyclic lock-acquisition order (A under B here, B under A "
           "elsewhere) or re-acquiring a non-reentrant Lock you hold")
    hint = ("acquire the locks in one global order everywhere, or "
            "collapse them into a single lock")
    scope = "graph"

    def check_graph(self, graph):
        sections = _sections(graph)
        lock_cache: Dict[str, Dict[str, list]] = {}
        # edges[(A, B)] = (path, line, col) proving B is taken under A
        edges: Dict[Tuple[str, str], Tuple[str, int, int, str]] = {}

        by_fn: Dict[str, List[_Section]] = {}
        for sec in sections:
            by_fn.setdefault(sec.nid, []).append(sec)

        for sec in sections:
            if sec.raw.get("acquire_only"):
                continue
            holder = sec.lock
            # (a) nested sections in the same function body
            for other in by_fn.get(sec.nid, []):
                if other is sec:
                    continue
                same_group = other.raw.get("group") is not None and \
                    other.raw.get("group") == sec.raw.get("group")
                if same_group:
                    if other.raw.get("group_idx", 0) > \
                            sec.raw.get("group_idx", 0):
                        edges.setdefault((holder, other.lock), (
                            sec.nid, other.raw["line"],
                            other.raw["col"], "multi-item with"))
                    continue
                if _contains(sec.raw, other.raw["line"]):
                    edges.setdefault((holder, other.lock), (
                        sec.nid, other.raw["line"], other.raw["col"],
                        "nested acquisition"))
            # (b) locks acquired by anything called from the body
            for name, line, col in sec.summary.calls:
                if not _contains(sec.raw, line):
                    continue
                callee = graph.resolve_call(sec.nid.split(":", 1)[0],
                                            sec.summary.cls, name)
                if callee is None:
                    continue
                inner = dict(_locks_reachable(graph, callee, lock_cache))
                own = graph.summary(callee)
                if own is not None:
                    cmod = callee.split(":", 1)[0]
                    for raw in own.lock_sections:
                        key, _ = graph.resolve_lock(cmod, own.cls,
                                                    raw["expr"])
                        if key and key not in inner:
                            inner[key] = [[name, line, col]]
                for key, path in inner.items():
                    edges.setdefault((holder, key), (
                        sec.nid, line, col,
                        f"via {name}(...)"))

        # self-edge on a non-reentrant lock = immediate deadlock
        kinds = {sec.lock: sec.kind for sec in sections}
        reported: Set[Tuple[str, ...]] = set()
        for (a, b), (nid, line, col, how) in sorted(edges.items()):
            if a == b and kinds.get(a) == "lock":
                key = ("self", a, nid, line)
                if key in reported:
                    continue
                reported.add(key)
                yield Finding(
                    rule=self.id, path=graph.fn_path.get(nid, "?"),
                    line=line, col=col,
                    message=(f"non-reentrant lock {a} re-acquired while "
                             f"already held ({how}) — single-thread "
                             "deadlock"),
                    hint="use RLock, or split the locked helper from "
                         "the locking entry point")

        # cycles of length >= 2 over distinct locks
        adj: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            if a != b:
                adj.setdefault(a, set()).add(b)

        def find_cycle(start: str) -> Optional[List[str]]:
            stack = [(start, [start])]
            seen = set()
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start:
                        return path + [start]
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append((nxt, path + [nxt]))
            return None

        for start in sorted(adj):
            cyc = find_cycle(start)
            if cyc is None:
                continue
            canon = tuple(sorted(set(cyc)))
            if canon in reported:
                continue
            reported.add(canon)
            a, b = cyc[0], cyc[1]
            nid, line, col, how = edges[(a, b)]
            yield Finding(
                rule=self.id, path=graph.fn_path.get(nid, "?"),
                line=line, col=col,
                message=("lock acquisition order cycle: "
                         + " -> ".join(cyc) + f" ({how}); two threads "
                         "taking opposite ends deadlock"),
                hint=self.hint)


@register
class BlockingUnderLock(Rule):
    id = "blocking-under-lock"
    doc = ("RPC get/wait, thread join, foreign Condition.wait, or "
           "long sleep while holding a lock — every contender stalls")
    hint = ("move the blocking call off-lock (snapshot state under the "
            "lock, block outside), or justify via ALLOW_UNDER_LOCK / "
            "a line suppression")
    scope = "graph"

    def check_graph(self, graph):
        blocking_cache: Dict[str, List[tuple]] = {}
        reported: Set[Tuple[str, int, str]] = set()

        for sec in _sections(graph):
            if sec.raw.get("acquire_only"):
                continue
            s, nid = sec.summary, sec.nid
            module = nid.split(":", 1)[0]

            # direct blocking ops inside the body
            for b in s.blocking:
                if not _contains(sec.raw, b["line"]):
                    continue
                if b["kind"] == "cond-wait":
                    ckey = _cond_wait_key(graph, nid, s, b)
                    if ckey is None or ckey == sec.lock:
                        continue   # waiting on the section's own cv
                    if _allowed(sec.lock, b["name"]):
                        continue
                    op_desc = f"{b['name']}(...) on foreign condition"
                elif _is_blocking(graph, nid, s, b):
                    if _allowed(sec.lock, b["name"]):
                        continue
                    op_desc = f"{b['name']}(...)"
                else:
                    continue
                key = (nid, b["line"], sec.lock)
                if key in reported:
                    continue
                reported.add(key)
                yield Finding(
                    rule=self.id, path=graph.fn_path.get(nid, "?"),
                    line=b["line"], col=b["col"],
                    message=(f"blocking {op_desc} while holding "
                             f"{sec.lock} — all contenders stall for "
                             "the full call"),
                    hint=self.hint)

            # blocking ops reached through calls made inside the body
            for name, line, col in s.calls:
                if not _contains(sec.raw, line):
                    continue
                callee = graph.resolve_call(module, s.cls, name)
                if callee is None:
                    continue
                hits = list(_blocking_reachable(graph, callee,
                                                blocking_cache))
                inner = graph.summary(callee)
                if inner is not None:
                    hits = [(b, inner, []) for b in inner.blocking
                            if _is_blocking(graph, callee, inner, b)] \
                        + hits
                for b, owner, path in hits:
                    if _allowed(sec.lock, b["name"]):
                        continue
                    key = (nid, line, sec.lock)
                    if key in reported:
                        continue
                    reported.add(key)
                    chain = " -> ".join([name] + [p[0] for p in path])
                    yield Finding(
                        rule=self.id,
                        path=graph.fn_path.get(nid, "?"),
                        line=line, col=col,
                        message=(f"call under {sec.lock} reaches "
                                 f"blocking {b['name']}(...) in "
                                 f"{owner.qualname} ({chain}) — the "
                                 "lock is held across the stall"),
                        hint=self.hint)
                    break
