"""KV-page handoff primitives for disaggregated prefill/decode serving.

The prefill->decode handoff (serve/disagg.py) never serializes KV pages
into an RPC: the prefill replica exports each page GROUP (a fixed run of
full pages) as a first-class object-store object — one zero-copy
``ray_tpu_torch.put`` per group, primary pinned on the prefill node — and
mails only a small ENVELOPE of ``{hash, ref, nbytes}`` records over the
router's compiled standing channel. The decode replica resolves each ref
straight out of the store (``PagePool.adopt`` semantics: map, don't
copy) and acks; the exporter holds the per-handoff refs until that ack,
so the primaries stay pinned exactly as long as an un-adopted handoff
is in flight.

Exactly-once byte movement: groups are deduplicated by their
group-boundary chain hash against the exporter's retained LRU — a
shared prefix crosses the store ONCE no matter how many requests (or
replicas, via the GCS global prefix directory) later adopt it. The
``puts`` / ``reused_groups`` counters are the transfer-accounting
evidence the bench asserts on.

Lifecycle rules (mirrored by raylint's channel-protocol rule for the
handoff hop): export -> register -> [adopt]* -> ack; an envelope must
never be enqueued after the exporter closed, and adopt-after-teardown
of the standing channel is a protocol error.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.serve.paged_kv import page_chain_hashes


def group_boundary_hashes(tokens, page_tokens: int,
                          group_pages: int) -> List[bytes]:
    """Chain hash at each full page-GROUP boundary. The chain hash of a
    group's last page commits to every token before it, so one hash per
    group identifies the whole prefix up to that boundary — directory
    lookups walk these instead of every page hash."""
    per_page = page_chain_hashes(tokens, page_tokens)
    return [per_page[i * group_pages + group_pages - 1]
            for i in range(len(per_page) // group_pages)]


class PrefixDirectory:
    """Client for the GCS-side global prefix directory (gcs.py
    rpc_prefix_*): hash -> {ref, owner, owner_node, nbytes, last_touch}.
    Thin — every method is one gcs_call — so replicas and the router
    share one code path and the sim tests can use it directly."""

    def __init__(self):
        from ray_tpu_torch.core import runtime as rt
        self._rt = rt.get_runtime()

    def register(self, entries: List[Dict[str, Any]]) -> dict:
        return self._rt.gcs_call("prefix_register", entries=entries)

    def lookup(self, hashes: List[bytes]) -> List[Optional[dict]]:
        if not hashes:
            return []
        return self._rt.gcs_call("prefix_lookup", hashes=hashes)

    def drop(self, hashes: List[bytes], owner: str = "") -> int:
        if not hashes:
            return 0
        return self._rt.gcs_call("prefix_drop", hashes=hashes, owner=owner)

    def stats(self) -> dict:
        return self._rt.gcs_call("prefix_stats")


class HandoffExporter:
    """Prefill-side export + pin/ack bookkeeping.

    One instance per prefill replica. ``export()`` puts each NEW page
    group into the zero-copy store (dedup by group hash against the
    retained LRU), registers new groups in the global directory, and
    returns the envelope. The per-handoff ref list keeps every group's
    primary pinned until ``ack(handoff_id)`` — including groups that
    have since been evicted from the retained LRU, so an in-flight
    decode can always resolve its envelope. Retained-LRU eviction drops
    the matching directory entries (owner-scoped) before the ref dies.
    """

    def __init__(self, *, owner: str, page_tokens: int, group_pages: int,
                 retained_groups: int, directory: Optional[PrefixDirectory],
                 put: Optional[Callable[[Any], Any]] = None):
        import ray_tpu_torch
        from ray_tpu_torch.core import runtime as rt
        self.owner = owner
        self.page_tokens = int(page_tokens)
        self.group_pages = int(group_pages)
        self.group_tokens = self.page_tokens * self.group_pages
        self.retained_groups = int(retained_groups)
        self.directory = directory
        self._put = put or ray_tpu_torch.put
        self._owner_node = getattr(rt.get_runtime(), "node_id", None) or ""
        # hash -> {"ref", "nbytes"}: groups whose primaries this replica
        # keeps pinned for future reuse (spill tier absorbs overflow)
        self._groups: "OrderedDict[bytes, dict]" = OrderedDict()
        self._handoffs: Dict[str, List[Any]] = {}
        self._closed = False
        self._seq = 0
        self._lock = threading.Lock()
        self.metrics: Dict[str, Any] = {
            "handoffs": 0, "puts": 0, "reused_groups": 0,
            "put_bytes": 0, "acked": 0, "unacked_expired": 0,
            "retained_evicted": 0, "export_s": 0.0}

    def export(self, tokens: List[int],
               payload_for_group: Callable[[int, int], Any],
               nbytes_of: Callable[[Any], int],
               prompt_len: Optional[int] = None) -> Dict[str, Any]:
        """Export every full page group of `tokens`. payload_for_group
        (start_token, end_token) -> object to put (device view, numpy
        pages, ...); only called for groups not already retained.
        prompt_len overrides the envelope's recorded prompt length when
        `tokens` is a truncated exportable prefix of the real prompt."""
        if self._closed:
            raise RuntimeError("HandoffExporter is closed")
        t0 = time.time()
        per_page = page_chain_hashes(tokens, self.page_tokens)
        hashes = [per_page[i * self.group_pages + self.group_pages - 1]
                  for i in range(len(per_page) // self.group_pages)]
        groups, refs, new_entries = [], [], []
        with self._lock:
            self._seq += 1
            handoff_id = f"{self.owner}:{self._seq}"
            for i, h in enumerate(hashes):
                got = self._groups.get(h)
                if got is not None:
                    self._groups.move_to_end(h)
                    self.metrics["reused_groups"] += 1
                else:
                    payload = payload_for_group(i * self.group_tokens,
                                                (i + 1) * self.group_tokens)
                    nbytes = int(nbytes_of(payload))
                    got = {"ref": self._put(payload), "nbytes": nbytes}
                    self._groups[h] = got
                    self.metrics["puts"] += 1
                    self.metrics["put_bytes"] += nbytes
                    new_entries.append({
                        "hash": h, "ref": got["ref"], "owner": self.owner,
                        "owner_node": self._owner_node, "nbytes": nbytes,
                        "group_tokens": self.group_tokens})
                groups.append({
                    "hash": h, "ref": got["ref"],
                    "nbytes": got["nbytes"],
                    "page_hashes": per_page[i * self.group_pages:
                                            (i + 1) * self.group_pages]})
                refs.append(got["ref"])
            self._handoffs[handoff_id] = refs
            self.metrics["handoffs"] += 1
            evict_hashes = []
            while len(self._groups) > self.retained_groups:
                eh, _ = self._groups.popitem(last=False)
                evict_hashes.append(eh)
                self.metrics["retained_evicted"] += 1
        if self.directory is not None:
            if new_entries:
                self.directory.register(new_entries)
            if evict_hashes:
                self.directory.drop(evict_hashes, owner=self.owner)
        self.metrics["export_s"] += time.time() - t0
        return {"handoff_id": handoff_id, "owner": self.owner,
                "page_tokens": self.page_tokens,
                "group_tokens": self.group_tokens,
                "prompt_len": (prompt_len if prompt_len is not None
                               else len(tokens)),
                "groups": groups,
                "nbytes": sum(g["nbytes"] for g in groups)}

    def has(self, h: bytes) -> bool:
        with self._lock:
            return h in self._groups

    def seed(self, entries: List[tuple]) -> None:
        """Adopt FOREIGN groups (another replica's exports, resolved via
        the global directory) into the retained map: our future
        envelopes reference the original store objects — the bytes never
        cross the store a second time. (hash, ref, nbytes) triples; the
        held ref is a borrow, so the object outlives the owner's
        eviction while we retain it. Never re-registered: the directory
        already points at the incumbent owner's entry."""
        with self._lock:
            for h, ref, nbytes in entries:
                if h not in self._groups:
                    self._groups[h] = {"ref": ref, "nbytes": int(nbytes),
                                       "foreign": True}
                self._groups.move_to_end(h)

    def ack(self, handoff_id: str) -> bool:
        """Decode adopted (or the router abandoned) this handoff: drop
        its pin-holding refs. Retained groups stay pinned via the LRU."""
        with self._lock:
            found = self._handoffs.pop(handoff_id, None) is not None
            if found:
                self.metrics["acked"] += 1
        return found

    def lookup_warm(self, tokens: List[int]) -> int:
        """Longest leading run of tokens resolvable from the GLOBAL
        directory (any owner), in tokens. 0 when no directory."""
        if self.directory is None:
            return 0
        hashes = group_boundary_hashes(tokens, self.page_tokens,
                                       self.group_pages)
        hits = self.directory.lookup(hashes)
        n = 0
        for e in hits:
            if e is None:
                break
            n += 1
        return n * self.group_tokens

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            m = dict(self.metrics)
            m["retained_groups"] = len(self._groups)
            m["inflight_handoffs"] = len(self._handoffs)
        return m

    def close(self) -> None:
        """Drain-time teardown: unpin everything — in-flight handoffs
        included (the router re-prefills on a survivor) — and withdraw
        this owner's directory entries."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.metrics["unacked_expired"] += len(self._handoffs)
            self._handoffs.clear()
            hashes = list(self._groups)
            self._groups.clear()
        if self.directory is not None and hashes:
            try:
                self.directory.drop(hashes, owner=self.owner)
            except Exception:
                pass   # GCS may already be gone at shutdown


class HandoffAdopter:
    """Decode-side resolve: one ``ray_tpu_torch.get`` per envelope group,
    straight out of the zero-copy tier (borrowed view — no copy for
    store-local primaries). Returns payloads in prefix order."""

    def __init__(self, *, get: Optional[Callable[[Any], Any]] = None):
        import ray_tpu_torch
        self._get = get or ray_tpu_torch.get
        self._lock = threading.Lock()
        self.metrics: Dict[str, Any] = {
            "adopted_groups": 0, "adopted_bytes": 0, "adopts": 0,
            "adopt_s": 0.0, "adopt_failures": 0}

    def adopt(self, envelope: Dict[str, Any]) -> List[Any]:
        t0 = time.time()
        out = []
        try:
            for g in envelope["groups"]:
                out.append(self._get(g["ref"]))
        except Exception:
            with self._lock:
                self.metrics["adopt_failures"] += 1
            raise
        with self._lock:
            self.metrics["adopts"] += 1
            self.metrics["adopted_groups"] += len(out)
            self.metrics["adopted_bytes"] += sum(
                int(g["nbytes"]) for g in envelope["groups"])
            self.metrics["adopt_s"] += time.time() - t0
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.metrics)
