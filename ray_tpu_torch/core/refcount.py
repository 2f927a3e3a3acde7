"""Distributed reference counting (ownership protocol).

Reference: src/ray/core_worker/reference_count.h:59 — every object has one
owner (the process whose task created it / that called put). The owner tracks:
  - local refcount: live ObjectRef pythons in the owner process
  - submitted-task count: pending tasks that take the ref as an argument
  - borrower set: other processes holding deserialized copies of the ref

A borrower registers itself with the owner when it deserializes a ref and
deregisters when its last local ref dies (the reference's WaitForRefRemoved
push protocol is simplified to borrower-initiated add/remove messages — same
liveness outcome, fewer round trips, acceptable because borrowers that die
are detected via connection loss and their borrows dropped).

When all counts reach zero the owner frees the object: deletes copies from
every node store that holds one and drops lineage if no descendant needs it.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, Optional, Set, Tuple

from ray_tpu_torch.core.common import RuntimeAddress
from ray_tpu_torch.core.ids import ObjectID


class ReferenceCounter:
    def __init__(self, self_addr_fn: Callable[[], Optional[RuntimeAddress]],
                 on_zero: Callable[[ObjectID], None],
                 notify_owner: Callable[[RuntimeAddress, str, ObjectID], None],
                 on_borrow_zero: Optional[Callable[[ObjectID], None]] = None):
        """notify_owner(owner, op, oid) sends borrow add/remove to a remote
        owner asynchronously; on_zero(oid) frees an owned object;
        on_borrow_zero(oid) drops local caches of a borrowed object whose
        last local ref died (the owner keeps the authoritative copy)."""
        self._lock = threading.Lock()
        self._self_addr_fn = self_addr_fn
        self._on_zero = on_zero
        self._notify_owner = notify_owner
        self._on_borrow_zero = on_borrow_zero or (lambda oid: None)
        # owned objects: oid -> counts
        self._local: Dict[ObjectID, int] = defaultdict(int)
        self._submitted: Dict[ObjectID, int] = defaultdict(int)
        self._borrowers: Dict[ObjectID, Set[bytes]] = defaultdict(set)
        self._owned: Set[ObjectID] = set()
        # borrowed objects: oid -> (owner, local refcount)
        self._borrowed: Dict[ObjectID, Tuple[RuntimeAddress, int]] = {}

    # --- owner side ---------------------------------------------------------

    def register_owned(self, oid: ObjectID) -> None:
        with self._lock:
            self._owned.add(oid)

    def is_owned(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._owned

    def on_ref_created(self, oid: ObjectID, owner: RuntimeAddress) -> None:
        me = self._self_addr_fn()
        mine = me is not None and owner.worker_id == me.worker_id
        with self._lock:
            if mine or oid in self._owned:
                self._local[oid] += 1
                return
            entry = self._borrowed.get(oid)
            if entry is None:
                self._borrowed[oid] = (owner, 1)
                notify = True
            else:
                self._borrowed[oid] = (entry[0], entry[1] + 1)
                notify = False
        if notify and me is not None:
            self._notify_owner(owner, "add_borrow", oid)

    def on_ref_deleted(self, oid: ObjectID, owner: RuntimeAddress) -> None:
        me = self._self_addr_fn()
        mine = me is not None and owner.worker_id == me.worker_id
        freed = False
        notify = False
        with self._lock:
            if mine or oid in self._owned:
                self._local[oid] -= 1
                freed = self._zero_locked(oid)
            else:
                entry = self._borrowed.get(oid)
                if entry is not None:
                    owner_addr, n = entry
                    if n <= 1:
                        del self._borrowed[oid]
                        notify = True
                    else:
                        self._borrowed[oid] = (owner_addr, n - 1)
        if notify:
            # last local borrow died: drop local caches (memory-store
            # entries warmed by prefetch, read pins) — no other decrement
            # event exists for borrowed ids, so skipping this leaks them
            self._on_borrow_zero(oid)
            if me is not None:
                self._notify_owner(owner, "remove_borrow", oid)
        if freed:
            self._on_zero(oid)

    def release_owned_if_unreferenced(self, oid: ObjectID) -> bool:
        """Free an owned object NOW if nothing references it. Needed for
        objects registered owned without any local ObjectRef (stream items
        the consumer never claimed): no decrement event will ever fire for
        them, so an explicit sweep is the only path to _on_zero."""
        freed = False
        with self._lock:
            if oid in self._owned:
                freed = self._zero_locked(oid)
        if freed:
            self._on_zero(oid)
        return freed

    def on_task_submitted(self, arg_ids) -> None:
        with self._lock:
            for oid in arg_ids:
                self._submitted[oid] += 1

    def on_task_done(self, arg_ids) -> None:
        freed = []
        with self._lock:
            for oid in arg_ids:
                self._submitted[oid] -= 1
                if oid in self._owned and self._zero_locked(oid):
                    freed.append(oid)
        for oid in freed:
            self._on_zero(oid)

    def add_borrower(self, oid: ObjectID, borrower_id: bytes) -> None:
        with self._lock:
            self._borrowers[oid].add(borrower_id)

    def remove_borrower(self, oid: ObjectID, borrower_id: bytes) -> None:
        freed = False
        with self._lock:
            self._borrowers[oid].discard(borrower_id)
            if oid in self._owned:
                freed = self._zero_locked(oid)
        if freed:
            self._on_zero(oid)

    def remove_borrower_everywhere(self, borrower_id: bytes) -> None:
        """Borrower process died: drop all its borrows (liveness)."""
        freed = []
        with self._lock:
            for oid, bs in self._borrowers.items():
                if borrower_id in bs:
                    bs.discard(borrower_id)
                    if oid in self._owned and self._zero_locked(oid):
                        freed.append(oid)
        for oid in freed:
            self._on_zero(oid)

    def _zero_locked(self, oid: ObjectID) -> bool:
        if oid not in self._owned:
            return False
        if (self._local.get(oid, 0) <= 0 and self._submitted.get(oid, 0) <= 0
                and not self._borrowers.get(oid)):
            self._owned.discard(oid)
            self._local.pop(oid, None)
            self._submitted.pop(oid, None)
            self._borrowers.pop(oid, None)
            return True
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "owned": len(self._owned),
                "borrowed": len(self._borrowed),
                "with_borrowers": sum(1 for b in self._borrowers.values() if b),
            }
