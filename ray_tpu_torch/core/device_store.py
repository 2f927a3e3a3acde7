"""Device-resident object tier: tensors stay where they are at put time.

Port of ray_tpu/core/device_store.py, where jax.Array takes the place of
torch.Tensor. Reference: the plasma store (src/ray/object_manager/plasma/
store.h:55) is the reference's primary tier — every object is host bytes
in shm. On an accelerator the expensive copy is device<->host over PCIe,
so this tier inverts the design (SURVEY §7 step 2): `put(tensor)`
registers the live tensor in a per-process table and defers the D2H
transfer until a REMOTE consumer actually needs the bytes (host-staging
through the shm store, from where the existing native transfer plane ships
them, serialized as core/serialization.py says) or until device-memory
pressure spills it. A same-process `get` returns the identical tensor
object (`is`) — zero copies, zero D2H.

It admits a dense torch.Tensor on any device (CPU tensors too, as the
reference admits CPU jax arrays), or a dict/list/tuple tree whose EVERY
leaf is one. A remote consumer gets a CPU tensor of the same dtype and
shape.

Spill chain: device (this table) -> host shm (store) -> disk (the
nodelet's existing spill loop). This tier is deliberately per-process, as
the reference's is (it has no cross-process device sharing); the shm tier
remains the cross-process meeting point.

Tensors are mutable where jax arrays are not: a tensor must not be
written in place after `put`. The stored object IS the caller's tensor,
so an in-place write would change what every later same-process `get`
sees, and what a remote consumer gets would depend on when it was staged.
`take()` (the runtime's) is the way to get ownership back, e.g. to donate
the buffer to an in-place update.

Nothing here imports torch: a value can only be a tensor if torch is
already loaded, so CPU-only workers that never hold one never load it.
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict
from typing import Any, List, Optional, Tuple


def _is_device_array(x: Any) -> bool:
    """A dense torch.Tensor whose storage is still there."""
    mod = type(x).__module__
    if not (mod == "torch" or mod.startswith("torch.")):
        return False
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(x, torch.Tensor):
        return False
    try:
        return x.layout == torch.strided and not _storage_freed(x)
    except Exception:
        return False


def _storage_freed(t) -> bool:
    """The storage was freed (resized to 0) under a tensor that still
    claims elements: the tensor analogue of a donated/deleted jax.Array."""
    return t.numel() > 0 and t.untyped_storage().nbytes() == 0


def _tree_flatten(x: Any):
    """(leaves, rebuild) of a dict/list/tuple tree; any other value is a
    leaf. ``rebuild(leaves)`` makes fresh containers around the leaves."""
    if isinstance(x, dict):
        keys = list(x)
        parts = [_tree_flatten(x[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(leaves[i:i + len(ls)])
                i += len(ls)
            return out
    elif isinstance(x, (list, tuple)):
        parts = [_tree_flatten(v) for v in x]
        kind = type(x)

        def rebuild(leaves):
            out, i = [], 0
            for ls, rb in parts:
                out.append(rb(leaves[i:i + len(ls)]))
                i += len(ls)
            if kind is list:
                return out
            if kind is tuple:
                return tuple(out)
            return kind(*out)          # namedtuple
    else:
        return [x], lambda leaves: leaves[0]
    return [leaf for ls, _ in parts for leaf in ls], rebuild


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def is_device_value(x: Any) -> bool:
    """True for a value the device tier accepts: a dense torch.Tensor, or
    a tree whose EVERY leaf is one (the train/serve hot-path shape — a
    params tree put for weight sync). Mixed trees take the host path:
    partial residency would split one object across tiers."""
    return try_device_snapshot(x, -1) is not None


def try_device_snapshot(x: Any, min_bytes: int):
    """ONE traversal deciding device-tier admission: returns
    (snapshot, nbytes) or None. The snapshot shares every leaf tensor
    (zero-copy) but owns fresh containers, so the caller mutating its
    own dict/list after put() cannot desync the stored object or its
    byte accounting. nbytes dedupes aliased leaves (tied weights appear
    once per tensor, not once per tree path)."""
    if _is_device_array(x):
        n = _nbytes(x)
        return (x, n) if n > min_bytes else None
    if not isinstance(x, (dict, list, tuple)) or not x:
        return None
    leaves, rebuild = _tree_flatten(x)
    if not leaves or not all(_is_device_array(a) for a in leaves):
        return None
    seen, total = set(), 0
    for a in leaves:
        if id(a) not in seen:
            seen.add(id(a))
            total += _nbytes(a)
    if total <= min_bytes:
        return None
    return rebuild(leaves), total


def any_leaf_deleted(x: Any) -> bool:
    """True if any tensor in the value had its storage freed under us."""
    leaves = [x] if _is_device_array(x) else _tree_flatten(x)[0]
    for a in leaves:
        mod = type(a).__module__
        if (mod == "torch" or mod.startswith("torch.")) and \
                hasattr(a, "untyped_storage") and _storage_freed(a):
            return True
    return False


class DeviceStore:
    """oid -> live torch.Tensor (or tree of them), LRU-ordered,
    byte-accounted.

    Eviction is NOT decided here: the runtime asks for `victims(need)`
    and host-stages them through the shm store before dropping, so a
    device object is never lost — only demoted down the spill chain.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._objs: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self.total = 0

    def put(self, oid, arr, nbytes: Optional[int] = None) -> int:
        if nbytes is None:
            snap = try_device_snapshot(arr, -1)
            nbytes = snap[1] if snap else 0
        with self._lock:
            old = self._objs.pop(oid, None)
            if old is not None:
                self.total -= old[1]
            self._objs[oid] = (arr, nbytes)
            self.total += nbytes
        return nbytes

    def get(self, oid) -> Optional[Any]:
        with self._lock:
            ent = self._objs.get(oid)
            if ent is None:
                return None
            self._objs.move_to_end(oid)     # LRU touch
            return ent[0]

    def contains(self, oid) -> bool:
        with self._lock:
            return oid in self._objs

    def delete(self, oid) -> bool:
        with self._lock:
            ent = self._objs.pop(oid, None)
            if ent is None:
                return False
            self.total -= ent[1]
            return True

    def over_capacity(self) -> int:
        """Bytes above the watermark (0 if within budget)."""
        with self._lock:
            return max(self.total - self.capacity, 0)

    def victims(self, need_bytes: int) -> List[Any]:
        """Oldest-first oids whose combined size covers `need_bytes`.
        Does not remove them — the runtime stages each to shm first."""
        out, covered = [], 0
        with self._lock:
            for oid, (_, nbytes) in self._objs.items():
                if covered >= need_bytes:
                    break
                out.append(oid)
                covered += nbytes
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"objects": len(self._objs), "bytes": self.total,
                    "capacity": self.capacity}
