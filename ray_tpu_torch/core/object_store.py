"""Node object plane: native shm store binding + in-process memory store.

Two tiers, mirroring the reference's two store providers
(src/ray/core_worker/store_provider/):

- `SharedMemoryStore` — ctypes binding over the native C++ segment
  (ray_tpu_torch/native/objstore.cc; plasma-equivalent). All processes on a node
  attach to one segment named after the session; puts/gets are zero-copy
  in shared memory.
- `MemoryStore` — per-process dict of small/direct-return objects with
  asyncio-friendly waiters (ref: CoreWorkerMemoryStore,
  store_provider/memory_store/).

The device tier (torch.Tensor values) is deliberately per-process:
each process owns its CUDA allocations and this port shares none across
processes (no CUDA IPC), so cross-process object exchange always goes
through host bytes; the consumer places what it gets on its own device.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.status import ObjectStoreFullError

_memory_mod = None


def _memattr():
    """Cached import of the attribution tracker: observability.memory is
    stdlib-only, but its package __init__ pulls util.metrics -> runtime,
    which must not load while THIS module is mid-import (cycle)."""
    global _memory_mod
    if _memory_mod is None:
        from ray_tpu_torch.observability import memory
        _memory_mod = memory.tracker()
    return _memory_mod


class _Lib:
    _lib = None
    _lock = threading.Lock()

    @classmethod
    def get(cls):
        with cls._lock:
            if cls._lib is None:
                from ray_tpu_torch.native import ensure_built

                lib = ctypes.CDLL(ensure_built())
                lib.ts_create.restype = ctypes.c_void_p
                lib.ts_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
                lib.ts_attach.restype = ctypes.c_void_p
                lib.ts_attach.argtypes = [ctypes.c_char_p]
                lib.ts_detach.argtypes = [ctypes.c_void_p]
                lib.ts_destroy.argtypes = [ctypes.c_char_p]
                lib.ts_total_size.restype = ctypes.c_uint64
                lib.ts_total_size.argtypes = [ctypes.c_void_p]
                lib.ts_create_buf.restype = ctypes.c_uint64
                lib.ts_create_buf.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
                lib.ts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.ts_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.ts_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
                lib.ts_get.restype = ctypes.c_uint64
                lib.ts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
                lib.ts_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.ts_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.ts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.ts_bytes_in_use.restype = ctypes.c_uint64
                lib.ts_bytes_in_use.argtypes = [ctypes.c_void_p]
                lib.ts_capacity.restype = ctypes.c_uint64
                lib.ts_capacity.argtypes = [ctypes.c_void_p]
                lib.ts_num_objects.restype = ctypes.c_uint32
                lib.ts_num_objects.argtypes = [ctypes.c_void_p]
                lib.ts_num_evictions.restype = ctypes.c_uint64
                lib.ts_num_evictions.argtypes = [ctypes.c_void_p]
                lib.ts_list.restype = ctypes.c_uint32
                lib.ts_list.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32]
                lib.ts_evict.restype = ctypes.c_int
                lib.ts_evict.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int64]
                lib.ts_state.restype = ctypes.c_int
                lib.ts_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.ts_reap_creating.restype = ctypes.c_int
                lib.ts_reap_creating.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_uint64]
                lib.ts_xfer_serve_start.restype = ctypes.c_int
                lib.ts_xfer_serve_start.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
                lib.ts_xfer_serve_stop.restype = ctypes.c_int
                lib.ts_xfer_serve_stop.argtypes = []
                lib.ts_xfer_fetch.restype = ctypes.c_int
                lib.ts_xfer_fetch.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
                lib.ts_xfer_set_serve_cap.restype = None
                lib.ts_xfer_set_serve_cap.argtypes = [ctypes.c_int]
                lib.ts_xfer_busy_rejections.restype = ctypes.c_uint64
                lib.ts_xfer_busy_rejections.argtypes = []
                cls._lib = lib
            return cls._lib


class SharedMemoryStore:
    """One per process; attaches to the node's shm segment."""

    def __init__(self, name: str, capacity: int = 0, max_objects: int = 1 << 15,
                 create: bool = False):
        self._lib = _Lib.get()
        self.name = name
        cname = name.encode()
        if create:
            self._h = self._lib.ts_create(cname, capacity, max_objects)
        else:
            self._h = self._lib.ts_attach(cname)
            if not self._h:
                # transient insurance: creator publishes the magic last,
                # so an attach racing the tail of creation can miss it
                import time as _time

                for _ in range(20):
                    _time.sleep(0.05)
                    self._h = self._lib.ts_attach(cname)
                    if self._h:
                        break
        if not self._h:
            raise RuntimeError(f"object store {'create' if create else 'attach'} failed: {name}")
        total = self._lib.ts_total_size(self._h)
        # Map the same segment in Python for zero-copy views.
        fd = os.open(f"/dev/shm{name}", os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)
        self._created = create

    @property
    def closed(self) -> bool:
        return not self._h

    # -- raw byte API --------------------------------------------------------

    def put_bytes(self, oid: ObjectID, data: bytes) -> bool:
        if not self._h:
            raise RuntimeError("object store closed")
        rc = self._lib.ts_put(self._h, oid.binary(), data, len(data))
        if rc == -2:
            raise ObjectStoreFullError(
                f"object of {len(data)} bytes does not fit (store {self.name})")
        return rc == 0  # False => already present (idempotent put)

    def create_view(self, oid: ObjectID, size: int) -> Optional[memoryview]:
        if not self._h:
            return None
        off = self._lib.ts_create_buf(self._h, oid.binary(), size)
        if off == 0:
            return None
        return self._view[off:off + size]

    def seal(self, oid: ObjectID) -> None:
        if not self._h:
            return
        self._lib.ts_seal(self._h, oid.binary())

    def abort(self, oid: ObjectID) -> None:
        if not self._h:
            return
        self._lib.ts_abort(self._h, oid.binary())

    def get_view(self, oid: ObjectID) -> Optional[memoryview]:
        """Pins the object; caller must release(oid) when the view is dropped."""
        if not self._h:
            return None
        size = ctypes.c_uint64()
        off = self._lib.ts_get(self._h, oid.binary(), ctypes.byref(size))
        if off == 0:
            return None
        _memattr().touch(oid)   # temperature: every pin is an access
        return self._view[off:off + size.value]

    def release(self, oid: ObjectID) -> None:
        if not self._h:
            return
        self._lib.ts_release(self._h, oid.binary())

    def contains(self, oid: ObjectID) -> bool:
        if not self._h:
            return False
        return bool(self._lib.ts_contains(self._h, oid.binary()))

    def state(self, oid: ObjectID) -> int:
        """0 = absent, 1 = creating (mid-write), 2 = sealed."""
        if not self._h:
            return 0
        return int(self._lib.ts_state(self._h, oid.binary()))

    def reap_creating(self, max_age_s: float) -> int:
        """Free kCreating entries orphaned by a dead producer; returns
        the count freed."""
        if not self._h:
            return 0
        return int(self._lib.ts_reap_creating(self._h, int(max_age_s)))

    def delete(self, oid: ObjectID) -> None:
        if not self._h:
            return
        self._lib.ts_delete(self._h, oid.binary())

    # -- object API ----------------------------------------------------------

    def put(self, oid: ObjectID, value: Any) -> bool:
        """Serialize straight into the store (single copy for oob buffers)."""
        meta, bufs = serialization.serialize(value)
        size = serialization.serialized_size(meta, bufs)
        view = self.create_view(oid, size)
        if view is None:
            if self.contains(oid):
                return False
            raise ObjectStoreFullError(
                f"object of {size} bytes does not fit (store {self.name})")
        try:
            serialization.write_to(view, meta, bufs)
        except BaseException:
            self.abort(oid)
            raise
        finally:
            del view
        self.seal(oid)
        return True

    def get(self, oid: ObjectID, *, copy: bool = True) -> Any:
        """Deserialize. copy=False returns buffers aliasing shm (caller keeps
        the pin until it drops the value — we release immediately after
        materializing when copy=True)."""
        view = self.get_view(oid)
        if view is None:
            raise KeyError(oid)
        try:
            if copy:
                data = bytes(view)
                return serialization.unpack(data)
            return serialization.read_from(view)
        finally:
            if copy:
                del view
                self.release(oid)

    def evict_if_unpinned(self, oid: ObjectID, max_pins: int = 0) -> bool:
        """Atomically free a sealed object iff refcount <= max_pins (the
        caller's own pins). The safe spill-eviction primitive: decision and
        free happen under one native lock."""
        if not self._h:
            return False
        return self._lib.ts_evict(self._h, oid.binary(), max_pins) == 1

    def list_objects(self, max_entries: int = 4096
                     ) -> List[tuple]:
        """Sealed objects LRU-first as (ObjectID, size, pin_count) — the
        spill-candidate order (ref: eviction_policy.h LRU cache)."""
        if not self._h:
            return []
        ids = (ctypes.c_uint8 * (20 * max_entries))()
        sizes = (ctypes.c_uint64 * max_entries)()
        pins = (ctypes.c_int64 * max_entries)()
        n = self._lib.ts_list(
            self._h, ids, sizes, pins, max_entries)
        raw = bytes(ids)
        return [(ObjectID(raw[i * 20:(i + 1) * 20]), int(sizes[i]),
                 int(pins[i])) for i in range(n)]

    def pin_summary(self, max_entries: int = 4096) -> dict:
        """Spilling-readiness view: how much of the store is pinned (and
        so unspillable) and how contended the pins are. Buckets are pin
        counts; "unpinned" objects are the spill/evict headroom.
        (ref: local_object_manager.h — spilling skips pinned primaries)."""
        objs = self.list_objects(max_entries)
        pinned_bytes = 0
        pinned_objects = 0
        dist: Dict[str, int] = {}
        for _oid, size, pins in objs:
            key = str(pins) if pins < 3 else "3+"
            dist[key] = dist.get(key, 0) + 1
            if pins > 0:
                pinned_bytes += size
                pinned_objects += 1
        cap = self.capacity()
        return {
            "occupancy": (self.bytes_in_use() / cap) if cap else 0.0,
            "pinned_bytes": pinned_bytes,
            "pinned_objects": pinned_objects,
            "pin_count_distribution": dist,
        }

    # -- stats ---------------------------------------------------------------

    # ---- native transfer plane (xfer.cc) -----------------------------------

    def xfer_serve_start(self, host: str = "127.0.0.1") -> int:
        """Start the zero-staging TCP transfer server; returns the bound
        port (-1 if it could not start — callers fall back to the chunk
        RPC path)."""
        return int(self._lib.ts_xfer_serve_start(self._h, host.encode(), 0))

    def xfer_serve_stop(self) -> int:
        """Stop the transfer server, draining in-flight sender threads.
        Returns the count of threads still live after the drain window
        (0 = fully drained). Nonzero poisons close(): the segment must
        not be munmapped under a wedged sender thread."""
        leftover = int(self._lib.ts_xfer_serve_stop())
        if leftover:
            self._xfer_undrained = True
        return leftover

    def xfer_set_serve_cap(self, cap: int) -> None:
        """Cap concurrent outbound serves PER OBJECT from this process's
        transfer server (0 = unlimited; distinct objects multiplex
        freely). Over-cap pullers get a busy reply and retry — against a
        peer holder once one registers (the broadcast distribution tree,
        ref: pull_manager.h:52 holder fan-out)."""
        self._lib.ts_xfer_set_serve_cap(int(cap))

    def xfer_busy_rejections(self) -> int:
        """Count of pulls this server answered 'busy' (serve-cap hits)."""
        return int(self._lib.ts_xfer_busy_rejections())

    def xfer_fetch(self, host: str, port: int,
                   oid: ObjectID) -> "tuple[int, int]":
        """Blocking fetch of one remote object straight into this store.
        Returns (rc, total_bytes): rc 0=ok 1=absent-at-source 2=io-error
        3=alloc-failed 4=protocol 5=already-local/arriving 6=source-busy
        (at its serve cap — retry, ideally at another holder). total is
        the source-reported size (0 when unknown) — on rc=3 it tells the
        caller exactly how much space to free."""
        total = ctypes.c_uint64(0)
        rc = int(self._lib.ts_xfer_fetch(
            self._h, host.encode(), port, oid.binary(),
            ctypes.byref(total)))
        return rc, int(total.value)

    def bytes_in_use(self) -> int:
        return self._lib.ts_bytes_in_use(self._h)

    def capacity(self) -> int:
        return self._lib.ts_capacity(self._h)

    def num_objects(self) -> int:
        return self._lib.ts_num_objects(self._h)

    def num_evictions(self) -> int:
        return self._lib.ts_num_evictions(self._h)

    def close(self, destroy: bool = False, unmap: bool = True) -> None:
        """unmap=False unlinks the shm name without munmapping — the path
        for process exit while native transfer threads may still touch
        the segment (the mapping dies with the process; munmapping under
        a live xfer.cc thread would SIGSEGV it mid-transfer)."""
        if getattr(self, "_xfer_undrained", False):
            unmap = False  # a wedged xfer thread may still touch the map
        if self._h and unmap:
            try:
                self._view.release()
                self._mm.close()
            except BufferError:
                pass  # outstanding zero-copy views; leak the map, not the shm
            self._lib.ts_detach(self._h)
            self._h = None
        if destroy:
            _Lib.get().ts_destroy(self.name.encode())


class MemoryStore:
    """In-process store for small/direct-return objects.

    Thread-safe; get() blocks on a per-object event until the value arrives
    (the reference's GetAsync callback chain, memory_store.cc).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[ObjectID, Any] = {}
        self._events: Dict[ObjectID, threading.Event] = {}

    def put(self, oid: ObjectID, value: Any) -> None:
        with self._lock:
            self._objects[oid] = value
            ev = self._events.pop(oid, None)
        if ev:
            ev.set()

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._objects

    def get_if_exists(self, oid: ObjectID):
        with self._lock:
            return self._objects.get(oid, _MISSING)

    def wait_for(self, oid: ObjectID, timeout: Optional[float]) -> bool:
        with self._lock:
            if oid in self._objects:
                return True
            ev = self._events.get(oid)
            if ev is None:
                ev = self._events[oid] = threading.Event()
        return ev.wait(timeout)

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            self._objects.pop(oid, None)

    def keys(self) -> List[ObjectID]:
        with self._lock:
            return list(self._objects.keys())


_MISSING = object()
