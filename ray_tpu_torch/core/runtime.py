"""In-process runtime: the core-worker equivalent embedded in every driver and
worker process.

Reference: src/ray/core_worker/core_worker.cc — one object that does task
submission (SubmitTask :1855, CreateActor :1922, SubmitActorTask :2156),
object management (Put :1119 / Get :1331 over memory-store + plasma
providers), ownership (ReferenceCounter reference_count.h:59, TaskManager
task_manager.h:173 with retries :234 and lineage), and serves the ownership
protocol over its own RPC server (every worker is also a server).

Differences from the reference, deliberate:
- The submission path keeps the lease-reuse/pipelining idea
  (direct_task_transport.cc:24,346,588) with one queue + leased-worker set
  per scheduling class.
- Borrower registration is borrower-initiated (see refcount.py).
- The "plasma" tier is the node shm segment (native/objstore.cc); gets pin
  the object for zero-copy numpy views, released when the local ref dies.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import random
import logging
import contextvars
import threading
import time
import traceback
import weakref
from collections import OrderedDict, defaultdict, deque
from concurrent.futures import Future as SyncFuture
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import (STREAMING, Address, ObjectRef,
                                 ObjectRefGenerator, ResourceSet,
                                 RuntimeAddress, SchedulingStrategy,
                                 TaskResult, TaskSpec)
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import MemoryStore, SharedMemoryStore, _MISSING
from ray_tpu_torch.core.refcount import ReferenceCounter
from ray_tpu_torch.core.rpc import (ClientPool, ConnectionLost, EventLoopThread,
                              RemoteError, RpcServer)
from ray_tpu_torch.core.status import (ActorDiedError, ActorUnavailableError,
                                 GetTimeoutError, ObjectLostError,
                                 TaskCancelledError, TaskError,
                                 WorkerCrashedError)
from ray_tpu_torch.runtime_env import process_env as _process_env

logger = logging.getLogger("ray_tpu_torch.runtime")

# how long a call waits for an actor the GCS calls RESTARTING before it
# fails with ActorUnavailableError (a first start has no such bound)
ACTOR_RESTART_WAIT_S = 10.0

#: _fetch_from_locations result: every reachable copy answered "busy"
#: (source serve cap) — retry with refreshed locations; NOT lost.
_BUSY = object()

#: Called with the actor id (hex) when a LANE actor is torn down without
#: its process dying — modules holding per-actor state (util/collective)
#: register a pruner here, since lane packing breaks the reference's
#: "actor death == process death" cleanup.
actor_teardown_hooks: list = []

_runtime_lock = threading.Lock()
_global_runtime: Optional["Runtime"] = None


def get_runtime() -> "Runtime":
    if _global_runtime is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_runtime


def current_runtime_or_none() -> Optional["Runtime"]:
    return _global_runtime


def set_runtime(rt: Optional["Runtime"]):
    global _global_runtime
    with _runtime_lock:
        _global_runtime = rt


class _LazyEvent:
    """threading.Event's API with the Condition materialized only when a
    thread actually blocks: most owner entries complete without a
    blocking waiter, and a real Event costs ~1 KB (condition + lock +
    waiter deque) — the dominant term of deep-queue driver RSS (1M
    queued tasks held ~3.9 GB in r4, mostly entry events)."""

    __slots__ = ("_flag", "_ev")
    _mat_lock = threading.Lock()

    def __init__(self):
        self._flag = False
        self._ev: Optional[threading.Event] = None

    def is_set(self) -> bool:
        return self._flag

    def set(self):
        self._flag = True
        ev = self._ev
        if ev is not None:
            ev.set()
            # blocked waiters hold their own reference and have been
            # woken; every future wait() takes the flag fast path — keep
            # none of the ~1 KB Condition machinery on completed entries
            self._ev = None

    def clear(self):
        self._flag = False
        ev = self._ev
        if ev is not None:
            ev.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._flag:
            return True
        with _LazyEvent._mat_lock:
            ev = self._ev
            if ev is None:
                ev = self._ev = threading.Event()
        if self._flag:
            # a set() raced materialization: it may have read _ev before
            # the store above — settle the real event ourselves
            ev.set()
            return True
        return ev.wait(timeout)


class _ObjectEntry:
    """Owner-side directory entry (ref: ObjectDirectory + memory store).

    Location sets and the waiter list materialize on first use: deep
    queues create millions of entries whose inline fast path never
    touches them (~650 B/entry saved). Hot per-task paths read the
    _-prefixed slots directly to avoid materializing empties."""

    __slots__ = ("state", "inline", "_locations", "error", "event", "spec",
                 "size", "_primaries", "_waiters")

    def __init__(self):
        self.state = "pending"        # pending | ready | error | lost
        self.inline: Optional[bytes] = None
        self._locations: Optional[Set[Address]] = None
        # locations written at produce/put time; pinned on their nodes,
        # never pruned on an unverified claim (secondaries are evictable
        # and get dropped when a pull misses)
        self._primaries: Optional[Set[Address]] = None
        self.error = None             # SerializedException
        self.event = _LazyEvent()
        self.spec: Optional[TaskSpec] = None   # lineage for reconstruction
        self.size = 0                 # stored bytes (locality scheduling)
        # completion callbacks (ref: wait_manager.h WaitRequest — waits
        # are notified, never polled). Persistent: they survive an
        # event.clear() on lineage reconstruction and fire again at the
        # next completion; registrants remove them when done.
        self._waiters: Optional[List[Any]] = None

    @property
    def locations(self) -> Set[Address]:
        s = self._locations
        if s is None:
            s = self._locations = set()
        return s

    @locations.setter
    def locations(self, v: Set[Address]):
        self._locations = v

    @property
    def primaries(self) -> Set[Address]:
        s = self._primaries
        if s is None:
            s = self._primaries = set()
        return s

    @primaries.setter
    def primaries(self, v: Set[Address]):
        self._primaries = v

    @property
    def waiters(self) -> List[Any]:
        w = self._waiters
        if w is None:
            w = self._waiters = []
        return w

    @waiters.setter
    def waiters(self, v: List[Any]):
        self._waiters = v


class _LeasedWorker:
    def __init__(self, lease_id: bytes, worker_addr: Address, nodelet_addr: Address,
                 worker_id: bytes):
        self.lease_id = lease_id
        self.worker_addr = tuple(worker_addr)
        self.nodelet_addr = tuple(nodelet_addr)
        self.worker_id = worker_id


class _PendingTask:
    def __init__(self, spec: TaskSpec, retries_left: int):
        self.spec = spec
        self.retries_left = retries_left


class _ExecCtxVar:
    """Execution-context slot with threading.local's attribute interface
    but contextvars storage: per-THREAD for sync executors (as before)
    AND per-asyncio-TASK on the loop, so concurrent streaming actor
    coroutines (Serve max_concurrency) can't clobber each other's
    task_id/put_index across awaits."""

    __slots__ = ("_var",)

    def __init__(self):
        object.__setattr__(self, "_var", contextvars.ContextVar(
            "ray_tpu_torch_exec_ctx"))

    def _dict(self) -> dict:
        d = self._var.get(None)
        if d is None:
            d = {}
            self._var.set(d)
        return d

    def _replace(self, d: dict):
        """Install a FRESH dict for this task/thread. Tasks copy their
        context at creation, so mutating an inherited dict would leak
        across sibling tasks — entering an execution context must
        replace, not update."""
        self._var.set(d)

    def __getattr__(self, name):
        try:
            return self._dict()[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self._dict()[name] = value


_MEMTRACK = None


def _memtrack():
    """Cached attribution tracker (observability/memory.py). Lazy for the
    same import-cycle reason as the TelemetryAgent import in __init__."""
    global _MEMTRACK
    if _MEMTRACK is None:
        from ray_tpu_torch.observability import memory
        _MEMTRACK = memory.tracker()
    return _MEMTRACK


class _ReadPin:
    """Holds one store read pin for exactly as long as any zero-copy value
    derived from the object's bytes is alive. Deserialized arrays export
    their buffers from THIS object (PEP 688 __buffer__), so the buffer
    chain keeps the pin alive and the release fires when the LAST value
    dies — not when the ObjectRef does. Without this, `get(ref)` followed
    by dropping the ref frees the store region while the returned numpy
    view still aliases it, and the next allocation silently rewrites the
    value's bytes (ref: plasma buffers hold a client reference until the
    Python buffer object is destroyed)."""

    __slots__ = ("_store", "_oid", "_view", "__weakref__")

    def __init__(self, store, oid, view):
        self._store = store
        self._oid = oid
        self._view = view

    def __buffer__(self, flags):
        return memoryview(self._view)

    @property
    def __array_interface__(self):
        # Python < 3.12 has no PEP 688, so memoryview(pin) cannot export
        # from this object directly. numpy can: np.asarray(pin) reads this
        # interface and keeps the pin as the array's base, so slices of
        # memoryview(np.asarray(pin)) carry the same keeps-the-pin chain.
        import numpy as np

        base = np.frombuffer(self._view, dtype=np.uint8)
        ptr, _ = base.__array_interface__["data"]
        return {"shape": base.shape, "typestr": "|u1",
                "data": (ptr, True), "version": 3}

    def buffer(self) -> memoryview:
        """A memoryview whose derived slices keep THIS pin alive (works on
        interpreters without PEP 688 __buffer__ support)."""
        import numpy as np

        return memoryview(np.asarray(self))

    def __del__(self):
        self._view = None
        try:
            self._store.release(self._oid)
            _memtrack().unpin(self._oid, "read")
        except Exception:
            pass   # interpreter/store teardown


class _StreamState:
    """Owner-side record of one streaming-generator task (ref:
    task_manager.h:143-171 ObjectRefStream): item entries live in the
    ordinary object directory under ObjectID.for_return(task_id, index);
    this tracks end-of-stream and wakes blocked consumers."""

    __slots__ = ("produced", "total", "error", "kick", "consumed",
                 "abandoned", "consumed_waiters", "item_bytes",
                 "ahead_bytes")

    def __init__(self):
        self.produced = 0     # highest item index reported ready
        self.total = None     # item count once the generator finished
        self.error = None     # SerializedException raised after last item
        self.kick = threading.Event()   # pulsed on every stream update
        self.consumed = 0     # highest index handed to the consumer
        # no consumer exists (lineage re-execution of a GC'd stream):
        # items are still accepted but nothing backpressures
        self.abandoned = False
        # (release_cond, asyncio.Future) pairs: backpressured item acks
        # waiting for consumption; cond() re-evaluated under
        # Runtime._stream_lock at every consumption advance
        self.consumed_waiters: List[Tuple[Any, Any]] = []
        # unconsumed item sizes (byte-budget backpressure, ref: the data
        # layer's admission by object-store memory)
        self.item_bytes: Dict[int, int] = {}
        self.ahead_bytes = 0


class Runtime:
    """One per process. mode: "driver" | "worker"."""

    def __init__(self, cfg: Config, gcs_addr: Address, nodelet_addr: Address,
                 store_name: str, job_id: JobID, mode: str = "driver",
                 loop: Optional[asyncio.AbstractEventLoop] = None,
                 worker_id: Optional[bytes] = None,
                 node_id: Optional[str] = None):
        self.cfg = cfg
        self.mode = mode
        self.job_id = job_id
        self.worker_id = worker_id or WorkerID.from_random().binary()
        self.gcs_addr = tuple(gcs_addr)
        self.nodelet_addr = tuple(nodelet_addr)
        self.store_name = store_name
        self.node_id = node_id    # hex of the co-located nodelet's node

        # Partition-tolerance deadlines (rpc_call_timeout_s, keepalive)
        # and the optional chaos interposition layer bind per-process
        # from this Config — the driver's _system_config and the
        # spawned daemons' --config chain carry the same values, so one
        # FaultPlan and one set of deadlines govern the whole cluster.
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.devtools import chaos as _chaos
        _rpc.configure(cfg)
        _chaos.maybe_install(cfg, role=mode)   # "driver" | "worker"
        _chaos.note_peer(self.gcs_addr, "gcs")
        _chaos.note_peer(self.nodelet_addr, "nodelet")

        if loop is None:
            self.loop_thread: Optional[EventLoopThread] = EventLoopThread()
            self.loop = self.loop_thread.loop
        else:
            self.loop_thread = None
            self.loop = loop

        self.pool = ClientPool()
        self.server = RpcServer(self)
        self.memory_store = MemoryStore()
        self.store = SharedMemoryStore(store_name)
        from ray_tpu_torch.core.device_store import DeviceStore

        # HBM tier (SURVEY §7 step 2): device arrays put() here stay
        # on-device; D2H staging is lazy (first remote need / pressure)
        self.device_store = DeviceStore(cfg.device_object_store_bytes)
        self._stage_lock = threading.Lock()
        self.refs = ReferenceCounter(self._self_addr, self._free_object,
                                     self._notify_owner,
                                     on_borrow_zero=self._free_borrow_caches)
        self.directory: Dict[ObjectID, _ObjectEntry] = {}
        self._dir_lock = threading.Lock()
        # Read pins backing zero-copy values handed to the user; weakrefs
        # to _ReadPin guards, which release when the last derived value
        # dies. Spill safety against these pins lives in the native store
        # (ts_evict frees only when refcount is the nodelet's own pin).
        self._pinned: Dict[ObjectID, Any] = {}

        # submission state, per scheduling class
        self._queues: Dict[Tuple, deque] = defaultdict(deque)
        # concurrent lease-requesting pumps per class (ref: the reference's
        # max_pending_lease_requests_per_scheduling_category)
        self._max_pumps = max(8, int(cfg.max_workers_per_node))
        self._class_leases: Dict[Tuple, List[_LeasedWorker]] = defaultdict(list)
        self._class_pending_lease: Dict[Tuple, int] = defaultdict(int)
        # pumps holding a lease parked in the reuse-grace window + the
        # event a new enqueue pulses to hand them work without a fresh
        # lease RPC (ref: idle leased-worker reuse)
        self._class_parked: Dict[Tuple, int] = defaultdict(int)
        self._class_work: Dict[Tuple, asyncio.Event] = {}
        self._inflight: Dict[TaskID, _PendingTask] = {}
        # interned per-submit defaults: a deep queue must not allocate a
        # fresh ResourceSet + SchedulingStrategy per task (owner-side
        # nothing mutates them; the wire pickles copies)
        self._default_resources = ResourceSet({"CPU": 1.0})
        self._default_scheduling = SchedulingStrategy()
        # cancellation state: executing task -> worker addr (set around
        # the push), and ids whose cancel was requested (suppresses the
        # crash-retry path when force-cancel kills the worker)
        self._task_worker: Dict[TaskID, Address] = {}
        self._cancel_requested: Set[TaskID] = set()
        # pull bookkeeping: which holder served each remote pull
        # (observability — the broadcast bench/tests assert peer-sourcing
        # with it; bounded, oldest evicted), and sources that recently
        # answered "busy" (sorted last on retry so fresh holders are
        # tried first; bounded by cluster size)
        self._pull_sources: "OrderedDict[ObjectID, Address]" = OrderedDict()
        self._busy_sources: Dict[Address, float] = {}
        # streaming-generator tasks owned here (ref: task_manager.h:143-171)
        self._streams: Dict[TaskID, _StreamState] = {}
        self._stream_lock = threading.Lock()

        # actor client state
        self._actor_addr: Dict[ActorID, Optional[Address]] = {}
        self._actor_state: Dict[ActorID, dict] = {}
        self._actor_seq: Dict[ActorID, int] = defaultdict(int)
        self._actor_events: Dict[ActorID, threading.Event] = {}
        self._actor_queues: Dict[ActorID, deque] = {}
        self._actor_sending: Dict[ActorID, bool] = {}

        # execution context (worker mode): thread-local so concurrent actor
        # threads get distinct put-id spaces (ref: TaskID-scoped put indices)
        self.current_task_id: TaskID = TaskID.for_driver(job_id)
        self._exec_ctx = _ExecCtxVar()
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._fn_cache: Dict[bytes, Any] = {}
        self._exported: Set[bytes] = set()
        # weak identity cache fn-object -> fid (dead functions drop out)
        self._fid_by_obj: Any = weakref.WeakKeyDictionary()
        # (pg_id, bundle_index) -> nodelet addr; placement is static
        # after CREATED (invalidated on infeasible replies)
        self._pg_addr_cache: Dict[Tuple, Address] = {}
        self.default_runtime_env: Optional[dict] = None  # job-level env
        self._renv_cache: Dict[str, dict] = {}
        # Per-process telemetry agent: task events, spans, metric deltas
        # and edge observations batch into ONE GCS report per
        # telemetry_report_interval_s (ref: metrics_agent.py). Imported
        # lazily — observability.agent pulls in util.metrics which
        # imports this module.
        from ray_tpu_torch.observability.agent import TelemetryAgent
        self.telemetry = TelemetryAgent(self)
        # Per-process flight recorder: bounded ring of recent task
        # events/spans/channel frames, dumped as a post-mortem on stall
        # detection, uncaught worker exceptions, or CollectiveError
        # (observability/flight.py; rendered by `cli blackbox`).
        from ray_tpu_torch.observability.flight import FlightRecorder
        self.flight = FlightRecorder(self)
        # Memory attribution plane (observability/memory.py): per-object
        # ownership/pin/temperature records; snapshots ride the telemetry
        # report above. Same lazy-import rule as the agent.
        from ray_tpu_torch.observability import memory as _memory
        _memory.set_enabled(bool(cfg.memory_attribution))
        self._memattr = _memory.tracker()
        self._worker_hex = self.worker_id.hex()[:12]
        if cfg.memory_attribution:
            # the reporter otherwise starts on the first task event — a
            # process that only put/get's would never ship its read-pin
            # and orphan records (empty reports are still skipped)
            self.telemetry.ensure_started()
        # compiled-DAG output sinks by id: channel_result frames from the
        # leaf workers land here (core/channels.py, dag/compiled.py)
        self._channel_sinks: Dict[str, Any] = {}
        self._gcs_subs: Set[str] = set()  # channels to restore on failover
        self._recon_lock = threading.Lock()  # serializes reconstructions
        self._gcs_sub_gen: Optional[int] = None  # conn generation at last sub
        self.address: Optional[RuntimeAddress] = None
        self._started = False
        self._shutdown = False

    # ------------------------------------------------------------------ boot

    def start(self) -> RuntimeAddress:
        host, port = self._run(self._start_server())
        self.address = RuntimeAddress(host, port, self.worker_id)
        self._started = True
        return self.address

    async def _start_server(self):
        return await self.server.start()

    def _run(self, coro, timeout: Optional[float] = None):
        """Bridge a coroutine onto the runtime loop from any thread."""
        try:
            if asyncio.get_running_loop() is self.loop:
                raise RuntimeError(
                    "Runtime blocking call issued from the event-loop thread; "
                    "this would deadlock — move the call to an executor thread")
        except RuntimeError as e:
            if "would deadlock" in str(e):
                raise
        if self.loop_thread is not None:
            return self.loop_thread.run(coro, timeout)
        # worker mode: called from executor threads, loop runs in main thread
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def _spawn(self, coro):
        if self._shutdown:
            # late GC callbacks (ref drops during teardown) must not
            # enqueue work a stopping loop will never run — an enqueued-
            # but-never-created task leaks an un-awaited coroutine
            coro.close()
            return
        try:
            if self.loop_thread is not None:
                self.loop_thread.spawn(coro)
            else:
                self.loop.call_soon_threadsafe(
                    lambda: self.loop.create_task(coro))
        except RuntimeError:
            coro.close()  # loop already shut down (late GC callbacks)

    def _self_addr(self) -> Optional[RuntimeAddress]:
        return self.address

    def shutdown(self):
        try:
            # final batched report BEFORE tearing the loop down — the
            # flush-on-shutdown half of the agent contract
            self.telemetry.stop(flush=True)
        except Exception:
            pass
        self._shutdown = True
        try:
            self._run(self.server.stop(), timeout=2)
        except Exception:
            pass
        if self.loop_thread:
            self.loop_thread.stop()
        try:
            self.store.close()
        except Exception:
            pass
        set_runtime(None)

    # ------------------------------------------------------------ gcs helpers

    def node_call(self, addr, method: str,
                  rpc_timeout: Optional[float] = 30.0, **kw):
        """Synchronous RPC to an arbitrary daemon (nodelet/worker) —
        observability fan-outs (`ray_tpu_torch.stack()`, internal stats)."""
        return self._run(self.pool.get(tuple(addr)).call(
            method, timeout=rpc_timeout, **kw))

    def gcs_call(self, method: str, rpc_timeout: Optional[float] = 60.0,
                 clamp_attempt: bool = True, **kw):
        """kw may itself contain a `timeout` destined for the handler;
        `rpc_timeout` is the transport deadline. ``clamp_attempt=False``
        is for long-poll calls (wait_placement_group) whose handler
        legitimately blocks longer than a clamped attempt would allow.

        Retries across GCS restarts (ref: GcsClient auto-reconnect,
        _raylet.pyx:2111 _auto_reconnect) until gcs_reconnect_timeout_s.
        RpcTimeout rides the OSError family, so a gray-failed GCS (black-
        holed link, wedged handler) is retried like a lost connection and
        surfaces typed once the reconnect window closes. Jittered
        exponential backoff: every driver and worker hammers a restarting
        GCS at once, and fixed sleeps herd them into lockstep waves."""
        # lazy: ray_tpu_torch.util's package init needs ray_tpu_torch fully loaded,
        # and this module is imported during ray_tpu_torch/__init__
        from ray_tpu_torch.util.backoff import Backoff
        window = self.cfg.gcs_reconnect_timeout_s
        # Clamp the per-attempt transport deadline so a single lost
        # request frame (no connection error — just silence) can't burn
        # the whole reconnect window in one attempt: the loop gets at
        # least ~4 tries inside the window. GCS control-plane handlers
        # are idempotent by design, so re-sending after silence is safe.
        if clamp_attempt and rpc_timeout is not None:
            rpc_timeout = min(rpc_timeout, max(2.0, window / 4.0))
        bo = Backoff(base_s=0.1, cap_s=2.0,
                     deadline_s=time.time() + window)
        client = self.pool.get(self.gcs_addr)
        while True:
            try:
                out = self._run(client.call(method, timeout=rpc_timeout,
                                            **kw))
                # Resubscribe when the call ran over a NEWER connection
                # than the last subscribe batch — catches failovers that
                # happened while we were idle (the reconnect is silent;
                # ConnectionLost may never surface to any caller).
                if self._gcs_sub_gen is None:
                    self._gcs_sub_gen = client.generation
                elif client.generation != self._gcs_sub_gen:
                    self._gcs_sub_gen = client.generation
                    self._resubscribe_all()
                return out
            except (ConnectionLost, OSError):
                if self._shutdown or bo.expired():
                    raise
                time.sleep(bo.next_delay())

    def kv_put(self, ns: str, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        return self.gcs_call("kv_put", ns=ns, key=key, value=value, overwrite=overwrite)

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        return self.gcs_call("kv_get", ns=ns, key=key)

    # ---------------------------------------------------------------- objects

    def set_exec_context(self, task_id: TaskID,
                         runtime_env: Optional[dict] = None,
                         actor_id=None):
        # Nested submissions from inside this task inherit its env
        # (ref: runtime_env inheritance parent → child). actor_id rides
        # along so get_runtime_context().get_actor_id() works per LANE
        # thread — lane-packed actors share one process, so process
        # identity no longer identifies the actor.
        self._exec_ctx._replace({"task_id": task_id, "put_index": 0,
                                 "runtime_env": runtime_env,
                                 "actor_id": actor_id})

    def clear_exec_context(self):
        self._exec_ctx._replace({})

    def get_current_task_id(self) -> TaskID:
        tid = getattr(self._exec_ctx, "task_id", None)
        return tid if tid is not None else self.current_task_id

    def _next_put_id(self) -> ObjectID:
        tid = getattr(self._exec_ctx, "task_id", None)
        if tid is not None:
            self._exec_ctx.put_index += 1
            return ObjectID.for_put(tid, self._exec_ctx.put_index)
        with self._put_lock:
            self._put_index += 1
            return ObjectID.for_put(self.current_task_id, self._put_index)

    def _entry(self, oid: ObjectID) -> _ObjectEntry:
        with self._dir_lock:
            e = self.directory.get(oid)
            if e is None:
                e = self.directory[oid] = _ObjectEntry()
            return e

    def object_nbytes(self, ref: ObjectRef) -> Optional[int]:
        """Stored size of a READY object known to this runtime, else
        None — no fetch, no RPC (the data streaming executor budgets
        queued operator outputs from owner-side directory sizes)."""
        with self._dir_lock:
            e = self.directory.get(ref.id)
        if e is None or e.state != "ready":
            return None
        if e.size:
            return int(e.size)
        if e.inline is not None:
            return len(e.inline)
        return None

    def put(self, value: Any, _pin: bool = True) -> ObjectRef:
        """ref: CoreWorker::Put core_worker.cc:1119 — plus the HBM tier:
        a device array skips serialization entirely (no D2H, no shm
        write); same-process get returns the identical tensor, and
        _stage_device_object demotes it to shm only when a remote
        consumer or HBM pressure demands host bytes."""
        from ray_tpu_torch.core.device_store import try_device_snapshot

        if self.cfg.device_object_tier:
            snap = try_device_snapshot(
                value, self.cfg.max_direct_call_object_size)
            if snap is not None:
                value, nbytes = snap   # fresh containers, shared buffers
                oid = self._next_put_id()
                e = self._entry(oid)
                self.refs.register_owned(oid)
                e.size = self.device_store.put(oid, value, nbytes)
                self.memory_store.put(oid, value)
                e.state = "ready"
                self._complete_entry(e)
                self._enforce_device_capacity()
                return ObjectRef(oid, self.address)
        oid = self._next_put_id()
        meta, bufs = serialization.serialize(value)
        size = serialization.serialized_size(meta, bufs)
        e = self._entry(oid)
        self.refs.register_owned(oid)
        if size <= self.cfg.max_direct_call_object_size:
            packed = bytearray(size)
            serialization.write_to(memoryview(packed), meta, bufs)
            e.inline = bytes(packed)
            self.memory_store.put(oid, value)
        else:
            view = self._create_view_with_spill(oid, size)
            if view is None:
                if not self.store.contains(oid):
                    from ray_tpu_torch.core.status import ObjectStoreFullError

                    raise ObjectStoreFullError(f"cannot store {size} bytes")
            else:
                serialization.write_to(view, meta, bufs)
                del view
                self.store.seal(oid)
            self._attribute_put(oid, size)
            if _pin:
                self._pin_primary(oid)
            e.locations.add(self.nodelet_addr)
            e.primaries.add(self.nodelet_addr)
            e.size = size
        e.state = "ready"
        self._complete_entry(e)
        return ObjectRef(oid, self.address)

    def _attribute_put(self, oid: ObjectID, size: int):
        """Attribution record for a store-resident object this process
        just wrote: default holder "user" (subsystems retag their own),
        owner worker + creating task for the memory_report() lineage."""
        tid = getattr(self._exec_ctx, "task_id", None)
        self._memattr.attribute(
            oid, "user", size, owner=self._worker_hex,
            task=tid.hex()[:16] if hasattr(tid, "hex") else None)

    def put_batch(self, values: Sequence[Any]) -> List[ObjectRef]:
        """Batched put(): serialize every value into the store first, then
        pin the whole wave with ONE nodelet RPC instead of one blocking
        pin round-trip per object (the collective zero-copy transport
        puts pipeline_chunks sub-chunk objects per ring step). Values
        that take the device-tier or inline path fall back to put()
        per-value — there is no pin RPC to batch on those paths."""
        from ray_tpu_torch.core.device_store import try_device_snapshot

        refs: List[ObjectRef] = []
        pend: List[tuple] = []       # (oid, seal->pin guard view)
        try:
            for value in values:
                if self.cfg.device_object_tier and try_device_snapshot(
                        value, self.cfg.max_direct_call_object_size) is not None:
                    refs.append(self.put(value))
                    continue
                oid = self._next_put_id()
                meta, bufs = serialization.serialize(value)
                size = serialization.serialized_size(meta, bufs)
                e = self._entry(oid)
                self.refs.register_owned(oid)
                if size <= self.cfg.max_direct_call_object_size:
                    packed = bytearray(size)
                    serialization.write_to(memoryview(packed), meta, bufs)
                    e.inline = bytes(packed)
                    self.memory_store.put(oid, value)
                else:
                    view = self._create_view_with_spill(oid, size)
                    if view is None:
                        if not self.store.contains(oid):
                            from ray_tpu_torch.core.status import ObjectStoreFullError

                            raise ObjectStoreFullError(
                                f"cannot store {size} bytes")
                    else:
                        serialization.write_to(view, meta, bufs)
                        del view
                        self.store.seal(oid)
                    self._attribute_put(oid, size)
                    pend.append((oid, self.store.get_view(oid)))
                    e.locations.add(self.nodelet_addr)
                    e.primaries.add(self.nodelet_addr)
                    e.size = size
                e.state = "ready"
                self._complete_entry(e)
                refs.append(ObjectRef(oid, self.address))
            if pend:
                try:
                    self._run(self.pool.get(self.nodelet_addr).call(
                        "pin_objects", oids=[oid for oid, _ in pend],
                        timeout=60.0))
                    for oid, _ in pend:
                        self._memattr.pin(oid, "primary")
                except (ConnectionLost, RemoteError, OSError) as err:
                    logger.warning("pin_objects(%d) failed: %s",
                                   len(pend), err)
        finally:
            for oid, guard in pend:
                if guard is not None:
                    del guard
                    self.store.release(oid)
        return refs

    def _pin_primary(self, oid: ObjectID):
        """Ask the nodelet to pin the primary copy (ref: raylet
        PinObjectIDs). A guard pin bridges the seal→nodelet-pin window so
        eviction cannot race the handoff."""
        guard = self.store.get_view(oid)
        try:
            self._run(self.pool.get(self.nodelet_addr).call(
                "pin_object", oid=oid, timeout=30.0))
            self._memattr.pin(oid, "primary")
        except (ConnectionLost, RemoteError, OSError) as e:
            logger.warning("pin_object(%s) failed: %s", oid.hex()[:12], e)
        finally:
            if guard is not None:
                del guard
                self.store.release(oid)

    def _create_view_with_spill(self, oid: ObjectID, size: int):
        """create_view, asking the nodelet to spill for room on failure
        (ref: local_object_manager spill-on-pressure — the nodelet may
        spill even pinned primaries, since it owns those pins)."""
        view = self.store.create_view(oid, size)
        if view is not None or self.store.contains(oid):
            return view
        for _ in range(3):
            try:
                r = self._run(self.pool.get(self.nodelet_addr).call(
                    "free_space", need_bytes=size, timeout=60.0))
            except (ConnectionLost, RemoteError, OSError) as e:
                logger.warning("free_space failed: %s", e)
                return None
            view = self.store.create_view(oid, size)
            if view is not None or self.store.contains(oid):
                return view
            if r.get("freed", 0) <= 0:
                return None  # nothing left to spill; store genuinely full
        return None

    # --- HBM device tier (core/device_store.py; SURVEY §7 step 2) -----------

    def _stage_device_object(self, oid: ObjectID, drop: bool = False) -> bool:
        """Demote a device-tier object to the host shm tier: D2H +
        serialize + seal + pin, then advertise this node as a location —
        from here the existing transfer/spill machinery applies. With
        drop=True the device copy is released (pressure spill); without,
        the device copy stays the same-process fast path. Returns False
        only if the shm store cannot hold the bytes."""
        with self._stage_lock:
            arr = self.device_store.get(oid)
            if arr is None:
                return self.store.contains(oid)
            from ray_tpu_torch.core.device_store import any_leaf_deleted

            e = self._entry(oid)
            if any_leaf_deleted(arr):
                # the user donated the live buffer without take(): the
                # bytes are unrecoverable. Mark lost (an explicit error
                # on get) instead of letting the deleted-array raise
                # escape from an unrelated put()'s capacity sweep.
                self.device_store.delete(oid)
                self.memory_store.delete(oid)
                e.state = "lost"
                logger.warning(
                    "device object %s was deleted under the tier "
                    "(donated without take()?) — marked lost",
                    oid.hex()[:12])
                return False
            if not self.store.contains(oid):
                try:
                    meta, bufs = serialization.serialize(arr)  # the D2H copy
                except Exception:   # deletion raced the check above
                    self.device_store.delete(oid)
                    self.memory_store.delete(oid)
                    e.state = "lost"
                    return False
                size = serialization.serialized_size(meta, bufs)
                view = self._create_view_with_spill(oid, size)
                if view is None and not self.store.contains(oid):
                    return False
                if view is not None:
                    serialization.write_to(view, meta, bufs)
                    del view
                    self.store.seal(oid)
                self._attribute_put(oid, size)
                self._pin_primary(oid)
                with self._dir_lock:
                    e.locations.add(self.nodelet_addr)
                    e.primaries.add(self.nodelet_addr)
                e.size = size
            if drop:
                self.device_store.delete(oid)
                self.memory_store.delete(oid)
            return True

    def _enforce_device_capacity(self):
        """HBM watermark: stage LRU device objects down to shm until the
        tier fits its budget (the shm tier then spills to disk under its
        own watermarks — the full HBM->host->disk chain)."""
        over = self.device_store.over_capacity()
        if over <= 0:
            return
        for victim in self.device_store.victims(over):
            if not self._stage_device_object(victim, drop=True):
                logger.warning(
                    "device tier over budget but shm cannot absorb %s",
                    victim.hex()[:12])

    def take(self, ref: ObjectRef):
        """Donation-aware get (train/serve hot path): returns the device
        array AND withdraws it from the object tiers, transferring buffer
        ownership to the caller — safe to donate into a jit without
        invalidating a stored copy behind other readers' backs. Only the
        owner may take, and the ref must still be device-resident.
        Subsequent gets raise ObjectLostError (put objects have no
        lineage)."""
        oid = ref.id
        if not self.refs.is_owned(oid):
            raise ValueError("take() requires the owning process "
                             "(borrowers hold host copies)")
        arr = self.device_store.get(oid)
        if arr is None:
            raise ValueError(
                f"object {oid.hex()[:12]} is not device-resident "
                "(already staged, spilled, or not a device put)")
        self.device_store.delete(oid)
        self.memory_store.delete(oid)
        e = self._entry(oid)
        e.state = "lost"
        return arr

    def _free_borrow_caches(self, oid: ObjectID):
        """Last local borrow of a remote-owned object died: drop OUR
        caches only (the owner's copy is none of our business)."""
        self.memory_store.delete(oid)
        self._pinned.pop(oid, None)
        # attribution: our local record dies with the borrow (a live
        # _ReadPin keeps it visible as an orphan — the leak signature)
        self._memattr.owner_ref_dead(oid)

    def _free_object(self, oid: ObjectID):
        """All refs gone: drop every copy (ref: ReferenceCounter on-zero →
        delete from plasma + local memory store; lineage released)."""
        self.memory_store.delete(oid)
        self.device_store.delete(oid)
        # NOT store.release here: live zero-copy values hold their own
        # pin via _ReadPin and release when the last one dies
        self._pinned.pop(oid, None)
        # the delete below drops the nodelet's primary pin; a record that
        # keeps OTHER pins past this point (a still-alive zero-copy view,
        # an unacked collective chunk) becomes a leak-suspect orphan
        self._memattr.unpin(oid, "primary")
        self._memattr.owner_ref_dead(oid)
        with self._dir_lock:
            e = self.directory.pop(oid, None)
        if e is not None and e._locations:
            for addr in e._locations:
                self._spawn(self._delete_remote(addr, [oid]))

    async def _delete_remote(self, addr: Address, oids: List[ObjectID]):
        try:
            await self.pool.get(addr).call("delete_objects", oids=oids, timeout=5.0)
        except Exception:
            pass

    def _notify_owner(self, owner: RuntimeAddress, op: str, oid: ObjectID):
        async def _send():
            try:
                await self.pool.get(owner.addr).call(
                    op, oid=oid, borrower_id=self.worker_id, timeout=5.0)
            except Exception:
                pass
        self._spawn(_send())

    # --- get ----------------------------------------------------------------

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        """ref: CoreWorker::Get core_worker.cc:1331."""
        deadline = None if timeout is None else time.time() + timeout
        depth = getattr(self._exec_ctx, "get_depth", 0)
        self._exec_ctx.get_depth = depth + 1
        try:
            if len(refs) > 1:
                self._prefetch_borrowed(refs, deadline)
            return [self._get_one(r, deadline) for r in refs]
        finally:
            self._exec_ctx.get_depth = depth
            if depth == 0:
                self._end_block()

    def _prefetch_borrowed(self, refs: Sequence[ObjectRef],
                           deadline: Optional[float]):
        """Batch resolution of borrowed refs: ONE wait_objects RPC per
        distinct owner instead of a serial wait_object round-trip per ref
        (a task taking N object args would otherwise pay N round-trips —
        ref: the plasma provider's batched GetObjects). Inline results are
        cached into the memory store; everything else falls back to the
        ordinary per-ref path, which this pass only warms."""
        groups: Dict[Address, List[ObjectID]] = {}
        for r in refs:
            oid = r.id
            if self.refs.is_owned(oid) or self.memory_store.contains(oid) \
                    or self.store.contains(oid):
                continue
            groups.setdefault(tuple(r.owner.addr), []).append(oid)
        if not groups:
            return
        rem = self._remaining(deadline)
        step = min(rem, 30.0) if rem is not None else 30.0
        self._ensure_blocked()

        async def _bulk():
            async def one(addr, oids):
                try:
                    return await self.pool.get(addr).call(
                        "wait_objects", oids=oids, wait_timeout=step,
                        timeout=step + 10.0)
                except Exception:
                    return None
            return await asyncio.gather(
                *(one(a, oids) for a, oids in groups.items()))

        try:
            replies = self._run(_bulk(), timeout=step + 15.0)
        except Exception:
            return   # warming only; the per-ref path is authoritative
        for (addr, oids), reply in zip(groups.items(), replies):
            if not reply:
                continue
            for oid, r in zip(oids, reply["results"]):
                if r.get("status") == "ready" and r.get("inline") is not None:
                    try:
                        self.memory_store.put(
                            oid, serialization.unpack(r["inline"]))
                    except Exception:
                        pass

    def _ensure_blocked(self):
        """Called LAZILY from the wait paths, just before the first
        actual block: a worker blocking in get() releases its lease's
        resources so the tasks it waits on can schedule — without this a
        fleet of getters deadlocks the cluster (ref:
        NotifyDirectCallTaskBlocked). Gets that resolve locally never
        notify, keeping the hot path RPC-free."""
        if self.mode != "worker" \
                or getattr(self._exec_ctx, "task_id", None) is None \
                or getattr(self._exec_ctx, "block_notified", False):
            return
        self._exec_ctx.block_notified = True
        try:
            self.node_call(self.nodelet_addr, "worker_blocked",
                           worker_id=self.worker_id, rpc_timeout=5.0)
        except Exception:
            pass

    def _end_block(self):
        if not getattr(self._exec_ctx, "block_notified", False):
            return
        self._exec_ctx.block_notified = False
        try:
            self.node_call(self.nodelet_addr, "worker_unblocked",
                           worker_id=self.worker_id, rpc_timeout=5.0)
        except Exception:
            pass

    def _remaining(self, deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.time()
        if rem <= 0:
            raise GetTimeoutError("ray_tpu_torch.get timed out")
        return rem

    def _get_one(self, ref: ObjectRef, deadline: Optional[float], _depth: int = 0) -> Any:
        oid = ref.id
        # 1. in-process memory store
        v = self.memory_store.get_if_exists(oid)
        if v is not _MISSING:
            if isinstance(v, serialization.SerializedException):
                raise v.to_exception()
            return v
        # 2. local shm store (pin + zero-copy)
        if self.store.contains(oid):
            val = self._read_local(oid)
            if val is not _MISSING:
                return val
        if self.refs.is_owned(oid) or (self.address is not None
                                       and ref.owner.worker_id == self.worker_id):
            return self._get_owned(ref, deadline, _depth)
        return self._get_borrowed(ref, deadline, _depth)

    def _read_local(self, oid: ObjectID):
        wr = self._pinned.get(oid)
        pin = wr() if wr is not None else None
        if pin is not None and pin._view is None:
            # CPython runs tp_finalize (__del__) BEFORE clearing weakrefs,
            # so a concurrent final-deref can let wr() resurrect a pin
            # whose __del__ already ran: _view is gone and the store pin
            # released. Such a zombie must not serve reads — re-pin.
            pin = None
        if pin is None:
            view = self.store.get_view(oid)   # +1 store refcount
            if view is None:
                self._pinned.pop(oid, None)
                return _MISSING
            pin = _ReadPin(self.store, oid, view)
            self._pinned[oid] = weakref.ref(
                pin, lambda r, oid=oid: (
                    self._pinned.pop(oid, None)
                    if self._pinned.get(oid) is r else None))
            # attribute-if-missing covers copies this process did not
            # write (borrowed pulls landed by the nodelet); then count
            # the zero-copy reader against the record
            self._memattr.attribute(oid, "user", len(view),
                                    owner=self._worker_hex, copy="read")
            self._memattr.pin(oid, "read")
        else:
            self._memattr.touch(oid)   # temperature on the pinned fast path
        # values deserialize out of the pin's buffer: their buffer chains
        # keep the pin (and thus the store region) alive
        value = serialization.read_from(pin.buffer())
        if isinstance(value, serialization.SerializedException):
            raise value.to_exception()
        return value

    def _get_owned(self, ref: ObjectRef, deadline: Optional[float], _depth: int) -> Any:
        oid = ref.id
        e = self._entry(oid)
        if not e.event.is_set():
            self._ensure_blocked()
        while True:
            rem = self._remaining(deadline)
            if not e.event.wait(timeout=rem if rem is not None else 1.0):
                if rem is not None:
                    raise GetTimeoutError(f"object {oid.hex()[:12]} not ready in time")
                continue
            break
        if e.state == "error":
            raise e.error.to_exception()
        if e.state == "lost":
            return self._try_reconstruct(ref, deadline, _depth)
        v = self.memory_store.get_if_exists(oid)
        if v is not _MISSING:
            if isinstance(v, serialization.SerializedException):
                raise v.to_exception()
            return v
        if e.inline is not None:
            return serialization.unpack(e.inline)
        # value lives in some node store (snapshot under the lock:
        # puller registrations mutate the set concurrently)
        busy_rounds = 0
        while True:
            with self._dir_lock:
                locs = list(e._locations or ())
            val = self._fetch_from_locations(oid, locs, owner=self.address)
            if val is not _BUSY:
                break
            # every holder is at its serve cap: back off (escalating, so
            # a wedged source is not hammered with 20 connects/s) until a
            # slot frees or a new copy registers. _remaining raises
            # GetTimeoutError at the get deadline.
            rem = self._remaining(deadline)
            delay = min(0.5, 0.05 * (1 << min(busy_rounds, 4)))
            busy_rounds += 1
            time.sleep(min(delay, rem) if rem is not None else delay)
        if val is _MISSING:
            return self._try_reconstruct(ref, deadline, _depth)
        return val

    def _get_borrowed(self, ref: ObjectRef, deadline: Optional[float], _depth: int) -> Any:
        oid = ref.id
        owner = ref.owner
        # Local-store fast path: a sealed copy on this node is immutable
        # and valid regardless of owner state — read it with zero owner
        # RPCs. This is the hot case for same-node task fan-outs (50
        # borrowers of one driver-put arg would otherwise each queue a
        # wait_object round-trip behind the owner's busy submission loop;
        # measured 46/s -> owner-RPC-free). ref: plasma borrowers read
        # shm directly, only missing objects consult the directory.
        if self.store.contains(oid):
            val = self._read_local(oid)
            if val is not _MISSING:
                return val
        self._ensure_blocked()
        busy_rounds = 0
        while True:
            rem = self._remaining(deadline)
            step = min(rem, 5.0) if rem is not None else 5.0
            try:
                r = self._run(self.pool.get(owner.addr).call(
                    "wait_object", oid=oid, wait_timeout=step, timeout=step + 10.0), timeout=step + 15.0)
            except (ConnectionLost, RemoteError, OSError, TimeoutError) as err:
                raise ObjectLostError(
                    f"owner of {oid.hex()[:12]} unreachable: {err}") from None
            status = r["status"]
            if status == "pending":
                continue
            if status == "error":
                raise r["error"].to_exception()
            if status == "lost":
                raise ObjectLostError(f"object {oid.hex()[:12]} lost at owner")
            if r.get("inline") is not None:
                return serialization.unpack(r["inline"])
            locs = [tuple(a) for a in r["locations"]]
            val = self._fetch_from_locations(oid, locs, owner=owner)
            if val is _BUSY:
                # all holders at their serve cap: re-poll the owner —
                # the refreshed location set includes any copy a winning
                # puller registered meanwhile (the distribution tree).
                # Escalating backoff; the loop-top _remaining raises at
                # the get deadline.
                time.sleep(min(0.5, 0.05 * (1 << min(busy_rounds, 4))))
                busy_rounds += 1
                continue
            if val is _MISSING:
                # Every advertised copy is gone (their nodes died). Tell
                # the owner so it prunes the locations and re-executes
                # lineage; then retry the wait — bounded by the get
                # deadline (ref: borrower pull failures feeding
                # ObjectRecoveryManager).
                try:
                    rr = self._run(self.pool.get(owner.addr).call(
                        "recover_object", oid=oid, dead_locations=locs,
                        timeout=10.0), timeout=15.0)
                except (ConnectionLost, RemoteError, OSError,
                        TimeoutError) as err:
                    raise ObjectLostError(
                        f"owner of {oid.hex()[:12]} unreachable during "
                        f"recovery: {err}") from None
                if rr["status"] == "unrecoverable":
                    raise ObjectLostError(
                        f"object {oid.hex()[:12]} lost and not "
                        "reconstructable")
                continue  # owner is reconstructing (or has other copies)
            return val

    def _fetch_from_locations(self, oid: ObjectID, locations: List[Address],
                              owner: Optional[RuntimeAddress] = None):
        if self.store.contains(oid):
            v = self._read_local(oid)
            if v is not _MISSING:
                return v
        # Local first (may only need a spill restore); REMOTE sources are
        # shuffled so a fan-in of pullers spreads across every node that
        # already holds a copy instead of hammering the producer — with
        # copy registration below, a broadcast forms an emergent
        # distribution tree (ref: object manager location updates let
        # pulled copies serve later pulls). Sources that just answered
        # "busy" (serve cap, nodelet rpc_pull_object) sort last, so a
        # retry reaches fresh holders FIRST — that is what lets the tree
        # form within a single concurrent fan-in instead of only across
        # sequential waves.
        local = [a for a in locations if tuple(a) == self.nodelet_addr]
        remote = [a for a in locations if tuple(a) != self.nodelet_addr]
        random.shuffle(remote)
        now = time.time()
        remote.sort(key=lambda a: self._busy_sources.get(tuple(a), 0.0) > now)
        busy_seen = False
        for loc in local + remote:
            t0 = time.perf_counter()
            try:
                r = self._run(self.pool.get(self.nodelet_addr).call(
                    "pull_object", oid=oid, source=tuple(loc), timeout=120.0))
            except (ConnectionLost, RemoteError, OSError) as e:
                logger.warning("pull of %s failed: %s", oid.hex()[:12], e)
                continue
            pull_s = time.perf_counter() - t0
            if r.get("ok"):
                v = self._read_local(oid)
                if v is not _MISSING:
                    if tuple(loc) != self.nodelet_addr:
                        self._register_copy(oid, owner)
                        self._pull_sources[oid] = tuple(loc)
                        while len(self._pull_sources) > 1024:
                            self._pull_sources.popitem(last=False)
                        if r.get("nbytes"):
                            # an actual cross-node transfer happened (the
                            # nodelet omits nbytes on already-local hits)
                            self._record_pull_edge(loc, r["nbytes"], pull_s)
                    return v
            elif r.get("busy"):
                busy_seen = True
                self._busy_sources[tuple(loc)] = now + 3.0
            elif tuple(loc) != self.nodelet_addr \
                    and "not at source" in str(r.get("error", "")):
                # definitively evicted there (NOT a transient source
                # error or local store pressure) — have the owner drop
                # the stale location (primaries are pinned and never
                # pruned this way)
                self._notify_drop_location(oid, tuple(loc), owner)
        # one more local attempt (producer may be co-located)
        v = self._read_local(oid)
        if v is _MISSING and busy_seen:
            # every reachable copy is at its serve cap: signal "retry
            # with refreshed locations", NOT "lost" — a busy source must
            # never trigger recovery/reconstruction
            return _BUSY
        return v

    def _fire_and_forget(self, to_addr: Address, op: str, **kw):
        async def _send():
            try:
                await self.pool.get(tuple(to_addr)).call(op, timeout=10.0,
                                                         **kw)
            except Exception:
                pass
        self._spawn(_send())

    def _register_copy(self, oid: ObjectID, owner: Optional[RuntimeAddress]):
        """Tell the owner this node now holds a copy, so later pullers
        can fetch from here (fire-and-forget)."""
        if owner is None or owner.addr == self.address.addr:
            self._add_location_locked(oid, tuple(self.nodelet_addr))
            return
        self._fire_and_forget(owner.addr, "add_location", oid=oid,
                              addr=self.nodelet_addr)

    def _add_location_locked(self, oid: ObjectID, addr: Address):
        """Register only onto a live, ready entry (a freed/reset entry
        must not be resurrected), under the directory lock — other
        threads iterate e.locations (e.g. _locality_target)."""
        with self._dir_lock:
            e = self.directory.get(oid)
            if e is not None and e.state == "ready":
                e.locations.add(tuple(addr))

    def _notify_drop_location(self, oid: ObjectID, addr: Address,
                              owner: Optional[RuntimeAddress]):
        if owner is None or owner.addr == self.address.addr:
            self._drop_location_locked(oid, addr)
            return
        self._fire_and_forget(owner.addr, "drop_location", oid=oid,
                              addr=addr)

    def _drop_location_locked(self, oid: ObjectID, addr: Address):
        with self._dir_lock:
            e = self.directory.get(oid)
            if e is not None and tuple(addr) not in e.primaries:
                e.locations.discard(tuple(addr))

    def _reset_and_resubmit(self, spec: TaskSpec) -> bool:
        """Atomically flip the producing task's returns to pending and
        resubmit — shared by owner-side and borrower-triggered recovery.
        Returns False when another thread already has a reconstruction in
        flight (check-then-submit must be one critical section or the two
        paths double-execute and double-decrement arg refcounts)."""
        with self._recon_lock:
            rids = spec.return_ids()
            if spec.is_streaming:
                # re-execution re-yields every item; only LOST entries are
                # reset (live copies elsewhere must not be clobbered —
                # rpc_stream_item skips complete entries)
                if spec.task_id in self._inflight:
                    return False    # a re-execution is already running
                st = self._streams.get(spec.task_id)
                if st is None:
                    # generator handle was GC'd and its state dropped:
                    # revive an abandoned state so re-reported items are
                    # accepted (and nothing backpressures — no consumer)
                    st = self._streams[spec.task_id] = _StreamState()
                    st.abandoned = True
                hi = max(st.produced, st.total or 0)
                if hi == 0:
                    # state was revived: recover the watermark from the
                    # directory (item entries outlive the stream state)
                    with self._dir_lock:
                        while ObjectID.for_return(
                                spec.task_id, hi + 1) in self.directory:
                            hi += 1
                    st.produced = hi
                rids = [ObjectID.for_return(spec.task_id, i + 1)
                        for i in range(hi)]
                rids = [r for r in rids if self._entry(r).state == "lost"]
            entries = [self._entry(rid) for rid in rids]
            if not spec.is_streaming \
                    and any(en.state == "pending" for en in entries):
                return False
            for rid, re_ in zip(rids, entries):
                re_.state = "pending"
                re_.inline = None
                re_.locations = set()
                re_.primaries = set()
                re_.event.clear()
                self.refs.register_owned(rid)
        self._submit_spec(spec, retries_left=spec.max_retries)
        return True

    def _try_reconstruct(self, ref: ObjectRef, deadline: Optional[float], _depth: int) -> Any:
        """Lineage reconstruction (ref: object_recovery_manager.h — re-execute
        the producing task)."""
        oid = ref.id
        e = self._entry(oid)
        if e.spec is None or _depth > 10:
            raise ObjectLostError(
                f"object {oid.hex()[:12]} lost and not reconstructable")
        logger.warning("reconstructing %s via lineage", oid.hex()[:12])
        self._reset_and_resubmit(e.spec)
        return self._get_one(ref, deadline, _depth + 1)

    # --- wait ---------------------------------------------------------------
    # Event-driven (ref: src/ray/raylet/wait_manager.h): completions
    # notify registered waiters; nothing polls. Owned refs subscribe to
    # their directory entry in-process (zero RPCs); borrowed refs get one
    # long-lived wait_object watcher coroutine at the owner instead of a
    # locate RPC per 5 ms tick.

    def _entry_subscribe(self, e: _ObjectEntry, cb) -> bool:
        """Register a persistent completion callback. Returns True when
        the entry is already complete (callers must then check state
        themselves — the callback is NOT invoked retroactively)."""
        with self._dir_lock:
            e.waiters.append(cb)
        return e.event.is_set()

    def _entry_unsubscribe(self, e: _ObjectEntry, cb):
        with self._dir_lock:
            try:
                e.waiters.remove(cb)
            except ValueError:
                pass

    def _complete_entry(self, e: _ObjectEntry):
        """Single completion choke point: set the threading event for
        blocking getters, then fire waiter callbacks (outside the lock —
        callbacks may re-enter runtime methods)."""
        e.event.set()
        with self._dir_lock:
            waiters = list(e._waiters or ())
        for cb in waiters:
            try:
                cb()
            except Exception:
                pass

    async def _await_entry(self, e: _ObjectEntry,
                           timeout: Optional[float] = None) -> bool:
        """Await entry completion on the runtime loop without burning an
        executor thread. Returns completion status at exit."""
        if e.event.is_set():
            return True
        fut = self.loop.create_future()

        def _cb():
            try:
                self.loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_result(None))
            except RuntimeError:
                pass  # loop shut down

        already = self._entry_subscribe(e, _cb)
        try:
            if already:
                return True
            try:
                await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                pass
            return e.event.is_set()
        finally:
            self._entry_unsubscribe(e, _cb)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """ref: worker.py:2582 / CoreWorker::Wait + raylet wait_manager.h."""
        # Blocking on kick.wait from the loop thread would freeze the very
        # loop that delivers completions — fail loudly, like _run does.
        try:
            on_loop = asyncio.get_running_loop() is self.loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            raise RuntimeError(
                "Runtime.wait called from the event-loop thread; this "
                "would deadlock — move the call to an executor thread")
        deadline = None if timeout is None else time.time() + timeout
        kick = threading.Event()
        completed: Set[bytes] = set()   # oid.binary set by notifications
        stop = [False]                  # watcher stop flag (closure cell)
        subs: List[Tuple[_ObjectEntry, Any]] = []
        watchers: List[Any] = []
        ready: List[ObjectRef] = []
        pending: List[ObjectRef] = []

        def _owned_ready(e: _ObjectEntry) -> bool:
            # "lost" completes the event but is not claimable by wait()
            return e.event.is_set() and e.state in ("ready", "error")

        async def _watch_borrowed(ref: ObjectRef):
            """One watcher per borrowed pending ref: park in the owner's
            wait_object (server blocks up to wait_timeout per call) until
            a claimable status arrives."""
            oid = ref.id
            while not stop[0] and not self._shutdown:
                try:
                    r = await self.pool.get(ref.owner.addr).call(
                        "wait_object", oid=oid, wait_timeout=5.0,
                        timeout=15.0)
                except Exception:
                    await asyncio.sleep(1.0)   # owner unreachable: retry
                    continue
                if r["status"] in ("ready", "error"):
                    completed.add(oid.binary())
                    kick.set()
                    return
                if r["status"] == "lost":
                    # may be revived by lineage reconstruction — keep
                    # watching, but don't hot-loop on a terminal state
                    await asyncio.sleep(1.0)

        for r in refs:
            oid = r.id
            if self.memory_store.contains(oid) or self.store.contains(oid):
                ready.append(r)
                continue
            if self.refs.is_owned(oid):
                e = self._entry(oid)
                cb = (lambda b=oid.binary(): (completed.add(b), kick.set()))
                self._entry_subscribe(e, cb)
                subs.append((e, cb))
                if _owned_ready(e):
                    ready.append(r)
                    continue
            else:
                watchers.append(asyncio.run_coroutine_threadsafe(
                    _watch_borrowed(r), self.loop))
            pending.append(r)

        try:
            while len(ready) < num_returns and pending:
                kick.clear()
                if completed:
                    done_now = set(completed)
                    still = []
                    for r in pending:
                        if r.id.binary() in done_now:
                            claim = (_owned_ready(self._entry(r.id))
                                     if self.refs.is_owned(r.id) else True)
                            if claim:
                                ready.append(r)
                                continue
                            completed.discard(r.id.binary())
                        still.append(r)
                    pending = still
                if len(ready) >= num_returns or not pending:
                    break
                rem = None if deadline is None else deadline - time.time()
                if rem is not None and rem <= 0:
                    break
                kick.wait(rem)
        finally:
            stop[0] = True
            for e, cb in subs:
                self._entry_unsubscribe(e, cb)
            for w in watchers:
                w.cancel()
        return ready, pending

    # ------------------------------------------------------ function shipping

    def export_function(self, fn: Any) -> bytes:
        """ref: function_manager.py:61 — pickled code via GCS KV, lazy
        import. The identity fast path skips re-pickling on every .remote()
        of the same function object (pickling dominated submission cost);
        a re-DEFINED function is a different object and re-exports."""
        try:
            fid = self._fid_by_obj.get(fn)
        except TypeError:
            fid = None   # unhashable / non-weakrefable callable
        if fid is not None:
            return fid
        blob = _dumps_function(fn)
        fid = hashlib.sha1(blob).digest()
        if fid not in self._exported:
            self.kv_put("fn", fid, blob, overwrite=False)
            self._exported.add(fid)
            self._fn_cache[fid] = fn
        try:
            self._fid_by_obj[fn] = fid
        except TypeError:
            pass   # unhashable callable: no fast path
        return fid

    def load_function(self, fid: bytes) -> Any:
        fn = self._fn_cache.get(fid)
        if fn is None:
            blob = self.kv_get("fn", fid)
            if blob is None:
                raise RuntimeError(f"function {fid.hex()[:12]} not found in GCS")
            with serialization.IMPORT_LOCK:
                fn = cloudpickle.loads(blob)
            self._fn_cache[fid] = fn
        return fn

    # ------------------------------------------------------- task submission

    def resolve_runtime_env(self, env: Optional[dict]) -> Optional[dict]:
        """Validate + upload local dirs → package URIs, memoized by spec
        (ref: runtime_env packaging at task submission)."""
        from ray_tpu_torch import runtime_env as renv

        base = getattr(self._exec_ctx, "runtime_env", None) \
            or self.default_runtime_env
        if env is not None and base:
            # Task-level overrides job-level per field; env_vars deep-merge
            # with task keys winning (ref: runtime_env merge semantics).
            merged = {**base, **env}
            for field in ("env_vars", "process_env_vars"):
                if field in base or field in env:
                    merged[field] = {**base.get(field, {}),
                                     **env.get(field, {})}
        else:
            merged = env if env is not None else base
        if not merged:
            return None
        key = renv.to_json(merged)
        cached = self._renv_cache.get(key)
        if cached is None:
            cached = self._renv_cache[key] = renv.resolve_uris(self, merged)
        return cached

    def submit_task(self, fn: Callable, args: tuple, kwargs: dict, *,
                    name: str = "", num_returns: int = 1,
                    resources: Optional[ResourceSet] = None,
                    max_retries: Optional[int] = None,
                    retry_exceptions: bool = False,
                    scheduling: Optional[SchedulingStrategy] = None,
                    runtime_env: Optional[dict] = None,
                    generator_backpressure: Optional[int] = None,
                    generator_backpressure_bytes: Optional[int] = None
                    ) -> List[ObjectRef]:
        """ref: CoreWorker::SubmitTask core_worker.cc:1855."""
        fid = self.export_function(fn)
        task_id = TaskID(os_urandom4() + b"\x00" * 8 + self.job_id.binary())
        spec_args, arg_ids = self._pack_args(args, kwargs)
        mr = self.cfg.task_max_retries_default if max_retries is None else max_retries
        spec = TaskSpec(
            task_id=task_id, name=name or getattr(fn, "__name__", "task"),
            func_id=fid, args=spec_args, num_returns=num_returns,
            resources=resources or self._default_resources,
            owner=self.address, job_id=self.job_id, max_retries=mr,
            retry_exceptions=retry_exceptions,
            scheduling=scheduling or self._default_scheduling,
            runtime_env=self.resolve_runtime_env(runtime_env),
            trace_ctx=self._trace_ctx(),
            generator_backpressure=generator_backpressure,
            generator_backpressure_bytes=generator_backpressure_bytes)
        refs = self._register_returns(spec, arg_ids)
        self._submit_spec(spec, retries_left=mr)
        if spec.is_streaming:
            return ObjectRefGenerator(spec.task_id, self.address)
        return refs

    @staticmethod
    def _trace_ctx() -> Optional[dict]:
        """Caller's span context, stamped on outgoing specs
        (ref: tracing_helper.py _function_hydrate_span_args). A live
        context propagates regardless of the local enable flag — workers
        are never "enabled" process-locally, yet tasks they submit must
        continue the caller's trace."""
        from ray_tpu_torch.util import tracing

        return tracing.current_context()

    def _register_returns(self, spec: TaskSpec, arg_ids: List[ObjectID]) -> List[ObjectRef]:
        refs = []
        if spec.is_streaming:
            self._streams.setdefault(spec.task_id, _StreamState())
        for rid in spec.return_ids():
            e = self._entry(rid)
            e.spec = spec                      # lineage
            self.refs.register_owned(rid)
            refs.append(ObjectRef(rid, self.address))
        self.refs.on_task_submitted(arg_ids)
        self._inflight[spec.task_id] = _PendingTask(spec, spec.max_retries)
        self._record_event(spec, "PENDING")
        return refs

    def _pack_args(self, args: tuple, kwargs: dict):
        """Inline small values; pass ObjectRefs as deps
        (ref: dependency_resolver.h inlining)."""
        spec_args: List[Tuple[str, Any]] = []
        arg_ids: List[ObjectID] = []
        for a in args:
            if isinstance(a, ObjectRef):
                spec_args.append(("ref", (a.id, a.owner)))
                arg_ids.append(a.id)
            else:
                spec_args.append(("v", serialization.pack(a)))
        kw = {}
        for k, a in kwargs.items():
            if isinstance(a, ObjectRef):
                kw[k] = ("ref", (a.id, a.owner))
                arg_ids.append(a.id)
            else:
                kw[k] = ("v", serialization.pack(a))
        if kw:
            spec_args.append(("kw", kw))
        return spec_args, arg_ids

    def _owned_ref_args(self, spec: TaskSpec) -> List[ObjectID]:
        out = []
        for kind, payload in spec.args:
            items = [payload] if kind == "ref" else (
                [pv for (kk, pv) in payload.values() if kk == "ref"]
                if kind == "kw" else [])
            for oid, owner in items:
                if owner.addr == self.address.addr:
                    out.append(oid)
        return out

    def _submit_spec(self, spec: TaskSpec, retries_left: int):
        self._inflight.setdefault(spec.task_id, _PendingTask(spec, retries_left))
        pending = [oid for oid in self._owned_ref_args(spec)
                   if not self._entry(oid).event.is_set()]
        if pending:
            # Resolve dependencies before leasing (ref: transport/
            # dependency_resolver.h): the lease target then sees final
            # locations, so locality-aware leasing can follow the data.
            self._spawn(self._enqueue_when_ready(spec, pending))
        else:
            self._enqueue_now(spec)

    def _enqueue_now(self, spec: TaskSpec):
        # The queue key includes the locality target (deps are resolved by
        # now, so it's final): a lease acquired for one queue only ever
        # drains tasks that want that same placement, so pipelining can't
        # drag a task onto a node its own data isn't on.
        target = (self._locality_target(spec)
                  if spec.scheduling.kind == "DEFAULT" else None)
        cls = (spec.scheduling_class(), target)
        q = self._queues[cls]
        q.append(spec)
        # Bound PENDING LEASE REQUESTS, not live pumps (ref:
        # direct_task_transport.cc lease rate limiting): a pump per
        # submission would fire one lease RPC per queued task — 100k
        # queued tasks must not mean 100k in-flight lease requests. But
        # pumps already HOLDING leases must not suppress new ones: a pump
        # can be parked inside a long-running push (a streaming task
        # blocks its worker for the stream's whole lifetime), and gating
        # on total pump count deadlocks the still-queued siblings that
        # the consumer is waiting on.
        parked = self._class_parked[cls]
        if parked > 0:
            # leased worker(s) parked in the reuse-grace window: hand them
            # the work instead of firing fresh lease RPCs — but ONLY as
            # far as they can absorb it; a burst deeper than the parked
            # pool must still spawn pumps or a 100-task fan-out would
            # serialize onto one worker
            ev = self._class_work.get(cls)
            if ev is not None:
                self.loop.call_soon_threadsafe(ev.set)
            if len(q) <= parked:
                return
        if self._class_pending_lease[cls] < self._max_pumps:
            self._spawn(self._pump_class(cls))

    async def _enqueue_when_ready(self, spec: TaskSpec,
                                  pending: List[ObjectID]):
        for oid in pending:
            e = self._entry(oid)
            # event-driven: a completion callback wakes us; the 1 s cap
            # only bounds shutdown latency, there is no busy-poll
            while not e.event.is_set() and not self._shutdown:
                await self._await_entry(e, timeout=1.0)
        # Errored/lost deps still dispatch: the executing worker surfaces
        # the dependency failure as the task's error (same as the ref,
        # where the raylet cancels on dep failure and the owner raises).
        self._enqueue_now(spec)

    async def _pump_class(self, cls: Tuple):
        """One pump == one leased worker draining this class's queue. Each
        submission spawns a pump, so parallelism grows with queue depth (the
        nodelet's worker pool is the actual cap); a pump that wins no work
        returns its lease immediately. ref: direct_task_transport.cc:346
        RequestNewWorkerIfNeeded + pipelining onto leased workers :588."""
        q = self._queues[cls]
        if not q:
            return
        # Re-check the bound HERE, on the loop (atomically w.r.t. other
        # pumps): the spawn-time check runs on the submitting thread and
        # reads a stale counter during bursts — a 100k-submission loop
        # would otherwise spawn 100k pumps that all fire lease RPCs once
        # the loop catches up. Excess pumps exit; the drain + exit-respawn
        # path keeps liveness.
        if self._class_pending_lease[cls] >= self._max_pumps:
            return
        self._class_pending_lease[cls] += 1
        try:
            lw = await self._acquire_lease(q[0], preferred=cls[1])
        except Exception:
            logger.exception("lease acquisition failed")
            lw = None
        finally:
            self._class_pending_lease[cls] -= 1
        if lw is None:
            if q and not self._shutdown:
                await asyncio.sleep(0.2)
                if self._queues[cls]:
                    self._spawn(self._pump_class(cls))
            return
        self._class_leases[cls].append(lw)
        try:
            while True:
                try:
                    spec = q.popleft()
                except IndexError:
                    # queue drained: park the lease for the reuse-grace
                    # window — a submit landing in it rides this worker
                    # with zero lease RPCs (ref: idle leased-worker reuse)
                    grace = self.cfg.lease_reuse_grace_s
                    if grace <= 0 or self._shutdown:
                        break
                    ev = self._class_work.get(cls)
                    if ev is None:
                        ev = self._class_work[cls] = asyncio.Event()
                    ev.clear()
                    if q:        # landed between drain and clear
                        continue
                    self._class_parked[cls] += 1
                    try:
                        await asyncio.wait_for(ev.wait(), grace)
                    except asyncio.TimeoutError:
                        break
                    finally:
                        self._class_parked[cls] -= 1
                    continue
                if spec.task_id in self._cancel_requested:
                    # cancelled in the window between queue-pop and push
                    self._cancel_requested.discard(spec.task_id)
                    self._fail_task_returns(spec, TaskCancelledError(
                        f"task {spec.name} cancelled before execution"))
                    self._record_event(spec, "CANCELLED")
                    continue
                if not await self._push_and_handle(spec, lw, cls):
                    break     # worker died; retries repump on a fresh lease
        finally:
            self._class_leases[cls].remove(lw)
            await self._return_lease(lw)
            # a task enqueued while this pump was between its last queue
            # check and the lease return may have been gated out — liveness
            # requires the exiting pump to respawn when work remains
            if self._queues[cls] and not self._shutdown:
                self._spawn(self._pump_class(cls))

    def _locality_target(self, spec: TaskSpec) -> Optional[Address]:
        """Lease-target choice by data locality (ref: lease_policy.h
        LocalityAwareLeasePolicy): prefer the nodelet already holding the
        most argument bytes, so big args need no transfer. Only owned,
        store-resident args count — inlined values and borrowed refs
        (whose locations live at their owner) don't steer placement."""
        scores: Dict[Address, int] = {}
        for oid in self._owned_ref_args(spec):
            with self._dir_lock:
                e = self.directory.get(oid)
                if e is None or e.state != "ready" or e.inline is not None:
                    continue
                locs = list(e._locations or ())  # snapshot: mutated by add_location
                size = e.size
            for loc in locs:
                loc = tuple(loc)
                scores[loc] = scores.get(loc, 0) + max(size, 1)
        if not scores:
            return None
        return max(scores.items(), key=lambda kv: kv[1])[0]

    async def _pg_bundle_addr(self, pg_id, bundle_index: int,
                              resources: Optional[ResourceSet] = None,
                              refresh: bool = False) -> Optional[Address]:
        """Resolve the nodelet hosting a PG bundle (index -1 = first
        placed bundle whose declared capacity fits `resources`). PG-task
        leases MUST go to the reserving node — any other nodelet answers
        "bundle not here" forever (ref: PG tasks dispatch against the
        bundle's reserved resources on its raylet). Placement is static
        after CREATED, so resolutions are cached per (pg, bundle);
        refresh=True (after an infeasible reply) re-reads the GCS —
        bundle replacement after node death moves the address."""
        key = (pg_id, bundle_index)
        if not refresh:
            hit = self._pg_addr_cache.get(key)
            if hit is not None:
                return hit
        try:
            pg = await self.pool.get(self.gcs_addr).call(
                "get_placement_group", pg_id=pg_id)
            if not pg:
                return None
            cands = [b for b in pg["bundles"]
                     if b["node_id"] is not None
                     and (bundle_index < 0 or b["index"] == bundle_index)]
            if bundle_index < 0 and resources is not None:
                fitting = [b for b in cands
                           if resources.fits_in(
                               ResourceSet(dict(b["resources"])))]
                cands = fitting or cands
            if not cands:
                return None
            node_id = cands[0]["node_id"]
            nodes = await self.pool.get(self.gcs_addr).call("get_nodes")
            for n in nodes:
                if n.node_id == node_id and n.alive:
                    addr = tuple(n.nodelet_addr)
                    self._pg_addr_cache[key] = addr
                    return addr
        except (ConnectionLost, RemoteError, OSError):
            pass
        return None

    async def _acquire_lease(self, spec: TaskSpec,
                             preferred: Optional[Address] = None
                             ) -> Optional[_LeasedWorker]:
        target = preferred or self.nodelet_addr
        pg = None
        if spec.scheduling.kind == "PLACEMENT_GROUP":
            pg = (spec.scheduling.pg_id, spec.scheduling.bundle_index)
            t = await self._pg_bundle_addr(spec.scheduling.pg_id,
                                           spec.scheduling.bundle_index,
                                           resources=spec.resources)
            if t is not None:
                target = t
        affinity_addr = None
        if spec.scheduling.kind == "NODE_AFFINITY":
            nodes = await self.pool.get(self.gcs_addr).call("get_nodes")
            for n in nodes:
                if n.node_id == spec.scheduling.node_id:
                    affinity_addr = target = tuple(n.nodelet_addr)
                    break
        deadline = time.time() + self.cfg.worker_lease_timeout_s * 4
        while time.time() < deadline:
            # Fresh idempotency token per attempt: a duplicated frame of
            # THIS request dedupes at the nodelet (no double grant), while
            # a deliberate retry re-attempts with a new token.
            idem = os.urandom(12).hex()
            try:
                r = await self.pool.get(tuple(target)).call(
                    "request_lease", resources=spec.resources, pg=pg,
                    job_id=spec.job_id.binary(),
                    retriable=spec.max_retries != 0,
                    env_vars=_process_env(spec.runtime_env),
                    idem=idem,
                    timeout=self.cfg.worker_lease_timeout_s + 10.0)
            except (ConnectionLost, RemoteError, OSError) as e:
                logger.warning("lease request to %s failed: %s", target, e)
                if affinity_addr is not None and not spec.scheduling.soft:
                    # hard affinity: a transient RPC failure must not
                    # quietly re-target the driver's node
                    target = affinity_addr
                else:
                    target = self.nodelet_addr
                await asyncio.sleep(0.2)
                continue
            st = r["status"]
            if st == "granted":
                from ray_tpu_torch.devtools.chaos import note_peer
                note_peer(tuple(r["worker_addr"]), "worker")
                return _LeasedWorker(r["lease_id"], r["worker_addr"], tuple(target),
                                     r["worker_id"])
            if st == "spillback":
                if affinity_addr is not None and not spec.scheduling.soft:
                    # hard affinity (ref: NodeAffinitySchedulingStrategy
                    # soft=False): the task runs on ITS node or not at
                    # all — never follow a spillback elsewhere
                    await asyncio.sleep(0.1)
                    continue
                target = tuple(r["addr"])
                from ray_tpu_torch.devtools.chaos import note_peer
                note_peer(target, "nodelet")
                continue
            if st == "retry":
                await asyncio.sleep(0.05)
                continue
            if st == "infeasible":
                # Stay pending while the cluster may grow (the reference
                # parks infeasible tasks in a queue surfaced to the
                # autoscaler; our GCS records the unmet demand on every
                # pick_node miss). Fail only after the extended deadline.
                await asyncio.sleep(0.5)
                if pg is not None:
                    # the bundle may have (re)placed on another node
                    t = await self._pg_bundle_addr(
                        pg[0], pg[1], resources=spec.resources,
                        refresh=True)
                    target = t if t is not None else self.nodelet_addr
                elif affinity_addr is not None and not spec.scheduling.soft:
                    target = affinity_addr   # hard affinity: wait it out
                else:
                    target = self.nodelet_addr
                continue
        # Deadline expired with the task still unschedulable. Same scheduling
        # class == same resource demand, so the whole queue is infeasible
        # (ref: infeasible queue surfaced to the autoscaler; we surface the
        # error to callers after the grace window).
        err = RuntimeError(
            f"infeasible task: no node can satisfy "
            f"{spec.resources.quantities} within deadline")
        q = self._queues[(spec.scheduling_class(), preferred)]
        self._fail_task_returns(spec, err)
        while q:
            s = q.popleft()
            if s.task_id != spec.task_id:
                self._fail_task_returns(s, err)
        return None

    async def _return_lease(self, lw: _LeasedWorker):
        try:
            await self.pool.get(lw.nodelet_addr).call("return_lease",
                                                      lease_id=lw.lease_id, timeout=5.0)
        except Exception:
            pass

    async def _push_and_handle(self, spec: TaskSpec, lw: _LeasedWorker,
                               cls: Tuple) -> bool:
        """Push one task to a leased worker. Returns False when the worker
        is dead (the caller must abandon this lease; retries are re-enqueued
        and repumped onto a fresh lease)."""
        self._record_event(spec, "RUNNING", worker=lw.worker_id.hex()[:12])
        self._task_worker[spec.task_id] = lw.worker_addr
        try:
            # timeout=None (reviewed): a task legitimately runs for hours;
            # worker death surfaces as ConnectionLost via the keepalive,
            # so this await is bounded by liveness, not a deadline.
            result: TaskResult = await self.pool.get(lw.worker_addr).call(
                "push_task", spec=spec, timeout=None)  # raylint: disable=unbounded-rpc-call -- liveness-bounded
        except (ConnectionLost, RemoteError, OSError) as e:
            pt = self._inflight.get(spec.task_id)
            if spec.task_id in self._cancel_requested:
                # force-cancel killed the worker under this push: that's
                # cancellation, not a crash — never retried
                self._fail_task_returns(spec, TaskCancelledError(
                    f"task {spec.name} cancelled (force)"))
            elif pt is not None and pt.retries_left > 0:
                pt.retries_left -= 1
                logger.warning("task %s worker died (%s); retrying (%d left)",
                               spec.name, e, pt.retries_left)
                self._record_event(spec, "FAILED_RETRYING")
                self._queues[cls].append(spec)
                self._spawn(self._pump_class(cls))
            else:
                asyncio.get_running_loop().run_in_executor(
                    None, self.flight.dump, f"worker_crashed:{spec.name}",
                    {"task_id": spec.task_id.hex(), "error": str(e)})
                self._fail_task_returns(spec, WorkerCrashedError(
                    f"worker died running {spec.name}: {e}"))
            return False
        finally:
            self._task_worker.pop(spec.task_id, None)
            self._cancel_requested.discard(spec.task_id)
        self._complete_task(spec, result, cls,
                            worker=lw.worker_id.hex()[:12])
        return True

    def _complete_task(self, spec: TaskSpec, result: TaskResult,
                       cls: Optional[Tuple], worker: Optional[str] = None):
        self._cancel_requested.discard(spec.task_id)   # no leak on any path
        app_error = None
        for kind, payload in result.returns:
            if kind == "err":
                app_error = payload
                break
        if app_error is not None and spec.retry_exceptions:
            pt = self._inflight.get(spec.task_id)
            if pt is not None and pt.retries_left > 0:
                pt.retries_left -= 1
                self._record_event(spec, "FAILED_RETRYING")
                self._queues[cls].append(spec)
                self._spawn(self._pump_class(cls))
                return
        if spec.is_streaming:
            self._finalize_stream_on_result(spec, error=app_error)
        for (kind, payload), rid in zip(result.returns, spec.return_ids()):
            e = self._entry(rid)
            if kind == "inline":
                e.inline = payload
                try:
                    self.memory_store.put(rid, serialization.unpack(payload))
                except Exception:
                    pass
            elif kind == "store":
                if isinstance(payload, dict):
                    e.locations.add(tuple(payload["addr"]))
                    e.primaries.add(tuple(payload["addr"]))
                    e.size = payload.get("size", 0)
                else:
                    e.locations.add(tuple(payload))
                    e.primaries.add(tuple(payload))
            elif kind == "err":
                e.error = payload
                e.state = "error"
                self.memory_store.put(rid, payload)
            if e.state != "error":
                e.state = "ready"
            self._complete_entry(e)
        self._record_event(spec, "FAILED" if app_error else "FINISHED",
                           worker=worker)
        self._inflight.pop(spec.task_id, None)
        arg_ids = [p[0] for (k, p) in spec.args if k == "ref"]
        self.refs.on_task_done(arg_ids)
        if (app_error is None and not spec.is_streaming and result.returns
                and all(k == "inline" for k, _ in result.returns)):
            # Every return landed INLINE, owner-side: the values live in
            # this process and can never be lost, so the spec serves no
            # lineage purpose — drop it. Deep queues retain ~KB of spec
            # per completed task otherwise (1M-task run: multi-GB driver
            # RSS; ref: reference_count.h:59 pins lineage only while an
            # object could need reconstruction).
            with self._dir_lock:
                for rid in spec.return_ids():
                    ent = self.directory.get(rid)
                    if ent is not None:
                        ent.spec = None

    def _fail_task_returns(self, spec: TaskSpec, exc: BaseException):
        # System errors re-raise as themselves at the caller, not TaskError.
        ser = serialization.SerializedException(exc, "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)),
            wrap=False)
        if spec.is_streaming:
            self._finalize_stream_on_result(spec, error=ser)
        for rid in spec.return_ids():
            e = self._entry(rid)
            e.error = ser
            e.state = "error"
            self._complete_entry(e)
            self.memory_store.put(rid, ser)
        self._record_event(spec, "FAILED")
        self._inflight.pop(spec.task_id, None)

    # ----------------------------------------------------------------- actors

    def create_actor(self, cls: type, args: tuple, kwargs: dict, *,
                     name: Optional[str] = None, namespace: str = "default",
                     resources: Optional[ResourceSet] = None,
                     max_restarts: int = 0, max_concurrency: int = 1,
                     scheduling: Optional[SchedulingStrategy] = None,
                     lifetime: Optional[str] = None,
                     runtime_env: Optional[dict] = None) -> ActorID:
        """ref: CoreWorker::CreateActor core_worker.cc:1922 → GCS RegisterActor."""
        fid = self.export_function(cls)
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.of(actor_id)
        spec_args, arg_ids = self._pack_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id, name=getattr(cls, "__name__", "Actor"),
            func_id=fid, args=spec_args, num_returns=0,
            resources=resources or ResourceSet({"CPU": 1.0}),
            owner=self.address, job_id=self.job_id,
            scheduling=scheduling or SchedulingStrategy(),
            is_actor_creation=True, actor_id=actor_id,
            max_restarts=max_restarts, max_concurrency=max_concurrency,
            actor_name=name, namespace=namespace,
            runtime_env=self.resolve_runtime_env(runtime_env),
            trace_ctx=self._trace_ctx())
        self.refs.on_task_submitted(arg_ids)
        r = self.gcs_call("register_actor", spec=spec)
        if not r.get("ok"):
            raise ValueError(r.get("error", "actor registration failed"))
        self._actor_addr[actor_id] = None
        self._subscribe_actor(actor_id)
        return actor_id

    def _subscribe_channel(self, channel: str):
        """Register a pubsub channel; remembered for resubscription after
        a GCS failover (ref: GcsClient resubscribe on reconnect,
        _raylet.pyx:2111 _auto_reconnect)."""
        self._gcs_subs.add(channel)

        async def _sub():
            try:
                await self.pool.get(self.gcs_addr).call(
                    "subscribe", channel=channel,
                    addr=self.address.addr, timeout=5.0)
            except Exception:
                pass
        self._spawn(_sub())

    def _resubscribe_all(self):
        """After the GCS came back: re-register every channel (a
        memory-storage GCS or one that died between snapshots lost its
        subscriber table)."""
        for ch in list(self._gcs_subs):
            async def _sub(ch=ch):
                try:
                    await self.pool.get(self.gcs_addr).call(
                        "subscribe", channel=ch, addr=self.address.addr,
                        timeout=5.0)
                except Exception:
                    pass
            self._spawn(_sub())

    def _subscribe_actor(self, actor_id: ActorID):
        self._subscribe_channel(f"actor:{actor_id.hex()}")

    async def rpc_pubsub_message(self, channel: str, message: Any):
        if channel.startswith("actor:"):
            aid = ActorID.from_hex(channel.split(":", 1)[1])
            self._actor_state[aid] = message
            self._actor_addr[aid] = tuple(message["address"]) if message.get("address") else None
            if self._actor_addr[aid] is not None:
                from ray_tpu_torch.devtools.chaos import note_peer
                note_peer(self._actor_addr[aid], "worker")
            ev = self._actor_events.get(aid)
            if ev:
                ev.set()
            if message.get("state") == "DEAD":
                # terminal: prune the channel so _gcs_subs stays bounded
                # and failover resubscription doesn't replay dead actors
                self._gcs_subs.discard(channel)
                try:
                    await self.pool.get(self.gcs_addr).call(
                        "unsubscribe", channel=channel,
                        addr=self.address.addr, timeout=5.0)
                except Exception:
                    pass
        elif channel == "log":
            self._on_log(message)

    # ------------------------------------------------- compiled-DAG sinks

    def register_channel_sink(self, sink_id: str, sink: Any) -> None:
        """Accept channel_result frames for one CompiledDAG's output."""
        self._channel_sinks[sink_id] = sink

    def unregister_channel_sink(self, sink_id: str) -> None:
        self._channel_sinks.pop(sink_id, None)

    def deliver_channel_result(self, sink_id: str, seq: int, slot: int,
                               kind: str, payload: bytes) -> bool:
        """Local fast path for a leaf channel hosted in this process;
        returns False when the sink is gone (torn down)."""
        sink = self._channel_sinks.get(sink_id)
        if sink is None:
            return False
        sink.deliver(seq, slot, kind, payload)
        return True

    def rpc_channel_result(self, sink_id: str, seq: int, slot: int,
                           kind: str, payload: bytes) -> dict:
        # synchronous up to the enqueue (frames keep wire order) and
        # inline-eligible: ONEWAY results skip the dispatch-task round
        if not self.deliver_channel_result(sink_id, seq, slot, kind,
                                           payload):
            return {"ok": False, "error": "no such sink"}
        return {"ok": True}

    rpc_channel_result._rpc_inline = True

    def _on_log(self, message: dict):
        """Driver-side worker log fan-in (ref: worker.py:1758
        print_to_stdstream)."""
        if self.mode != "driver" or not self.cfg.log_to_driver:
            return
        import sys

        for entry in message.get("lines", []):
            stream = sys.stderr if entry.get("stream") == "err" else sys.stdout
            print(f"({entry.get('source', '?')}) {entry.get('line', '')}",
                  file=stream)

    def subscribe_logs(self):
        self._subscribe_channel("log")

    async def _resolve_actor(self, actor_id: ActorID,
                             timeout: Optional[float] = None) -> Address:
        """Wait for the actor to be ALIVE. No arbitrary deadline while it
        is first starting: like the reference's actor submit queue, calls
        buffer (a 200-actor fleet on a slow node takes minutes to spawn)
        and fail only when the GCS declares it DEAD — or the optional
        caller deadline passes. Once the GCS calls it RESTARTING, the wait
        is bounded by ``ACTOR_RESTART_WAIT_S`` and then raises
        ActorUnavailableError (unlike the reference, which waits on), so
        that a router re-picks another replica within its client's
        deadline. Runs as a coroutine on the runtime loop so a fleet of
        pending actors parks zero threads."""
        addr = self._actor_addr.get(actor_id)
        if addr is not None:
            return addr
        st = self._actor_state.get(actor_id)
        if st is not None and st.get("state") == "DEAD":
            raise ActorDiedError(f"actor {actor_id.hex()[:12]} is dead: "
                                 f"{st.get('death_cause')}",
                                 actor_id=actor_id.hex())
        t_start = time.time()
        deadline = None if timeout is None else t_start + timeout
        restart_deadline = None
        view = None
        while not self._shutdown:
            # each wait returns at the latest after ACTOR_RESTART_WAIT_S,
            # so that a RESTARTING state is seen within that bound
            step = ACTOR_RESTART_WAIT_S
            if deadline is not None:
                step = min(step, max(0.1, deadline - time.time()))
            if restart_deadline is not None:
                step = min(step, max(0.1, restart_deadline - time.time()))
            r = await self.pool.get(self.gcs_addr).call(
                "wait_actor_alive", actor_id=actor_id, wait_timeout=step,
                timeout=step + 10.0)
            view = r.get("view")
            if view is not None:
                self._actor_state[actor_id] = view
            if r.get("ok"):
                self._actor_addr[actor_id] = tuple(view["address"])
                from ray_tpu_torch.devtools.chaos import note_peer
                note_peer(self._actor_addr[actor_id], "worker")
                return self._actor_addr[actor_id]
            if view is None or view.get("state") == "DEAD":
                break
            if deadline is not None and time.time() >= deadline:
                break
            if view.get("state") == "RESTARTING":
                if restart_deadline is None:
                    restart_deadline = t_start + ACTOR_RESTART_WAIT_S
                if time.time() >= restart_deadline:
                    raise ActorUnavailableError(
                        f"actor {actor_id.hex()[:12]} still restarting "
                        f"after {ACTOR_RESTART_WAIT_S} s",
                        actor_id=actor_id.hex())
        cause = (view or {}).get("death_cause", "not alive in time")
        raise ActorDiedError(f"actor {actor_id.hex()[:12]}: {cause}",
                             actor_id=actor_id.hex())

    def submit_actor_call(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict, *, num_returns: int = 1,
                          max_task_retries: int = 0) -> List[ObjectRef]:
        """ref: CoreWorker::SubmitActorTask core_worker.cc:2156 + ordered
        actor submit queues (transport/actor_submit_queue.h)."""
        task_id = TaskID.of(actor_id)
        spec_args, arg_ids = self._pack_args(args, kwargs)
        self._actor_seq[actor_id] += 1
        spec = TaskSpec(
            task_id=task_id, name=method_name, func_id=b"", args=spec_args,
            num_returns=num_returns, resources=ResourceSet({}),
            owner=self.address, job_id=self.job_id,
            is_actor_call=True, actor_id=actor_id, method_name=method_name,
            seq_no=self._actor_seq[actor_id], max_retries=max_task_retries,
            trace_ctx=self._trace_ctx())
        refs = self._register_returns(spec, arg_ids)
        self._actor_queue(actor_id).append((spec, max_task_retries))
        self._spawn(self._actor_sender(actor_id))
        if spec.is_streaming:
            return ObjectRefGenerator(spec.task_id, self.address)
        return refs

    def _actor_queue(self, actor_id: ActorID) -> deque:
        q = self._actor_queues.get(actor_id)
        if q is None:
            q = self._actor_queues[actor_id] = deque()
        return q

    async def _actor_sender(self, actor_id: ActorID):
        """Single in-flight sender per actor: frames hit the wire in seq order
        (TCP FIFO) and the actor worker executes FIFO, giving the ordered
        semantics of the reference's sequence-numbered actor submit queue
        (transport/actor_submit_queue.h). Replies are handled concurrently
        (pipelining)."""
        if self._actor_sending.get(actor_id):
            return
        self._actor_sending[actor_id] = True
        try:
            q = self._actor_queue(actor_id)
            while q:
                spec, retries = q.popleft()
                try:
                    addr = await self._resolve_actor(actor_id)
                except (ActorDiedError, ActorUnavailableError) as e:
                    e.dispatched = False   # never left the submit queue
                    if isinstance(e, ActorDiedError):
                        # black box: the dead worker itself may never have
                        # dumped (SIGKILL / os._exit) — the caller's ring
                        # is the remaining evidence. Off-loop: file I/O.
                        asyncio.get_running_loop().run_in_executor(
                            None, self.flight.dump,
                            f"actor_died:{actor_id.hex()[:12]}",
                            {"cause": str(e)})
                    self._fail_task_returns(spec, e)
                    continue
                except (ConnectionLost, RemoteError, OSError):
                    # GCS blip (restart/failover): requeue and retry —
                    # gcs reconnect logic lives in gcs_call, which this
                    # loop-native wait path bypasses
                    q.appendleft((spec, retries))
                    await asyncio.sleep(1.0)
                    continue
                client = self.pool.get(tuple(addr))
                try:
                    await client.connect()
                except (ConnectionLost, OSError) as e:
                    # connect failed: the frame provably never left us
                    await self._on_actor_push_failure(spec, retries, addr, e,
                                                      dispatched=False)
                    continue
                try:
                    fut = await client.start_call("push_actor_task", spec=spec)
                except (ConnectionLost, OSError) as e:
                    # the frame was (at least partially) written before the
                    # failure — it MAY have reached the worker, so this is
                    # not provably unsent (drain() raises after write()) —
                    # unless the client found the connection already closed
                    # and wrote nothing (ConnectionLost.dispatched False)
                    await self._on_actor_push_failure(
                        spec, retries, addr, e,
                        dispatched=getattr(e, "dispatched", True))
                    continue
                self.loop.create_task(
                    self._handle_actor_reply(spec, retries, addr, fut))
        finally:
            self._actor_sending[actor_id] = False
            if self._actor_queue(actor_id):
                self._spawn(self._actor_sender(actor_id))

    async def _handle_actor_reply(self, spec: TaskSpec, retries: int,
                                  addr: Address, fut):
        try:
            result: TaskResult = await fut
        except (ConnectionLost, RemoteError, OSError) as e:
            await self._on_actor_push_failure(spec, retries, addr, e)
            return
        # actor path has no lease record: the worker's address is its
        # stable identity for the dashboard's per-worker lanes
        self._complete_task(spec, result, None,
                            worker=f"{addr[0]}:{addr[1]}")

    async def _on_actor_push_failure(self, spec: TaskSpec, retries: int,
                                     addr: Address, err: Exception, *,
                                     dispatched: bool = True):
        """Worker connection broke: the actor may be restarting
        (ref: direct_actor_task_submitter.h DisconnectActor/retry path).

        ``dispatched=False`` ⇒ the push provably never ran: its frame never
        hit the wire, or the worker refused it as a stale address (below).
        The surfaced error carries that so routing layers (serve proxy)
        can safely re-dispatch non-idempotent requests."""
        actor_id = spec.actor_id
        if self._actor_addr.get(actor_id) == tuple(addr):
            self._actor_addr[actor_id] = None
        self.pool.drop(tuple(addr))
        # "no actor hosted here" is a STALE ADDRESS, not an execution
        # error: the actor re-drove onto a different worker (GCS failover
        # mid-creation, or restart). The task provably never ran, so
        # re-resolving and resending is a delivery retry that must not
        # consume max_task_retries (ref: the direct actor submitter
        # resends undelivered tasks on reconnect without counting them).
        stale_addr = (isinstance(err, RemoteError)
                      and "no actor hosted here" in str(err))
        if stale_addr:
            # a lane-host worker outlives its killed actor and refuses the
            # push before running it: surfaced, it is not dispatched either
            dispatched = False
        if isinstance(err, RemoteError) and not stale_addr:
            # Handler raised (not a transport failure): surface to caller.
            self._fail_task_returns(spec, err)
            return
        try:
            view = await self.pool.get(self.gcs_addr).call(
                "get_actor", actor_id=actor_id, timeout=10.0)
        except Exception:
            view = None
        state = (view or {}).get("state")
        if stale_addr and state != "DEAD":
            await asyncio.sleep(0.3)
            self._actor_queue(actor_id).append((spec, retries))
            self._spawn(self._actor_sender(actor_id))
        elif retries != 0 and state != "DEAD":
            await asyncio.sleep(0.3)
            self._actor_queue(actor_id).append(
                (spec, retries - 1 if retries > 0 else -1))
            self._spawn(self._actor_sender(actor_id))
        elif state in ("RESTARTING", "ALIVE", "PENDING_CREATION"):
            self._fail_task_returns(spec, ActorUnavailableError(
                f"actor {actor_id.hex()[:12]} unavailable: {err}",
                dispatched=dispatched))
        else:
            cause = (view or {}).get("death_cause", str(err))
            # driver-side black box: the dead actor's worker may have had
            # no chance to dump (SIGKILL), so the caller's recent task
            # events are the only post-mortem evidence. Off-loop: dump()
            # writes a file.
            loop = asyncio.get_running_loop()
            loop.run_in_executor(None, self.flight.dump,
                                 f"actor_died:{actor_id.hex()[:12]}",
                                 {"cause": str(cause)})
            self._fail_task_returns(spec, ActorDiedError(
                f"actor {actor_id.hex()[:12]} died: {cause}",
                actor_id=actor_id.hex(), dispatched=dispatched))

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.gcs_call("kill_actor", actor_id=actor_id, no_restart=no_restart)

    def cancel(self, ref, force: bool = False, recursive: bool = False):
        """ref: CoreWorker::CancelTask (core_worker.cc) — three cases:
        still QUEUED: drop from the submit queue, fail returns with
        TaskCancelledError. EXECUTING: inject KeyboardInterrupt into the
        worker's executor thread (force=True: tell the worker to exit —
        the interpreter dies, so even C-blocked tasks stop). Already
        FINISHED: no-op. Cancelled tasks are never retried. Actor-call
        refs route the interrupt to the actor's worker process (sync
        methods only — an async method coroutine has no thread to
        interrupt). A task grabbed by a pump but not yet pushed is
        caught at the pre-push _cancel_requested gate."""
        if recursive:
            raise NotImplementedError(
                "recursive cancellation is not implemented; cancel child "
                "task refs individually")
        oid = ref.id
        task_id = oid.task_id()
        pt = self._inflight.get(task_id)
        if pt is None:
            return   # finished (or not a task ref): nothing to cancel
        self._cancel_requested.add(task_id)
        # 1. queued, not yet leased: remove + fail (cheapest path)
        for cls, q in list(self._queues.items()):
            for spec in list(q):
                if spec.task_id == task_id:
                    try:
                        q.remove(spec)
                    except ValueError:
                        break    # a pump grabbed it; fall through to 2.
                    self._cancel_requested.discard(task_id)
                    self._fail_task_returns(spec, TaskCancelledError(
                        f"task {spec.name} cancelled before execution"))
                    self._record_event(spec, "CANCELLED")
                    return
        # 2. executing on a worker. Actor calls aren't in _task_worker —
        # resolve their worker through the actor address table.
        addr = self._task_worker.get(task_id)
        if addr is None and pt.spec is not None and pt.spec.is_actor_call:
            addr = self._actor_addr.get(task_id.actor_id())
        if addr is None:
            # not queued, not yet pushed: the pre-push gate in the pump
            # fires on _cancel_requested; or already completed (the
            # completion path clears the flag)
            return
        if force:
            # kill the worker process; _push_and_handle sees the broken
            # push + _cancel_requested and fails with TaskCancelledError
            try:
                self._run(self.pool.get(tuple(addr)).call(
                    "exit_worker", reason="cancelled (force)", timeout=5.0))
            except Exception:
                pass
        else:
            try:
                self._run(self.pool.get(tuple(addr)).call(
                    "cancel_task", task_id=task_id, timeout=10.0))
            except Exception:
                pass

    # -------------------------------------------- ownership protocol (server)

    async def rpc_wait_object(self, oid: ObjectID, wait_timeout: float = 30.0) -> dict:
        e = self._entry(oid)
        # asyncio waiter, not run_in_executor(event.wait): thousands of
        # concurrent borrower waits would exhaust the executor pool
        ok = await self._await_entry(e, timeout=wait_timeout)
        if not ok:
            return {"status": "pending"}
        if e.state == "error":
            return {"status": "error", "error": e.error}
        if e.state == "lost":
            return {"status": "lost"}
        if e.inline is not None:
            return {"status": "ready", "inline": e.inline}
        if self.device_store.contains(oid):
            # first remote need of a device-tier object: host-stage it
            # (D2H + shm write, off the loop) and answer with locations —
            # the data plane, not this control RPC, carries the bytes
            ok = await asyncio.get_running_loop().run_in_executor(
                None, self._stage_device_object, oid)
            if ok:
                with self._dir_lock:
                    locs = [list(a) for a in e.locations]
                return {"status": "ready", "inline": None,
                        "locations": locs}
        v = self.memory_store.get_if_exists(oid)
        if v is not _MISSING and not isinstance(v, serialization.SerializedException):
            return {"status": "ready", "inline": serialization.pack(v)}
        with self._dir_lock:
            locs = [list(a) for a in e.locations]
        return {"status": "ready", "inline": None, "locations": locs}

    # ------------------------------------------- streaming generators (owner)

    def stream_progress(self, task_id: TaskID) -> Tuple[int, Optional[int]]:
        st = self._streams.get(task_id)
        if st is None:
            return (0, None)
        return (st.produced, st.total)

    def next_stream_ref(self, task_id: TaskID, index: int,
                        timeout: Optional[float] = None) -> Optional[ObjectRef]:
        """Block until item `index` of the stream is ready; None on clean
        end-of-stream; raises the task's error once all yielded items were
        consumed (ref: generator semantics in task_manager.h:143-171)."""
        st = self._streams.get(task_id)
        if st is None:
            raise ValueError(f"no stream for task {task_id.hex()[:12]}")
        rid = ObjectID.for_return(task_id, index)
        e = self._entry(rid)
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if e.event.is_set() and e.state in ("ready", "error"):
                self._advance_consumed(st, index)
                return ObjectRef(rid, self.address)
            if st.total is not None and index > st.total:
                if st.error is not None:
                    raise st.error.to_exception()
                return None
            if deadline is not None and time.time() >= deadline:
                raise GetTimeoutError(
                    f"stream item {index} of {task_id.hex()[:12]} not ready "
                    "in time")
            st.kick.clear()
            # re-check after clear: an update between the checks above and
            # the clear would otherwise be a lost wakeup (conditions must
            # mirror the loop's exits exactly or this spins)
            if (e.event.is_set() and e.state in ("ready", "error")) \
                    or (st.total is not None and index > st.total):
                continue
            st.kick.wait(1.0)

    def _advance_consumed(self, st: _StreamState, index: int):
        """Consumer progress: release backpressured item acks whose
        release condition now holds. Called from consumer threads; waiter
        futures complete on the loop. The check-then-append in
        rpc_stream_item and the advance-then-filter here must each be
        atomic or a waiter registered between them is never fired."""
        with self._stream_lock:
            if index <= st.consumed:
                return
            # byte sweep stops at produced: no sizes exist past it, and
            # drop_stream advances with a +1e9 sentinel that must not
            # become a billion-iteration loop on the event-loop thread
            for i in range(st.consumed + 1, min(index, st.produced) + 1):
                st.ahead_bytes -= st.item_bytes.pop(i, 0)
            if index > st.produced:
                st.item_bytes.clear()
                st.ahead_bytes = 0
            st.consumed = index
            fire = [f for cond, f in st.consumed_waiters if cond()]
            st.consumed_waiters = [(c, f) for c, f in st.consumed_waiters
                                   if not c()]
        for f in fire:
            try:
                self.loop.call_soon_threadsafe(
                    lambda f=f: f.done() or f.set_result(None))
            except RuntimeError:
                pass

    def drop_ref_soon(self, oid: ObjectID, owner: RuntimeAddress):
        """GC-safe ObjectRef release (``ObjectRef.__del__`` during a cyclic
        collection): the decrement, and the free it may lead to, run on the
        loop thread, outside every critical section of the collecting
        thread."""
        try:
            self.loop.call_soon_threadsafe(self.refs.on_ref_deleted, oid,
                                           owner)
        except RuntimeError:
            pass   # loop already closed

    def drop_stream_soon(self, task_id: TaskID):
        """GC-safe drop: ObjectRefGenerator.__del__ can fire during ANY
        allocation — including inside a _stream_lock critical section on
        this very thread — so the finalizer must never take the lock
        itself. Defer to the loop thread."""
        try:
            self.loop.call_soon_threadsafe(self.drop_stream, task_id)
        except RuntimeError:
            pass   # loop already closed

    def drop_stream(self, task_id: TaskID):
        """Consumer discarded the generator: release any blocked executor
        (its next item report returns ok=False, stopping production),
        drop the state, and free produced-but-never-claimed items — no
        ObjectRef exists for those, so no decrement event would ever free
        them. Claimed items' entries persist under their refs' lifecycle;
        lineage reconstruction revives a fresh state via
        _reset_and_resubmit."""
        st = self._streams.pop(task_id, None)
        if st is None:
            return
        lo, hi = st.consumed, st.produced
        self._advance_consumed(st, st.produced + 10**9)
        st.kick.set()
        for i in range(lo + 1, hi + 1):
            self.refs.release_owned_if_unreferenced(
                ObjectID.for_return(task_id, i))

    async def rpc_stream_item(self, task_id: TaskID, index: int, kind: str,
                              payload: Any,
                              backpressure: Optional[int] = None,
                              backpressure_bytes: Optional[int] = None
                              ) -> dict:
        """Executor reports one yielded item (ref: ReportGeneratorItemReturns).
        Idempotent: a retried generator re-reports earlier indices onto
        already-complete entries, which are left untouched. With
        backpressure=N (items) and/or backpressure_bytes=B the ack is
        withheld until the consumer is within the bound — the executor's
        blocking report call IS the flow control
        (ref: _generator_backpressure_num_objects + the streaming
        executor's admission by object-store memory)."""
        st = self._streams.get(task_id)
        if st is None:
            return {"ok": False, "reason": "unknown-stream"}
        rid = ObjectID.for_return(task_id, index)
        e = self._entry(rid)
        if not e.event.is_set():
            self.refs.register_owned(rid)
            pt = self._inflight.get(task_id)
            e.spec = pt.spec if pt is not None else e.spec   # lineage
            if kind == "inline":
                e.inline = payload
                try:
                    self.memory_store.put(rid, serialization.unpack(payload))
                except Exception:
                    pass
            else:
                e.locations.add(tuple(payload["addr"]))
                e.primaries.add(tuple(payload["addr"]))
                e.size = payload.get("size", 0)
            e.state = "ready"
            self._complete_entry(e)
        size = (len(payload) if kind == "inline"
                else int(payload.get("size", 0)))
        st.produced = max(st.produced, index)
        st.kick.set()
        fut = None
        if (backpressure is not None or backpressure_bytes is not None) \
                and not st.abandoned:
            with self._stream_lock:
                # membership re-check: a concurrent drop_stream fires
                # existing waiters and pops the state — appending to an
                # orphaned state would wait forever
                if self._streams.get(task_id) is not st:
                    return {"ok": False, "reason": "dropped"}
                if index > st.consumed and index not in st.item_bytes:
                    st.item_bytes[index] = size
                    st.ahead_bytes += size

                def released(st=st, index=index):
                    if backpressure is not None \
                            and index - st.consumed > backpressure:
                        return False
                    if backpressure_bytes is not None \
                            and st.ahead_bytes > backpressure_bytes \
                            and index - st.consumed > 1:
                        # bytes over budget: wait — unless THIS item is
                        # the only unconsumed one (a single over-budget
                        # block must not deadlock the stream)
                        return False
                    return True

                if not released():
                    fut = self.loop.create_future()
                    st.consumed_waiters.append((released, fut))
        if fut is not None:
            await fut
            if self._streams.get(task_id) is not st:
                return {"ok": False, "reason": "dropped"}
        return {"ok": True}

    async def rpc_stream_done(self, task_id: TaskID, total: int,
                              error: Any = None) -> dict:
        st = self._streams.get(task_id)
        if st is None:
            return {"ok": False, "reason": "unknown-stream"}
        if st.total is None:   # first finalization wins (retries re-report)
            st.total = total
            st.error = error
        st.kick.set()
        return {"ok": True}

    def _finalize_stream_on_result(self, spec: TaskSpec, error=None):
        """Owner-side safety net: freeze the stream when the task result
        arrives, in case the executor died between its last item and the
        stream_done call."""
        st = self._streams.get(spec.task_id)
        if st is None:
            return
        if st.total is None:
            st.total = st.produced
            st.error = error
        st.kick.set()

    async def rpc_wait_objects(self, oids: List[ObjectID],
                               wait_timeout: float = 30.0) -> dict:
        """Bulk wait_object: one round-trip resolves many borrowed refs
        (ref: batched GetObjects on the store providers)."""
        results = await asyncio.gather(
            *(self.rpc_wait_object(oid, wait_timeout) for oid in oids))
        return {"results": list(results)}

    async def rpc_recover_object(self, oid: ObjectID,
                                 dead_locations=None) -> dict:
        """A borrower failed to fetch from every advertised location:
        prune locations whose NODES are confirmed dead (the borrower's
        claim alone may be a transient network error — pruning a live
        holder would leak its pinned primary and re-execute needlessly),
        then re-execute lineage if no copy remains (the borrower-
        initiated half of ObjectRecoveryManager)."""
        e = self._entry(oid)
        reported = {tuple(a) for a in (dead_locations or [])}
        if reported:
            try:
                nodes = await self.pool.get(self.gcs_addr).call(
                    "get_nodes", timeout=10.0)
                alive_addrs = {tuple(n.nodelet_addr) for n in nodes
                               if n.alive}
            except Exception:
                alive_addrs = None  # GCS unreachable: don't prune
            if alive_addrs is not None:
                with self._dir_lock:
                    for a in reported:
                        if a not in alive_addrs:
                            e.locations.discard(a)
                            e.primaries.discard(a)
        if e._locations or e.inline is not None \
                or self.memory_store.get_if_exists(oid) is not _MISSING:
            return {"status": "has_copies"}
        if e.spec is None:
            e.state = "lost"
            self._complete_entry(e)
            return {"status": "unrecoverable"}
        if e.state != "pending":
            logger.warning("reconstructing %s via lineage "
                           "(borrower-reported loss)", oid.hex()[:12])
            self._reset_and_resubmit(e.spec)
        return {"status": "reconstructing"}

    async def rpc_add_location(self, oid: ObjectID, addr: Address) -> dict:
        """A puller registered a secondary copy (emergent broadcast
        tree); only meaningful while the object is live and ready."""
        self._add_location_locked(oid, tuple(addr))
        return {"ok": True}

    async def rpc_drop_location(self, oid: ObjectID, addr: Address) -> dict:
        """A puller found a registered secondary copy missing (LRU
        eviction); primaries are pinned and never pruned this way."""
        self._drop_location_locked(oid, tuple(addr))
        return {"ok": True}

    async def rpc_locate(self, oid: ObjectID) -> dict:
        with self._dir_lock:
            e = self.directory.get(oid)
            if e is None:
                return {"status": "unknown"}
            # snapshot under the lock: puller registrations mutate the set
            # concurrently from executor threads
            return {"status": e.state,
                    "locations": [list(a) for a in e.locations]}

    async def rpc_add_borrow(self, oid: ObjectID, borrower_id: bytes) -> dict:
        self.refs.add_borrower(oid, borrower_id)
        return {"ok": True}

    async def rpc_remove_borrow(self, oid: ObjectID, borrower_id: bytes) -> dict:
        self.refs.remove_borrower(oid, borrower_id)
        return {"ok": True}

    async def rpc_ping(self) -> dict:
        return {"ok": True, "worker_id": self.worker_id}

    # -------------------------------------------------------------- telemetry

    def _record_event(self, spec: TaskSpec, state: str,
                      worker: Optional[str] = None):
        """ref: task_event_buffer.h:199 — buffered in the TelemetryAgent,
        shipped in batched reports (bounded, drops counted)."""
        self.telemetry.record_event({
            "task_id": spec.task_id.hex(), "name": spec.name,
            "state": state, "job_id": self.job_id, "ts": time.time(),
            "actor_id": spec.actor_id.hex() if spec.actor_id else None,
            # the EXECUTING worker (None on owner-side PENDING events)
            # — the dashboard's per-worker timeline lanes
            "worker": worker})

    def record_span(self, span: dict):
        """Tracing spans ride the task-event channel to the GCS — one
        store serves task states and spans (ref: profile events share the
        TaskEventBuffer, task_event_buffer.h). Stamped with the recording
        worker so the timeline lanes spans next to the tasks that
        emitted them."""
        span.setdefault("worker", self.worker_id.hex()[:12]
                        if self.mode == "worker" else None)
        self.telemetry.record_event(span)

    def _record_pull_edge(self, src_addr, nbytes, seconds):
        """Remote object-pull observation -> per-edge EWMA model."""
        try:
            src = self.telemetry.node_of_addr(tuple(src_addr))
            if src and self.node_id:
                self.telemetry.record_edge(src, self.node_id, nbytes,
                                           seconds, kind="object_pull")
        except Exception:
            pass

    def flush_task_events(self, wait: bool = False):
        """Ship buffered telemetry; `wait=True` blocks until the GCS
        acked (readers like `ray_tpu_torch.timeline()` need read-your-writes)
        and must come from an executor/user thread. `wait=False` is safe
        from the event-loop thread — buffered items ship within one
        report interval."""
        self.telemetry.flush(wait=wait)

    # ------------------------------------------------------------------ misc

    def as_future(self, ref: ObjectRef) -> SyncFuture:
        fut: SyncFuture = SyncFuture()

        def _bg():
            try:
                fut.set_result(self._get_one(ref, None))
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=_bg, daemon=True).start()
        return fut


def os_urandom4() -> bytes:
    import os as _os

    return _os.urandom(4)


def _module_is_installed(mod) -> bool:
    """True if workers can `import mod` (stdlib / site-packages / ray_tpu_torch)."""
    import sys

    import os

    f = getattr(mod, "__file__", None)
    if f is None:
        return True  # builtin/frozen
    top = mod.__name__.split(".")[0]
    if top in ("ray_tpu_torch", "__main__"):
        return top == "ray_tpu_torch"
    f = os.path.abspath(f)
    roots = [getattr(sys, "prefix", ""), getattr(sys, "base_prefix", "")]
    import site

    try:
        roots.extend(site.getsitepackages())
    except Exception:
        pass
    return any(r and f.startswith(r) for r in roots)


def _dumps_function(fn) -> bytes:
    """Pickle by reference for installed modules, by value otherwise — so
    functions defined in user scripts/tests ship to workers that cannot
    import their defining module (the reference gets this via
    cloudpickle-by-value of driver code, function_manager.py)."""
    import inspect

    mod = inspect.getmodule(fn)
    if mod is not None and mod.__name__ != "__main__" \
            and not _module_is_installed(mod):
        try:
            cloudpickle.register_pickle_by_value(mod)
            try:
                return cloudpickle.dumps(fn)
            finally:
                cloudpickle.unregister_pickle_by_value(mod)
        except Exception:
            pass
    return cloudpickle.dumps(fn)
