"""Worker process: executes tasks and hosts actors.

Reference: the execution half of src/ray/core_worker/ — scheduling queues
(transport/normal_scheduling_queue.h, actor_scheduling_queue.h), concurrency
groups/fibers for async actors (fiber.h), and the Python task execution
handler in _raylet.pyx. One process == one Worker; the asyncio loop runs in
the main thread (RPC serving + async actor methods), synchronous task/actor
code runs on executor threads (1 thread => FIFO ordered actor semantics;
max_concurrency > 1 => threaded actor).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import sys
import threading
import traceback
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.channels import ChannelHost
from ray_tpu_torch.core.common import ObjectRef, RuntimeAddress, TaskResult, TaskSpec
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch.core.runtime import Runtime, set_runtime
from ray_tpu_torch.core.serialization import SerializedException

logger = logging.getLogger("ray_tpu_torch.worker")


class _SerialLaneExecutor:
    """FIFO serial execution multiplexed onto a SHARED thread pool:
    per-lane actor ordering without a dedicated OS thread per lane (256
    lanes/process would otherwise pin 256 permanently idle threads once
    each actor has run a method). At most one submission per lane runs
    at a time; drains chain through the shared pool."""

    def __init__(self, pool: ThreadPoolExecutor):
        self._pool = pool
        self._q: deque = deque()
        self._running = False
        self._lock = threading.Lock()

    def submit(self, fn, *args, **kw) -> Future:
        fut: Future = Future()
        with self._lock:
            self._q.append((fut, fn, args, kw))
            if not self._running:
                self._running = True
                self._pool.submit(self._drain)
        return fut

    def _drain(self):
        while True:
            with self._lock:
                if not self._q:
                    self._running = False
                    return
                fut, fn, args, kw = self._q.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kw))
            except BaseException as e:
                fut.set_exception(e)

    def shutdown(self, wait: bool = False, cancel_futures: bool = False):
        if cancel_futures:
            with self._lock:
                q, self._q = list(self._q), deque()
            for fut, *_ in q:
                fut.cancel()


class _ActorLane:
    """One hosted actor: instance + its own serial executor lane, so N
    fractional-CPU actors can share a worker process while each keeps the
    FIFO ordering (or max_concurrency pool) of a dedicated worker (ref:
    worker_pool.h one-process-per-actor; the lane design trades process
    isolation for spawn-free density on num_cpus<1 actors)."""

    def __init__(self, spec: TaskSpec, shared_pool: ThreadPoolExecutor):
        self.spec = spec
        self.instance: Any = None
        if spec.max_concurrency > 1:
            self.executor: Any = ThreadPoolExecutor(
                max_workers=spec.max_concurrency,
                thread_name_prefix=f"actor-{spec.actor_id.hex()[:8]}")
        else:
            self.executor = _SerialLaneExecutor(shared_pool)
        self.async_sem = asyncio.Semaphore(max(1, spec.max_concurrency))
        self.executing: set = set()       # task ids currently in _execute


class Worker:
    """RPC handler for the worker process; delegates ownership-protocol
    methods to the embedded Runtime (every worker is also an owner)."""

    def __init__(self, runtime: Runtime):
        self.runtime = runtime
        self.task_executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="task-exec")
        # hosted actors by id — a dedicated actor worker is simply a
        # one-lane host. Serial lanes share this pool; its cap matches
        # lanes-per-worker so every lane can hold a thread even when all
        # of them block in ray_tpu_torch.get() simultaneously (a smaller cap
        # could deadlock lanes that produce each other's results).
        # Threads spawn on demand, so the resident count tracks the
        # high-water mark of CONCURRENT lane work, not the lane count.
        self.lanes: dict = {}
        self._lane_pool = ThreadPoolExecutor(
            max_workers=max(32, runtime.cfg.actor_lanes_per_worker),
            thread_name_prefix="lane-exec")
        # ids destroyed mid-creation: a create whose ctor outlives the
        # destroy must not install a zombie lane
        self._destroyed: set = set()
        # cancellation (ref: core worker CancelTask -> KeyboardInterrupt
        # in the executing thread): task_id -> executing thread ident,
        # plus the set of ids whose interrupt means CANCELLED, not ctrl-C
        self._exec_threads: dict = {}
        self._cancelled: set = set()
        self._cancel_lock = threading.Lock()
        # standing channels of compiled DAGs whose nodes live on this
        # worker's lanes (dag.compiled); negotiated once at channel_open
        self.channels = ChannelHost(self)

    async def rpc_channel_open(self, spec) -> dict:
        return await self.channels.rpc_channel_open(spec)

    def rpc_channel_push(self, channel_id, seq, slot, kind,
                         payload) -> dict:
        return self.channels.push(channel_id, seq, slot, kind, payload)

    rpc_channel_push._rpc_inline = True   # sync + non-blocking: ONEWAY
    # frames dispatch inline in the server reader loop (rpc.py)

    async def rpc_channel_close(self, channel_id) -> dict:
        return await self.channels.rpc_channel_close(channel_id)

    def __getattr__(self, name):
        # Delegate rpc_wait_object / rpc_locate / rpc_add_borrow / ... to the
        # runtime so one server serves both protocols.
        return getattr(self.runtime, name)

    # ---------------------------------------------------------------- execute

    def _resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        args: List[Any] = []
        kwargs: dict = {}
        ref_args: List[Tuple[int, ObjectRef]] = []
        with serialization.IMPORT_LOCK:   # their imports, one at a time
            for kind, payload in spec.args:
                if kind == "v":
                    args.append(serialization.unpack(payload))
                elif kind == "ref":
                    oid, owner = payload
                    args.append(ObjectRef(oid, owner))
                elif kind == "kw":
                    for k, (kk, pv) in payload.items():
                        if kk == "v":
                            kwargs[k] = serialization.unpack(pv)
                        else:
                            oid, owner = pv
                            kwargs[k] = ObjectRef(oid, owner)
        # Dependency resolution: refs are fetched before user code runs,
        # in ONE batched get so borrowed args share round-trips (ref:
        # _raylet.pyx deserializes args via plasma before execution).
        refs = [a for a in args if isinstance(a, ObjectRef)]
        refs += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
        if refs:
            vals = iter(self.runtime.get(refs))
            args = [next(vals) if isinstance(a, ObjectRef) else a
                    for a in args]
            kwargs = {k: (next(vals) if isinstance(v, ObjectRef) else v)
                      for k, v in kwargs.items()}
        return args, kwargs

    def _package_returns(self, spec: TaskSpec, values: Any) -> TaskResult:
        n = spec.num_returns
        if n == 0:
            return TaskResult(spec.task_id, [])
        if n == 1:
            values = (values,)
        elif not isinstance(values, tuple) or len(values) != n:
            raise ValueError(
                f"task {spec.name} declared num_returns={n} but returned "
                f"{type(values).__name__}")
        returns = []
        for i, v in enumerate(values):
            returns.append(self._package_one(spec.return_ids()[i], v))
        return TaskResult(spec.task_id, returns)

    def _package_one(self, rid, v) -> Tuple[str, Any]:
        """Serialize one return/stream item: inline when small, into the
        node store (nodelet-pinned) when large."""
        meta, bufs = serialization.serialize(v)
        size = serialization.serialized_size(meta, bufs)
        if size <= self.runtime.cfg.max_direct_call_object_size:
            packed = bytearray(size)
            serialization.write_to(memoryview(packed), meta, bufs)
            return ("inline", bytes(packed))
        store = self.runtime.store
        view = self.runtime._create_view_with_spill(rid, size)
        if view is not None:
            serialization.write_to(view, meta, bufs)
            del view
            store.seal(rid)
            self.runtime._attribute_put(rid, size)
            self.runtime._pin_primary(rid)  # nodelet owns the pin
        elif not store.contains(rid):
            raise MemoryError(
                f"object store full storing {rid.hex()[:12]}")
        return ("store", {"addr": self.runtime.nodelet_addr, "size": size})

    def _stream_item_coro(self, spec: TaskSpec, idx: int, kind, payload):
        """The one report-item RPC both streaming drivers share. With
        backpressure the owner deliberately withholds the ack until the
        consumer catches up — that call gets a generous deadline."""
        owner = self.runtime.pool.get(spec.owner.addr)
        bp = spec.generator_backpressure
        bpb = spec.generator_backpressure_bytes
        return owner.call(
            "stream_item", task_id=spec.task_id, index=idx, kind=kind,
            payload=payload, backpressure=bp, backpressure_bytes=bpb,
            timeout=3600.0 if (bp is not None or bpb is not None) else 30.0)

    def _stream_done_coro(self, spec: TaskSpec, total: int):
        return self.runtime.pool.get(spec.owner.addr).call(
            "stream_done", task_id=spec.task_id, total=total, timeout=30.0)

    def _stream_returns(self, spec: TaskSpec, gen) -> TaskResult:
        """Drive a generator task: report each yielded item to the owner
        as it is produced (ref: task_manager.h:143-171 streaming returns /
        ReportGeneratorItemReturns). Runs on an executor thread; RPCs
        bridge onto the runtime loop."""
        if not hasattr(gen, "__iter__") or isinstance(gen, (str, bytes,
                                                            list, tuple,
                                                            dict)):
            raise TypeError(
                f"task {spec.name} declared num_returns='streaming' but "
                f"returned {type(gen).__name__}, not a generator/iterator")
        idx = 0
        for item in gen:
            idx += 1
            kind, payload = self._package_one(
                ObjectID.for_return(spec.task_id, idx), item)
            r = self.runtime._run(self._stream_item_coro(spec, idx, kind,
                                                         payload))
            if not r.get("ok"):
                # owner dropped the stream (scope exit / shutdown): stop
                # producing and let generator cleanup run
                if hasattr(gen, "close"):
                    gen.close()
                break
        self.runtime._run(self._stream_done_coro(spec, idx))
        return TaskResult(spec.task_id, [])

    def _execute(self, spec: TaskSpec, fn=None) -> TaskResult:
        """Runs on an executor thread — NEVER on the asyncio loop: it blocks
        on GCS KV fetches and dependency gets, which are loop-driven."""
        from ray_tpu_torch.runtime_env import TaskEnvContext

        # Actor methods inherit the actor's creation env (ref: actor-level
        # runtime_env applies to all its tasks).
        lane = (self.lanes.get(spec.actor_id)
                if spec.is_actor_call else None)
        env = spec.runtime_env or (lane.spec.runtime_env if lane else None)
        self.runtime.set_exec_context(
            spec.task_id, runtime_env=env,
            actor_id=spec.actor_id if spec.is_actor_call else None)
        with self._cancel_lock:
            self._exec_threads[spec.task_id] = threading.get_ident()
            if lane is not None:
                lane.executing.add(spec.task_id)
        try:
            from ray_tpu_torch.util.tracing import continue_trace

            span_name = (f"actor::{spec.method_name}" if spec.is_actor_call
                         else f"task::{spec.name}")
            with TaskEnvContext(self.runtime, spec.runtime_env), \
                    continue_trace(spec.trace_ctx, span_name,
                                   {"task_id": spec.task_id.hex()}):
                if fn is None:
                    fn = self.runtime.load_function(spec.func_id)
                args, kwargs = self._resolve_args(spec)
                value = fn(*args, **kwargs)
                if spec.is_streaming:
                    # stream inside the env/trace context: the generator
                    # body runs lazily, during iteration
                    return self._stream_returns(spec, value)
            return self._package_returns(spec, value)
        except BaseException as e:
            tb = traceback.format_exc()
            with self._cancel_lock:
                was_cancelled = spec.task_id in self._cancelled
            if was_cancelled and isinstance(e, KeyboardInterrupt):
                # the interrupt was OUR injected cancellation, not ctrl-C
                from ray_tpu_torch.core.status import TaskCancelledError

                ser = SerializedException(
                    TaskCancelledError(
                        f"task {spec.name} cancelled while running"),
                    tb, wrap=False)
            else:
                ser = SerializedException(e, tb)
            return TaskResult(spec.task_id,
                              [("err", ser)] * max(1, spec.num_returns))
        finally:
            with self._cancel_lock:
                self._exec_threads.pop(spec.task_id, None)
                self._cancelled.discard(spec.task_id)
                if lane is not None:
                    lane.executing.discard(spec.task_id)
            self.runtime.clear_exec_context()

    # ------------------------------------------------------------ rpc surface

    async def rpc_push_task(self, spec: TaskSpec) -> TaskResult:
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(self.task_executor,
                                            self._execute, spec)
        # worker-side task events are tracing spans — ship them promptly
        # so `ray_tpu_torch.timeline()` sees fresh traces
        self.runtime.flush_task_events()
        return result

    async def rpc_create_actor(self, spec: TaskSpec) -> dict:
        self._destroyed.discard(spec.actor_id)   # fresh incarnation
        lane = _ActorLane(spec, self._lane_pool)

        def _ctor():
            from ray_tpu_torch.runtime_env import TaskEnvContext
            from ray_tpu_torch.util.tracing import continue_trace

            self.runtime.set_exec_context(spec.task_id,
                                          runtime_env=spec.runtime_env,
                                          actor_id=spec.actor_id)
            try:
                # The actor owns its lane: its runtime env persists for
                # the actor's lifetime (entered, never exited — ref: actors
                # run in env-dedicated workers; lane hosts are pooled by
                # the same process-env key, so lanes never need
                # conflicting process envs).
                TaskEnvContext(self.runtime, spec.runtime_env).__enter__()
                cls = self.runtime.load_function(spec.func_id)
                args, kwargs = self._resolve_args(spec)
                with continue_trace(spec.trace_ctx,
                                    f"actor::{spec.name}.__init__",
                                    {"actor_id": spec.actor_id.hex()}):
                    lane.instance = cls(*args, **kwargs)
                self.runtime.flush_task_events()
                return {"ok": True}
            except BaseException:
                return {"ok": False, "error": traceback.format_exc()}
            finally:
                self.runtime.clear_exec_context()

        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(lane.executor, _ctor)
        if spec.actor_id in self._destroyed:
            # destroyed while the ctor ran (creation-timeout path): do
            # not install a zombie lane the control plane stopped tracking
            self._destroyed.discard(spec.actor_id)
            lane.executor.shutdown(wait=False)
            lane.instance = None
            return {"ok": False, "error": "actor destroyed during creation"}
        if res.get("ok"):
            self.lanes[spec.actor_id] = lane
        else:
            lane.executor.shutdown(wait=False)
        return res

    async def rpc_destroy_actor(self, actor_id) -> dict:
        """Tear down ONE lane without touching the process (the lane twin
        of kill_worker): interrupt its executing sync methods, cancel its
        queue, drop the instance. Other lanes are unaffected. Async
        methods already past their semaphore run to completion (kill
        races execution the same way on a dedicated worker); sem-queued
        ones fail the post-acquire liveness check."""
        import ctypes

        lane = self.lanes.pop(actor_id, None)
        if lane is None:
            # creation may still be in flight: tombstone it
            self._destroyed.add(actor_id)
            return {"ok": False, "error": "no such lane"}
        with self._cancel_lock:
            for tid in list(lane.executing):
                ident = self._exec_threads.get(tid)
                if ident is not None:
                    self._cancelled.add(tid)
                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(ident),
                        ctypes.py_object(KeyboardInterrupt))
        lane.executor.shutdown(wait=False, cancel_futures=True)
        lane.instance = None
        # lane death is NOT process death: per-actor module state (e.g.
        # util/collective's group clients) must be released explicitly
        from ray_tpu_torch.core.runtime import actor_teardown_hooks
        for hook in list(actor_teardown_hooks):
            try:
                hook(actor_id.hex())
            except Exception:
                logger.exception("actor teardown hook failed")
        return {"ok": True}

    async def rpc_push_actor_task(self, spec: TaskSpec) -> TaskResult:
        lane = self.lanes.get(spec.actor_id)
        if lane is None or lane.instance is None:
            raise RuntimeError("no actor hosted here")
        method = getattr(lane.instance, spec.method_name, None)
        if method is None:
            def method(*a, **k):
                raise AttributeError(
                    f"actor has no method {spec.method_name!r}")
        if inspect.isasyncgenfunction(method) and spec.is_streaming:
            # async-generator streaming method (the Serve token-streaming
            # path): items are produced and reported on the loop;
            # serialization hops to an executor thread because packaging
            # large items blocks on the nodelet pin RPC.
            async with lane.async_sem:
                if self.lanes.get(spec.actor_id) is not lane or \
                        lane.instance is None:
                    raise RuntimeError("no actor hosted here")
                loop = asyncio.get_running_loop()
                try:
                    args, kwargs = await loop.run_in_executor(
                        lane.executor, self._resolve_args, spec)
                    self.runtime.set_exec_context(spec.task_id,
                                                  actor_id=spec.actor_id)
                    agen = method(*args, **kwargs)
                    idx = 0
                    async for item in agen:
                        idx += 1
                        kind, payload = await loop.run_in_executor(
                            None, self._package_one,
                            ObjectID.for_return(spec.task_id, idx), item)
                        r = await self._stream_item_coro(spec, idx, kind,
                                                         payload)
                        if not r.get("ok"):
                            await agen.aclose()
                            break
                    await self._stream_done_coro(spec, idx)
                    return TaskResult(spec.task_id, [])
                except BaseException as e:
                    ser = SerializedException(e, traceback.format_exc())
                    return TaskResult(spec.task_id, [("err", ser)])
                finally:
                    self.runtime.clear_exec_context()
        if inspect.iscoroutinefunction(method):
            # async actor: method coroutine runs on the loop (ref: fibers,
            # fiber.h); arg resolution still happens off-loop because it may
            # block on remote gets.
            async with lane.async_sem:
                if self.lanes.get(spec.actor_id) is not lane or \
                        lane.instance is None:
                    raise RuntimeError("no actor hosted here")
                loop = asyncio.get_running_loop()
                try:
                    args, kwargs = await loop.run_in_executor(
                        lane.executor, self._resolve_args, spec)
                    self.runtime.set_exec_context(spec.task_id,
                                                  actor_id=spec.actor_id)
                    value = await method(*args, **kwargs)
                    return self._package_returns(spec, value)
                except BaseException as e:
                    ser = SerializedException(e, traceback.format_exc())
                    return TaskResult(spec.task_id,
                                      [("err", ser)] * max(1, spec.num_returns))
                finally:
                    self.runtime.clear_exec_context()
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(lane.executor, self._execute,
                                            spec, method)
        self.runtime.flush_task_events()
        return result

    async def rpc_cancel_task(self, task_id: TaskID) -> dict:
        """Cancel an executing task by injecting KeyboardInterrupt into
        its executor thread (ref: core worker CancelTask -> SIGINT in the
        worker). The interrupt lands at the next bytecode boundary; a
        task blocked in C (e.g. a long XLA compile) is interrupted when
        it returns to Python — same limitation as the reference."""
        import ctypes

        with self._cancel_lock:
            # inject UNDER the lock: _execute's finally pops the entry
            # under this same lock, so a present entry proves the thread
            # is still inside _execute for THIS task — the interrupt can
            # never land in a pool thread that moved on to other work
            # (or sits idle in queue.get, where a stray KI would kill
            # the executor's only thread permanently)
            ident = self._exec_threads.get(task_id)
            if ident is None:
                return {"status": "not_running"}
            self._cancelled.add(task_id)
            n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(KeyboardInterrupt))
            if n != 1:   # thread gone (cannot happen while entry present)
                self._cancelled.discard(task_id)
                return {"status": "not_running"}
        return {"status": "cancelling"}

    async def rpc_dump_stacks(self) -> dict:
        """All-thread stack dump (ref: `ray stack` scripts.py:1789 —
        py-spy over workers; here the worker self-reports, no ptrace)."""
        import threading

        names = {t.ident: t.name for t in threading.enumerate()}
        parts = []
        for tid, frame in sys._current_frames().items():
            parts.append(f"--- thread {names.get(tid, '?')} ({tid}) ---\n"
                         + "".join(traceback.format_stack(frame)))
        return {"pid": os.getpid(), "stacks": "\n".join(parts)}

    async def rpc_exit_worker(self, reason: str = "") -> dict:
        logger.info("worker exiting: %s", reason)
        asyncio.get_running_loop().call_later(0.05, lambda: os._exit(0))
        return {"ok": True}


def _install_flight_hooks(runtime) -> None:
    """Uncaught exceptions (main thread, lane threads, daemon helpers)
    write the flight recorder on the way down — the last thing a dying
    worker does is label its own black box. Task-raised exceptions are
    NOT uncaught (they travel as typed error results) and don't trip
    this."""
    import sys
    import threading as _threading

    prev_sys = sys.excepthook
    prev_thread = _threading.excepthook

    def _dump(where: str, exc_type, exc) -> None:
        try:
            runtime.flight.dump(
                f"uncaught:{exc_type.__name__}",
                extra={"where": where, "error": repr(exc)}, force=True)
        except Exception:
            pass

    def _sys_hook(exc_type, exc, tb):
        _dump("main", exc_type, exc)
        prev_sys(exc_type, exc, tb)

    def _thread_hook(hook_args):
        if not issubclass(hook_args.exc_type, SystemExit):
            _dump(hook_args.thread.name if hook_args.thread else "thread",
                  hook_args.exc_type, hook_args.exc_value)
        prev_thread(hook_args)

    sys.excepthook = _sys_hook
    _threading.excepthook = _thread_hook


async def worker_main(args):
    cfg = Config.from_json(args.config)
    gh, gp = args.gcs.rsplit(":", 1)
    nh, np_ = args.nodelet.rsplit(":", 1)
    loop = asyncio.get_running_loop()
    runtime = Runtime(cfg, (gh, int(gp)), (nh, int(np_)), args.store,
                      JobID.nil(), mode="worker", loop=loop,
                      worker_id=bytes.fromhex(args.worker_id),
                      node_id=args.node_id)
    set_runtime(runtime)
    _install_flight_hooks(runtime)
    worker = Worker(runtime)
    runtime.server.handler = worker
    host, port = await runtime.server.start()
    runtime.address = RuntimeAddress(host, port, runtime.worker_id)
    r = await runtime.pool.get(runtime.nodelet_addr).call(
        "register_worker", worker_id=runtime.worker_id, addr=(host, port),
        timeout=cfg.rpc_connect_timeout_s)
    if not r.get("ok"):
        logger.error("nodelet rejected registration; exiting")
        return
    logger.info("worker %s serving on %s:%d", args.worker_id[:8], host, port)
    # Exit if the nodelet disappears (parent supervision).
    nodelet = runtime.pool.get(runtime.nodelet_addr)
    while True:
        await asyncio.sleep(5.0)
        try:
            await nodelet.call("ping", timeout=5.0)
        except Exception:
            logger.warning("nodelet unreachable; worker exiting")
            return


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--nodelet", required=True)
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--config", default="{}")
    args = parser.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {args.worker_id[:8]}] %(asctime)s %(levelname)s %(message)s")
    asyncio.run(worker_main(args))


if __name__ == "__main__":
    main()
