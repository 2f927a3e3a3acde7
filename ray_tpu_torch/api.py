"""The public runtime API of ray_tpu_torch: tasks, actors and objects.

Port of the body of ray_tpu/__init__.py (reference: python/ray/_private/
worker.py — init:1108, get:2410, put:2519, wait:2582, kill:2748,
cancel:2779, remote:2925). The package root re-exports every name here
lazily (``ray_tpu_torch/__init__.py``), so ``import ray_tpu_torch``
starts nothing and loads neither torch nor the runtime; the first use of
one of these names imports this module:

    import ray_tpu_torch

    ray_tpu_torch.init()

    @ray_tpu_torch.remote
    def f(x): return x * 2

    ray_tpu_torch.get(f.remote(2))  # -> 4

``num_gpus=`` (on ``init``, ``remote`` and ``options``) takes the place
of the reference's ``num_tpus=``: it requests the logical accelerator
resource (``Config.chip_resource``, "GPU"), which ``init`` detects from
the node (``core/node.py`` detect_gpus) without touching CUDA.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core import runtime as _rt
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, get_actor, method
from ray_tpu_torch.core.common import (ObjectRef, ObjectRefGenerator,
                                 ResourceSet)
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import JobID
from ray_tpu_torch.core.node import (detect_gpus, new_session_dir, start_gcs,
                                     start_nodelet)
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core import status as exceptions

__version__ = "0.1.0"

_init_lock = threading.Lock()
_session: Optional[dict] = None


def is_initialized() -> bool:
    return _rt.current_runtime_or_none() is not None


def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: str = "default",
         ignore_reinit_error: bool = False,
         runtime_env: Optional[Dict[str, Any]] = None,
         _system_config: Optional[Dict[str, Any]] = None) -> dict:
    """Start (or connect to) a ray_tpu_torch cluster.

    address=None starts a new local cluster (gcs + one nodelet) unless
    RAY_TPU_ADDRESS is set (the launcher's exec/attach/submit export it —
    ref: ray.init() honoring RAY_ADDRESS); address="host:port" connects
    to an existing GCS.
    ref: worker.py:1108 init / node.py:1148 start_head_processes.
    """
    if address is None:
        address = os.environ.get("RAY_TPU_ADDRESS") or None
    global _session
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return dict(_session or {})
            raise RuntimeError("ray_tpu_torch.init() already called")
        cfg = Config.load(_system_config)
        procs = []
        if address is None:
            session_dir = new_session_dir()
            gcs_proc, gcs_addr = start_gcs(session_dir, cfg)
            procs.append(gcs_proc)
            res = dict(resources or {})
            res.setdefault("CPU", float(num_cpus if num_cpus is not None
                                        else (os.cpu_count() or 1)))
            chips = num_gpus if num_gpus is not None else detect_gpus()
            if chips:
                # cfg.chip_resource lets heterogeneous fleets rename the
                # logical accelerator resource (e.g. "H100") cluster-wide
                res.setdefault(cfg.chip_resource, float(chips))
            nodelet_proc, nodelet_addr, node_id_hex, store_name = start_nodelet(
                session_dir, cfg, gcs_addr, resources=res)
            procs.append(nodelet_proc)
        else:
            session_dir = (os.environ.get("RAY_TPU_SESSION_DIR")
                           or new_session_dir())
            h, p = address.rsplit(":", 1)
            gcs_addr = (h, int(p))
            # find a local nodelet via GCS (pick any alive node on 127.0.0.1;
            # multi-host drivers would match on hostname)
            import asyncio

            from ray_tpu_torch.core.rpc import RpcClient

            async def _nodes():
                c = RpcClient(*gcs_addr)
                try:
                    return await c.call("get_nodes", timeout=cfg.rpc_connect_timeout_s)
                finally:
                    await c.close()
            nodes = asyncio.run(_nodes())
            alive = [n for n in nodes if n.alive]
            if not alive:
                raise RuntimeError(f"no alive nodes at {address}")
            nodelet_addr = alive[0].nodelet_addr
            store_name = alive[0].store_name
            node_id_hex = alive[0].node_id.hex()

        job_id = JobID.from_random()
        runtime = _rt.Runtime(cfg, gcs_addr, nodelet_addr, store_name, job_id,
                              mode="driver", node_id=node_id_hex)
        _rt.set_runtime(runtime)
        runtime.start()
        if runtime_env:
            # Job-level env: merged into every submitted task/actor spec
            # that doesn't set its own (ref: job_config runtime_env).
            from ray_tpu_torch import runtime_env as _renv

            runtime.default_runtime_env = _renv.resolve_uris(runtime,
                                                             runtime_env)
        runtime.gcs_call("add_job", job_id=job_id, driver_addr=runtime.address.addr,
                         meta={"namespace": namespace, "pid": os.getpid()})
        if cfg.log_to_driver:
            runtime.subscribe_logs()
        _session = {
            "address": f"{gcs_addr[0]}:{gcs_addr[1]}",
            "session_dir": session_dir,
            "node_addr": nodelet_addr,
            "namespace": namespace,
            "procs": procs,
            "job_id": job_id,
        }
        atexit.register(shutdown)
        return dict(_session)


def shutdown():
    """Stop the runtime; kill daemons we started (ref: ray.shutdown)."""
    global _session
    with _init_lock:
        runtime = _rt.current_runtime_or_none()
        if runtime is not None:
            try:
                runtime.flush_task_events()
                runtime.gcs_call("finish_job", job_id=runtime.job_id, rpc_timeout=2.0)
            except Exception:
                pass
            runtime.shutdown()
        if _session:
            for p in _session.get("procs", []):
                try:
                    p.terminate()
                except Exception:
                    pass
            for p in _session.get("procs", []):
                try:
                    p.wait(timeout=3)
                except Exception:
                    try:
                        p.kill()
                    except Exception:
                        pass
            _session = None
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass


def remote(*args, **options):
    """@ray_tpu_torch.remote / @ray_tpu_torch.remote(**options) on functions or classes."""
    def make(obj):
        if isinstance(obj, type):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and callable(args[0]) and not options:
        return make(args[0])
    if args:
        raise TypeError("@ray_tpu_torch.remote takes keyword options only")
    return make


def put(value: Any) -> ObjectRef:
    return _rt.get_runtime().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    runtime = _rt.get_runtime()
    if isinstance(refs, ObjectRef):
        single, refs = True, [refs]
    elif isinstance(refs, (list, tuple)):
        single, refs = False, list(refs)
    else:
        raise TypeError(f"ray_tpu_torch.get expects ObjectRef or list, got {type(refs)}")
    t0 = time.monotonic()
    out = runtime.get(refs, timeout=timeout)
    elapsed = time.monotonic() - t0
    warn_s = runtime.cfg.get_timeout_warn_s
    if warn_s > 0 and elapsed > warn_s:
        # ref: ray's "waiting for X seconds" driver warning — a slow get
        # usually means a lost/hung producer, not a slow transfer
        import logging

        logging.getLogger(__name__).warning(
            "ray_tpu_torch.get of %d ref(s) blocked for %.1fs "
            "(get_timeout_warn_s=%.1fs); pass timeout= to bound waits",
            len(refs), elapsed, warn_s)
    return out[0] if single else out


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    if not isinstance(refs, (list, tuple)):
        raise TypeError("ray_tpu_torch.wait expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return _rt.get_runtime().wait(list(refs), num_returns=num_returns,
                                  timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _rt.get_runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = False):
    """Cancel a task (ref: ray.cancel): queued tasks are dropped; an
    executing task gets KeyboardInterrupt (force=True kills its worker).
    The ref's get raises TaskCancelledError. Finished tasks: no-op."""
    _rt.get_runtime().cancel(ref, force=force, recursive=recursive)


class RuntimeContext:
    """Where am I running? (ref: python/ray/runtime_context.py
    RuntimeContext — get_node_id/get_job_id/get_task_id/get_worker_id).
    Snapshot at call time; fetch a fresh one per query."""

    def __init__(self, rt):
        self.node_id = rt.node_id
        self.job_id = rt.job_id.hex()
        self.worker_id = (rt.worker_id.hex()
                          if isinstance(rt.worker_id, bytes)
                          else str(rt.worker_id))
        # exec-context only: None outside a task, like the reference's
        # get_task_id (get_current_task_id falls back to the synthetic
        # driver task id, which is for put-id spaces, not user context)
        tid = getattr(rt._exec_ctx, "task_id", None)
        self.task_id = tid.hex() if tid is not None else None
        # per-execution-context (thread/asyncio-task), NOT per-process:
        # lane-packed actors share a process, so this is the only
        # reliable "which actor am I" (ref: RuntimeContext.get_actor_id)
        aid = getattr(rt._exec_ctx, "actor_id", None)
        self.actor_id = aid.hex() if aid is not None else None
        self.worker_mode = rt.mode

    def get_node_id(self) -> str:
        return self.node_id

    def get_actor_id(self):
        """Id of the actor whose method is executing, else None."""
        return self.actor_id

    def get_job_id(self) -> str:
        return self.job_id

    def get_task_id(self):
        return self.task_id

    def get_worker_id(self) -> str:
        return self.worker_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_rt.get_runtime())


def nodes() -> List[dict]:
    out = []
    for n in _rt.get_runtime().gcs_call("get_nodes"):
        out.append({"NodeID": n.node_id.hex(), "Alive": n.alive,
                    "Resources": n.resources_total.quantities,
                    "Labels": n.labels, "NodeletAddress": n.nodelet_addr,
                    "StoreName": n.store_name})
    return out


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in _rt.get_runtime().gcs_call("get_nodes"):
        if not n.alive:
            continue
        for k, v in n.resources_total.quantities.items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for _, q in _rt.get_runtime().gcs_call("get_available_resources").items():
        for k, v in q.items():
            total[k] = total.get(k, 0.0) + v
    return total


def _fanout_nodelets(method: str) -> Dict[str, dict]:
    """Call `method` on every alive nodelet; errors become {"error": ...}."""
    rt = _rt.get_runtime()
    out = {}
    for n in rt.gcs_call("get_nodes"):
        if not n.alive:
            continue
        try:
            out[n.node_id.hex()] = rt.node_call(n.nodelet_addr, method)
        except Exception as e:
            out[n.node_id.hex()] = {"error": str(e)}
    return out


def stack() -> Dict[str, dict]:
    """All-thread stack dumps from every worker on every alive node
    (ref: `ray stack` scripts.py:1789)."""
    return _fanout_nodelets("dump_worker_stacks")


def internal_stats() -> Dict[str, dict]:
    """Per-daemon handler counts/latency + event-loop lag
    (ref: event_stats.h instrumentation + per-daemon OpenCensus stats),
    plus this process's HBM device-tier occupancy."""
    rt = _rt.get_runtime()
    out = {"gcs": rt.gcs_call("internal_stats"),
           "driver": {"device_store": rt.device_store.stats()}}
    for nid, stats in _fanout_nodelets("internal_stats").items():
        out[f"nodelet:{nid[:12]}"] = stats
    return out


def timeline(limit: int = 1000, chrome: bool = False) -> List[dict]:
    """Recent task state transitions and tracing spans from the GCS
    task-event store (ref: `ray timeline` scripts.py:1835). Flushes the
    local TelemetryAgent first, so spans recorded just before the call
    are visible (read-your-writes). `chrome=True` returns the merged
    Chrome trace with per-worker lanes instead of raw events
    (observability/timeline.py) — json.dump it and load in
    chrome://tracing."""
    rt = _rt.get_runtime()
    rt.flush_task_events(wait=True)
    events = rt.gcs_call("list_task_events", limit=limit)
    if chrome:
        from ray_tpu_torch.observability import chrome_trace

        return chrome_trace(events)
    return events


__all__ = [
    "init", "shutdown", "remote", "put", "get", "wait", "kill", "cancel",
    "get_runtime_context",
    "method", "get_actor", "nodes", "cluster_resources", "available_resources",
    "timeline", "stack", "internal_stats",
    "ObjectRef", "ObjectRefGenerator", "ActorHandle", "exceptions", "is_initialized",
    "__version__",
]
