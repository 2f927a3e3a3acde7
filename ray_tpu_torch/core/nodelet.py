"""Per-node daemon ("nodelet").

Reference: src/ray/raylet/ — NodeManager (node_manager.h:119) owns the worker
pool, grants worker leases, manages local resources and placement-group
bundles, and embeds the object plane. Re-designs for TPU hosts:

- Resources are {CPU, GPU, memory, custom...}; the GPU quantity is the
  host's local card count (core/node.py detect_gpus), and topology labels
  ride on the NodeInfo record so the control plane can gang-schedule.
- The node object store is the native shm segment (ray_tpu_torch/native); the
  nodelet creates it and hands its name to every worker it spawns.
- Object transfer between nodes is chunked pull over the RPC layer
  (ref: ObjectManager::Push/HandlePush object_manager.cc:338,561 and
  PullManager pull_manager.h:52): the requesting nodelet streams chunks from
  the holder into a create/seal buffer.

Lease protocol (ref: node_manager.cc:1881 HandleRequestWorkerLease →
cluster_task_manager.h:42 queue/dispatch/spillback):
  owner → rpc_request_lease(resources, ...) →
    granted {worker_addr, lease_id} | spillback {addr} | queued until free.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import subprocess
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.common import Address, NodeInfo, ResourceSet, TaskSpec
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.external_storage import FilesystemStorage
from ray_tpu_torch.core.ids import NodeID, ObjectID, PlacementGroupID
from ray_tpu_torch.core.memory_monitor import (KillCandidate, MemoryMonitor,
                                         pick_worker_to_kill)
from ray_tpu_torch.core.object_store import SharedMemoryStore
from ray_tpu_torch.core.rpc import ClientPool, ConnectionLost, RemoteError, RpcServer
from ray_tpu_torch.util.backoff import Backoff
from ray_tpu_torch.util.idempotency import IdemCache

logger = logging.getLogger("ray_tpu_torch.nodelet")

_memory_mod = None


def _memattr():
    """Lazy memory-attribution tracker (observability imports core at
    module top, so core modules must import it on first use)."""
    global _memory_mod
    if _memory_mod is None:
        from ray_tpu_torch.observability import memory
        _memory_mod = memory.tracker()
    return _memory_mod


class WorkerRecord:
    def __init__(self, worker_id: bytes, proc: subprocess.Popen,
                 env_key: str = ""):
        self.worker_id = worker_id
        self.proc = proc
        self.env_key = env_key         # runtime-env pool key ("" = plain)
        self.addr: Optional[Address] = None
        self.state = "starting"        # starting | idle | leased | actor | dead
        self.lease_id: Optional[bytes] = None
        self.job_id: Optional[bytes] = None
        self.last_idle = time.time()
        self.lease_time = 0.0          # when the current lease was granted
        self.retriable = True          # current task retries on worker death
        self.resources_released = False  # blocked in get(); CPU given back
        self.actor_id = None           # set when this worker hosts an actor
        self.lane_host = False         # hosts multiple fractional actors
        self.lanes: Dict = {}          # actor_id -> ResourceSet (lane hosts)
        self.ready = asyncio.Event()


class _PendingLease:
    def __init__(self, resources: ResourceSet, pg, fut, job_id=None,
                 retriable=True, env_vars=None):
        self.resources = resources
        self.pg = pg                   # (pg_id, bundle_index) or None
        self.fut: asyncio.Future = fut
        self.job_id = job_id
        self.retriable = retriable
        self.env_vars = env_vars       # process_env_vars for the worker


def _env_key(env_vars) -> str:
    """Pool key for a process-env dict ("" = plain pool)."""
    if not env_vars:
        return ""
    return json.dumps(sorted(env_vars.items()))


class Nodelet:
    def __init__(self, cfg: Config, gcs_addr: Address, session_dir: str,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, Any]] = None,
                 store_name: Optional[str] = None):
        self.cfg = cfg
        self.gcs_addr = gcs_addr
        self.session_dir = session_dir
        # deadlines/keepalive knobs + optional chaos plan bind from the
        # inherited Config so the whole cluster shares one failure model
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.devtools import chaos as _chaos
        _rpc.configure(cfg)
        _chaos.maybe_install(cfg, role="nodelet")
        _chaos.note_peer(tuple(gcs_addr), "gcs")
        self.node_id = NodeID.from_random()
        self.store_name = store_name or f"/rtorch_{self.node_id.hex()[:12]}"
        res = dict(resources) if resources else {}
        res.setdefault("CPU", float(os.cpu_count() or 1))
        self.total = ResourceSet(res)
        self.available = self.total.copy()
        self.labels = labels or {}
        self.workers: Dict[bytes, WorkerRecord] = {}
        # pulsed whenever any worker turns idle, so lease waiters wake
        # immediately instead of on a poll tick (a 20 ms poll quantized
        # every lease grant under fan-out: ~46 obj-arg tasks/s vs ~390
        # event-driven; ref: worker_pool.h callbacks fire on idle)
        self._worker_idle = asyncio.Event()
        self.leases: Dict[bytes, WorkerRecord] = {}
        self.lease_resources: Dict[bytes, Tuple[ResourceSet, Optional[Tuple]]] = {}
        self.pending: deque[_PendingLease] = deque()
        # permanently-infeasible lease asks (no node fits, no spillback
        # target): queued here and shipped to the GCS on the next
        # heartbeat as autoscaler-visible unmet demand (ref: the
        # raylet's infeasible queue feeding autoscaler state)
        self._infeasible: List[dict] = []
        # pg_id -> {bundle_index -> {"resources", "available", "committed"}}
        self.pg_bundles: Dict[PlacementGroupID, Dict[int, dict]] = {}
        self.pool = ClientPool()
        self.server = RpcServer(self)
        self.store: Optional[SharedMemoryStore] = None
        self.spill: Optional[FilesystemStorage] = None
        # Primary copies pinned on behalf of owners (ref: raylet pins
        # primaries, local_object_manager spills them under pressure). The
        # nodelet may spill-then-unpin these autonomously: the disk copy
        # keeps the availability guarantee.
        self.primary_pins: set = set()
        self._spilled_then_dropped = 0
        self._restored = 0
        # cumulative spill-tier traffic (bytes written to / read back
        # from disk) — the observability plane's evidence of what the
        # spill loop actually does, vs. the point-in-time on-disk gauge
        self._spill_bytes_total = 0
        self._restore_bytes_total = 0
        self._native_pulls = 0
        self.xfer_port = -1
        # source addr -> (xfer port or -1, cache expiry time)
        self._xfer_ports: Dict[Tuple, Tuple[int, float]] = {}
        self._hb_seq = 0
        self._stopping = False
        self._lane_locks: Dict[str, asyncio.Lock] = {}
        # Idempotency-token dedupe for the two side-effecting handlers a
        # duplicated frame (retry after dropped response, chaos-injected
        # duplication) would double-spend: lease grants and actor
        # creation. Only granted/ok outcomes are replayed — see
        # util/idempotency.py for why failures must not be.
        self._idem_lease = IdemCache()
        self._idem_create = IdemCache()
        self.memory_monitor = MemoryMonitor(
            cfg.memory_usage_threshold, cfg.memory_monitor_test_usage_file)

    # ------------------------------------------------------------------- boot

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Address:
        self.store = SharedMemoryStore(
            self.store_name, capacity=self.cfg.object_store_memory,
            max_objects=self.cfg.object_store_max_objects, create=True)
        # Native transfer plane (xfer.cc): shm->socket zero-staging path
        # for inter-node pulls; -1 (disabled or failed to start) falls
        # back to the chunk RPC path transparently.
        self.xfer_port = self.store.xfer_serve_start(host) \
            if self.cfg.native_transfer_enabled else -1
        if self.xfer_port > 0:
            self.store.xfer_set_serve_cap(self.cfg.object_serve_concurrency)
        self.server.host, self.server.port = host, port
        addr = await self.server.start()
        info = NodeInfo(node_id=self.node_id, nodelet_addr=addr,
                        resources_total=self.total, labels=self.labels,
                        store_name=self.store_name)
        self._node_info = info
        gcs = self.pool.get(self.gcs_addr)
        r = await gcs.call("register_node", info=info,
                           timeout=self.cfg.rpc_connect_timeout_s)
        assert r["ok"]
        if self.cfg.object_spill_enabled:
            spill_dir = self.cfg.object_spill_dir or os.path.join(
                self.session_dir, "spill", self.node_id.hex()[:12])
            self.spill = FilesystemStorage(spill_dir)
        loop = asyncio.get_running_loop()
        loop.create_task(self._heartbeat_loop())
        loop.create_task(self._reap_loop())
        loop.create_task(self._log_loop())
        if self.cfg.metrics_report_interval_s > 0:
            loop.create_task(self._agent_loop())
        if self.spill is not None:
            loop.create_task(self._spill_loop())
        if self.cfg.memory_monitor_refresh_ms > 0:
            loop.create_task(self._memory_monitor_loop())
        n_prestart = self.cfg.worker_pool_prestart
        if n_prestart < 0:   # auto: a pair of warm workers per node —
            # enough that back-to-back leases never wait on the previous
            # lease-return race; more would tax node start (each worker
            # spawn is a full interpreter start)
            n_prestart = int(min(self.total.quantities.get("CPU", 1.0), 2))
        self._prestart_n = min(n_prestart, self.cfg.max_workers_per_node)
        for _ in range(self._prestart_n):
            loop.create_task(self._start_worker())
        return addr

    async def _heartbeat_loop(self):
        period = self.cfg.health_check_period_s / 2
        gcs = self.pool.get(self.gcs_addr)
        while not self._stopping:
            self._hb_seq += 1
            infeasible, self._infeasible = self._infeasible, []
            try:
                r = await gcs.call("heartbeat", node_id=self.node_id,
                                   seqno=self._hb_seq,
                                   available=self.available,
                                   pending_leases=len(self.pending),
                                   infeasible=infeasible or None,
                                   timeout=5.0)
                if r.get("reregister"):
                    # GCS restarted without membership (fresh or restored
                    # snapshot): re-announce this node, including the actors
                    # it hosts, so the control plane rebuilds its view
                    # without double-creating (ref: GCS failover).
                    await gcs.call("register_node", info=self._node_info,
                                   hosted=self._hosted_actors(), timeout=5.0)
            except (ConnectionLost, RemoteError, OSError):
                # requeue undelivered infeasible rows for the next beat
                self._infeasible = infeasible + self._infeasible
                del self._infeasible[:-32]
            await asyncio.sleep(period)

    async def _agent_loop(self):
        """Embedded dashboard agent (ref: dashboard/agent.py + reporter
        module): push node+host stats to GCS KV so the dashboard head
        aggregates with one KV scan instead of per-node fan-out."""
        from ray_tpu_torch.dashboard.agent import run_agent

        gcs = self.pool.get(self.gcs_addr)

        async def gcs_call_async(method, **kw):
            return await gcs.call(method, timeout=5.0, **kw)

        await run_agent(self, gcs_call_async,
                        self.cfg.metrics_report_interval_s,
                        stop_fn=lambda: self._stopping)

    async def _reap_loop(self):
        """Detect worker deaths; free leases; report to GCS
        (ref: NodeManager worker failure path / HandleUnexpectedWorkerFailure).
        Also reaps store buffers orphaned in kCreating by a producer that
        died mid-write — without this the object id is permanently
        unfetchable on this node (create always sees 'exists')."""
        last_orphan_scan = time.time()
        while not self._stopping:
            await asyncio.sleep(0.1)
            now = time.time()
            if now - last_orphan_scan > 30.0:
                last_orphan_scan = now
                try:
                    n = self.store.reap_creating(
                        self.cfg.creating_orphan_age_s)
                    if n:
                        logger.warning(
                            "reaped %d orphaned in-creation store "
                            "buffers", n)
                except Exception:
                    pass
            for w in list(self.workers.values()):
                if w.state == "dead":
                    continue
                rc = w.proc.poll()
                if rc is not None:
                    was = w.state
                    self._on_worker_dead(w)
                    if was in ("leased", "actor"):
                        await self._report_worker_death(w, f"exit code {rc}")
                elif (w.state == "idle"
                      and now - w.last_idle > self.cfg.worker_idle_timeout_s
                      and len(self.workers) > getattr(self, "_prestart_n",
                                                      0)):
                    self._kill_worker(w, "idle timeout")

    async def _log_loop(self):
        """Tail worker stdout/stderr files and publish new lines to the
        driver via GCS pubsub (ref: _private/log_monitor.py:102 → driver
        print_to_stdstream worker.py:1758)."""
        offsets: Dict[str, int] = {}
        gcs = self.pool.get(self.gcs_addr)
        logdir = os.path.join(self.session_dir, "logs")
        import glob

        while not self._stopping:
            await asyncio.sleep(0.5)
            lines = []
            for path in glob.glob(os.path.join(logdir, "worker-*.out")) + \
                    glob.glob(os.path.join(logdir, "worker-*.err")):
                try:
                    size = os.path.getsize(path)
                    off = offsets.get(path, 0)
                    if size > off:
                        with open(path, "rb") as f:
                            f.seek(off)
                            chunk = f.read(min(size - off, 1 << 20))
                        offsets[path] = off + len(chunk)
                        stream = "err" if path.endswith(".err") else "out"
                        src = os.path.basename(path).rsplit(".", 1)[0]
                        for ln in chunk.decode(errors="replace").splitlines():
                            lines.append({"source": src, "stream": stream,
                                          "line": ln})
                except OSError:
                    continue
            if lines:
                try:
                    await gcs.call("publish", channel="log",
                                   message={"node": self.node_id.hex()[:8],
                                            "lines": lines}, timeout=5.0)
                except Exception:
                    pass

    def _on_worker_dead(self, w: WorkerRecord):
        w.state = "dead"
        self.workers.pop(w.worker_id, None)
        if w.lease_id is not None:
            self._release_lease(w.lease_id)
        # a dead lane host gives back every lane's fractional resources
        for res in w.lanes.values():
            self.available.add(res)
        w.lanes = {}
        if w.lane_host:
            self._drain_pending()
        # a death frees a pool slot: wake saturated lease waiters so a
        # replacement spawns now, not at the 0.5 s wait cap
        self._worker_idle.set()

    # ---------------------------------------------------------------- workers

    async def _start_worker(self, env_vars=None) -> Optional[WorkerRecord]:
        worker_id = os.urandom(20)
        log_base = os.path.join(self.session_dir, "logs", f"worker-{worker_id.hex()[:12]}")
        os.makedirs(os.path.dirname(log_base), exist_ok=True)
        out = open(log_base + ".out", "ab")
        err = open(log_base + ".err", "ab")
        env = dict(os.environ)
        env["RAY_TPU_SESSION_DIR"] = self.session_dir
        if env_vars:
            # runtime-env-keyed pool: these must exist before the worker
            # interpreter imports anything (JAX_PLATFORMS, XLA_FLAGS, ...)
            # (ref: worker_pool.h:156 runtime-env-keyed worker pools)
            env.update(env_vars)
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.worker",
               "--nodelet", f"{self.server.host}:{self.server.port}",
               "--gcs", f"{self.gcs_addr[0]}:{self.gcs_addr[1]}",
               "--store", self.store_name,
               "--node-id", self.node_id.hex(),
               "--worker-id", worker_id.hex(),
               "--config", self.cfg.to_json()]
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=env,
                                start_new_session=True)
        out.close(); err.close()
        w = WorkerRecord(worker_id, proc, env_key=_env_key(env_vars))
        self.workers[worker_id] = w
        try:
            await asyncio.wait_for(w.ready.wait(), self.cfg.worker_start_timeout_s)
        except asyncio.TimeoutError:
            self._kill_worker(w, "startup timeout")
            return None
        return w

    def _kill_worker(self, w: WorkerRecord, reason: str):
        logger.info("killing worker %s: %s", w.worker_id.hex()[:8], reason)
        was = w.state
        try:
            w.proc.terminate()
        except Exception:
            pass
        self._on_worker_dead(w)
        if was in ("leased", "actor"):
            # Deliberate kills of busy workers (OOM, shutdown, requested)
            # must reach the control plane so actor FSMs restart / owners
            # learn the death reason (ref: NodeManager worker failure path).
            try:
                asyncio.get_running_loop().create_task(
                    self._report_worker_death(w, reason))
            except RuntimeError:
                pass

    def _hosted_actors(self) -> dict:
        out = {}
        for w in self.workers.values():
            if w.state != "actor" or w.addr is None:
                continue
            if w.lane_host:
                for aid in w.lanes:
                    out[aid.hex()] = {"addr": w.addr,
                                      "worker_id": w.worker_id}
            elif w.actor_id is not None:
                out[w.actor_id.hex()] = {"addr": w.addr,
                                         "worker_id": w.worker_id}
        return out

    async def _report_worker_death(self, w: WorkerRecord, reason: str,
                                   actor_id=None):
        # Durable best-effort: the GCS may be mid-restart; keep retrying
        # through the failover window so actor FSMs see the death
        # (ref: raylet death reports + GCS reconnect). actor_id scopes the
        # report to ONE lane of a surviving lane-host worker. Jittered
        # exponential backoff: every worker of a dead node reports at
        # once, and fixed sleeps would herd them against the restarting
        # GCS in lockstep.
        bo = Backoff(base_s=0.1, cap_s=2.0,
                     deadline_s=time.time() + self.cfg.gcs_reconnect_timeout_s)
        while not self._stopping:
            try:
                await self.pool.get(self.gcs_addr).call(
                    "report_worker_death", worker_id=w.worker_id,
                    node_id=self.node_id, reason=reason,
                    actor_id=actor_id, timeout=5.0)
                return
            except Exception:
                if bo.expired():
                    return
                await asyncio.sleep(bo.next_delay())

    async def _memory_monitor_loop(self):
        """Kill a worker when host memory crosses the threshold
        (ref: memory_monitor.h:52 polling + worker_killing_policy*.h)."""
        mm = self.memory_monitor
        period = self.cfg.memory_monitor_refresh_ms / 1000.0
        while not self._stopping:
            await asyncio.sleep(period)
            try:
                if not mm.above_threshold():
                    continue
                cands = [KillCandidate(w.worker_id, w.job_id,
                                       w.state == "actor",
                                       w.retriable and w.state == "leased",
                                       w.lease_time)
                         for w in self.workers.values()
                         if w.state in ("leased", "actor")]
                victim = pick_worker_to_kill(
                    cands, self.cfg.memory_monitor_kill_policy)
                if victim is None:
                    continue
                w = self.workers.get(victim.worker_id)
                if w is not None:
                    mm.kills += 1
                    self._kill_worker(
                        w, f"OOM: node memory usage "
                        f"{mm.usage_fraction():.2f} > {mm.threshold:.2f} "
                        "(memory monitor)")
            except Exception:
                logger.exception("memory monitor pass failed")

    async def rpc_register_worker(self, worker_id: bytes, addr: Address) -> dict:
        w = self.workers.get(worker_id)
        if w is None:
            return {"ok": False}
        w.addr = tuple(addr)
        w.state = "idle"
        w.last_idle = time.time()
        w.ready.set()
        self._worker_idle.set()
        from ray_tpu_torch.devtools.chaos import note_peer
        note_peer(w.addr, "worker")
        return {"ok": True}

    async def rpc_worker_blocked(self, worker_id: bytes) -> dict:
        """A leased worker is blocking in get(): give its lease's
        resources back to the pool so what it waits on can schedule
        (ref: NotifyDirectCallTaskBlocked -> raylet releases CPU)."""
        w = self.workers.get(worker_id)
        # actors too: an actor blocking in get() holds its creation
        # resources; releasing them is what prevents actor-getter fleets
        # from deadlocking the node
        if w is None or w.state not in ("leased", "actor") \
                or w.lease_id is None or w.resources_released:
            return {"ok": False}
        entry = self.lease_resources.get(w.lease_id)
        if entry is None:
            return {"ok": False}
        resources, pg = entry
        pool = self._resource_pool(pg)
        if pool is not None:
            pool.add(resources)
        w.resources_released = True
        self._drain_pending()
        return {"ok": True}

    async def rpc_worker_unblocked(self, worker_id: bytes) -> dict:
        """Re-subtract on unblock; transient oversubscription is allowed
        (the reference reacquires the same way)."""
        w = self.workers.get(worker_id)
        if w is None or not w.resources_released or w.lease_id is None:
            return {"ok": False}
        entry = self.lease_resources.get(w.lease_id)
        if entry is not None:
            resources, pg = entry
            pool = self._resource_pool(pg)
            if pool is not None:
                pool.subtract(resources)
        w.resources_released = False
        return {"ok": True}

    async def rpc_dump_worker_stacks(self) -> dict:
        """Fan a stack-dump request to every live worker on this node,
        concurrently — hung workers (the thing `ray stack` debugs) must
        cost one timeout total, not one each."""
        live = [w for w in self.workers.values()
                if w.addr is not None and w.state != "dead"]

        async def dump(w):
            try:
                r = await self.pool.get(tuple(w.addr)).call(
                    "dump_stacks", timeout=5.0)
                r["state"] = w.state
                return r
            except Exception as e:
                return {"error": str(e), "state": w.state}

        results = await asyncio.gather(*(dump(w) for w in live))
        return {"node_id": self.node_id.hex(),
                "workers": {w.worker_id.hex()[:12]: r
                            for w, r in zip(live, results)}}

    async def rpc_kill_worker(self, worker_id: bytes, reason: str = "",
                              actor_id=None) -> dict:
        w = self.workers.get(worker_id)
        if w is None:
            return {"ok": True}
        if actor_id is not None and w.lane_host:
            # lane-scoped kill: only this actor dies, the host (and its
            # other lanes) lives on
            res = w.lanes.pop(actor_id, None)
            if res is not None:
                self.available.add(res)
                self._drain_pending()
            try:
                await self.pool.get(tuple(w.addr)).call(
                    "destroy_actor", actor_id=actor_id, timeout=10.0)
            except (ConnectionLost, RemoteError, OSError) as e:
                self._kill_worker(w, f"lane destroy failed: {e}")
                return {"ok": True}
            # actor-scoped death report so the GCS actor FSM sees it
            # (the host process survives, so no worker-death event fires)
            loop = asyncio.get_running_loop()
            loop.create_task(self._report_worker_death(
                w, reason or "requested", actor_id=actor_id))
            self._lane_host_maybe_idle(w)
            return {"ok": True}
        self._kill_worker(w, reason or "requested")
        return {"ok": True}

    def _countable_workers(self) -> int:
        """Pool occupancy for the max_workers cap. Workers blocked in
        get() don't count — their resources are released and the work
        they wait on may need a fresh worker here (the reference's pool
        grows past the soft cap for exactly this reason; a hard cap
        would deadlock getter fleets)."""
        return sum(1 for w in self.workers.values()
                   if not w.resources_released)

    async def _pop_worker(self, env_vars=None) -> Optional[WorkerRecord]:
        """Pop an idle worker from the pool keyed by the process-env hash
        (ref: worker_pool.h:156 runtime-env-keyed pools). Workers from a
        different pool are never handed out — their process env was fixed
        at spawn."""
        key = _env_key(env_vars)
        for w in self.workers.values():
            if w.state == "idle" and w.env_key == key:
                return w
        if self._countable_workers() < self.cfg.max_workers_per_node:
            return await self._start_worker(env_vars)
        # Saturated: evict an idle worker from another pool to make room
        # (the reference kills idle workers of stale envs under pressure).
        for w in list(self.workers.values()):
            if w.state == "idle" and w.env_key != key:
                self._kill_worker(w, "evicted for runtime-env pool")
                return await self._start_worker(env_vars)
        # Otherwise wait for a matching worker to go idle — or for ANY
        # idle worker we can evict (a lease released mid-wait from another
        # pool must not stall this request for the full timeout).
        # Event-driven: the idle pulse wakes every waiter; each re-scans
        # and losers re-arm (ref: worker_pool callbacks on PushWorker).
        deadline = time.time() + self.cfg.worker_lease_timeout_s
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            self._worker_idle.clear()
            for w in self.workers.values():
                if w.state == "idle" and w.env_key == key:
                    return w
            if self._countable_workers() < self.cfg.max_workers_per_node:
                return await self._start_worker(env_vars)
            for w in list(self.workers.values()):
                if w.state == "idle" and w.env_key != key:
                    self._kill_worker(w, "evicted for runtime-env pool")
                    return await self._start_worker(env_vars)
            try:
                await asyncio.wait_for(self._worker_idle.wait(),
                                       min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass

    # ----------------------------------------------------------------- leases

    def _resource_pool(self, pg: Optional[Tuple]) -> Optional[ResourceSet]:
        """The pool a lease draws from: node-available or a committed bundle."""
        if pg is None:
            return self.available
        pg_id, bundle_index = pg
        bundles = self.pg_bundles.get(pg_id)
        if not bundles:
            return None
        if bundle_index >= 0:
            b = bundles.get(bundle_index)
            return b["available"] if b and b["committed"] else None
        for b in bundles.values():
            if b["committed"]:
                return b["available"]
        return None

    async def rpc_request_lease(self, resources: ResourceSet,
                                pg: Optional[Tuple] = None,
                                grant_or_reject: bool = False,
                                job_id: Optional[bytes] = None,
                                retriable: bool = True,
                                env_vars: Optional[dict] = None,
                                idem: Optional[str] = None) -> dict:
        """``idem``: caller-minted idempotency token. A duplicated frame
        replays the recorded grant instead of leasing a second worker;
        non-granted verdicts (retry/spillback/infeasible) are never
        cached, so a genuine retry with a fresh token re-attempts."""
        return await self._idem_lease.run(
            idem,
            lambda: self._request_lease(resources, pg, grant_or_reject,
                                        job_id, retriable, env_vars),
            cache_if=lambda r: r.get("status") == "granted")

    async def _request_lease(self, resources: ResourceSet,
                             pg: Optional[Tuple] = None,
                             grant_or_reject: bool = False,
                             job_id: Optional[bytes] = None,
                             retriable: bool = True,
                             env_vars: Optional[dict] = None) -> dict:
        pool = self._resource_pool(pg)
        if pool is None:
            return {"status": "infeasible", "error": "placement group bundle not here"}
        if pg is None and not resources.fits_in(self.total):
            # Permanently infeasible on this node → spillback advice
            # (ref: cluster_task_manager.cc infeasible queue + spillback reply).
            target = await self._ask_spillback(resources)
            if target is not None and target["node_id"] != self.node_id:
                return {"status": "spillback", "addr": target["addr"],
                        "node_id": target["node_id"]}
            # cluster-wide infeasible: queue for the heartbeat so the
            # autoscaler learns the shape even when the driver's
            # pick_node path (GCS-side recording) was never involved
            self._infeasible.append({"resources": dict(resources.quantities),
                                     "ts": time.time()})
            del self._infeasible[:-32]
            return {"status": "infeasible",
                    "error": f"no node can satisfy {resources.quantities}"}
        if resources.fits_in(pool):
            return await self._grant(resources, pg, job_id, retriable,
                                     env_vars)
        if grant_or_reject:
            return {"status": "rejected"}
        # Feasible but busy → try spillback to an idle peer, else queue here
        # (ref: hybrid policy prefers local until spread threshold).
        if pg is None:
            target = await self._ask_spillback(resources)
            if target is not None and target["node_id"] != self.node_id:
                return {"status": "spillback", "addr": target["addr"],
                        "node_id": target["node_id"]}
        fut = asyncio.get_running_loop().create_future()
        self.pending.append(_PendingLease(resources, pg, fut, job_id,
                                          retriable, env_vars))
        try:
            return await asyncio.wait_for(fut, self.cfg.worker_lease_timeout_s)
        except asyncio.TimeoutError:
            return {"status": "retry"}

    async def _ask_spillback(self, resources: ResourceSet) -> Optional[dict]:
        gcs = self.pool.get(self.gcs_addr)
        try:
            return await gcs.call("pick_node", resources=resources,
                                  strategy_kind="DEFAULT", timeout=5.0)
        except (ConnectionLost, RemoteError, OSError):
            return None

    async def _grant(self, resources: ResourceSet, pg: Optional[Tuple],
                     job_id: Optional[bytes] = None,
                     retriable: bool = True,
                     env_vars: Optional[dict] = None,
                     reserved: bool = False) -> dict:
        pool = self._resource_pool(pg)
        if not reserved:
            pool.subtract(resources)
        w = await self._pop_worker(env_vars)
        if w is None:
            pool.add(resources)
            return {"status": "retry", "error": "no worker available"}
        lease_id = os.urandom(16)
        w.state = "leased"
        w.lease_id = lease_id
        w.job_id = job_id
        w.lease_time = time.time()
        w.retriable = retriable
        self.leases[lease_id] = w
        self.lease_resources[lease_id] = (resources, pg)
        return {"status": "granted", "lease_id": lease_id,
                "worker_addr": w.addr, "worker_id": w.worker_id}

    async def rpc_return_lease(self, lease_id: bytes) -> dict:
        self._release_lease(lease_id)
        return {"ok": True}

    def _release_lease(self, lease_id: bytes):
        w = self.leases.pop(lease_id, None)
        entry = self.lease_resources.pop(lease_id, None)
        if entry is not None and not (
                w is not None and getattr(w, "resources_released", False)):
            # skip the add if the blocked-get path already returned them
            resources, pg = entry
            pool = self._resource_pool(pg)
            if pool is not None:
                pool.add(resources)
        if w is not None:
            w.resources_released = False
        if w is not None and w.state == "leased":
            w.state = "idle"
            w.lease_id = None
            w.last_idle = time.time()
            self._worker_idle.set()
        self._drain_pending()

    def _drain_pending(self):
        if not self.pending:
            return
        loop = asyncio.get_running_loop()
        still = deque()
        while self.pending:
            p = self.pending.popleft()
            pool = self._resource_pool(p.pg)
            if p.fut.done():
                continue
            if pool is not None and p.resources.fits_in(pool):
                # Reserve SYNCHRONOUSLY: the grant runs as a task, and
                # deferring the subtract would admit every pending lease
                # against the same un-decremented pool (one freed CPU
                # must grant one lease, not the whole queue).
                pool.subtract(p.resources)

                async def _do(p=p):
                    r = await self._grant(p.resources, p.pg, p.job_id,
                                          p.retriable, p.env_vars,
                                          reserved=True)
                    if not p.fut.done():
                        p.fut.set_result(r)
                    elif r.get("status") == "granted":
                        # requester gave up (timeout): hand the lease back
                        self._release_lease(r["lease_id"])
                loop.create_task(_do())
            else:
                still.append(p)
        self.pending = still

    # ----------------------------------------------------------------- actors

    def _laneable(self, spec: TaskSpec) -> bool:
        """Lane-host candidates: strictly fractional CPU, nothing else.
        num_cpus>=1 and custom/GPU-resource actors keep dedicated workers
        (process isolation + the lease protocol's accounting); PG actors
        keep the bundle-accounted lease path."""
        if self.cfg.actor_lanes_per_worker <= 0:
            return False
        if spec.scheduling.kind == "PLACEMENT_GROUP":
            return False
        q = spec.resources.quantities
        cpu = q.get("CPU", 0.0)
        return 0.0 < cpu < 1.0 and all(
            v == 0 for k, v in q.items() if k != "CPU")

    async def _create_actor_lane(self, spec: TaskSpec) -> dict:
        """Pack a fractional-CPU actor into a shared lane-host worker
        (one spawn amortizes over actor_lanes_per_worker actors — the
        density path the reference reaches with 0.001-CPU actors across
        its prestarted per-CPU worker fleet)."""
        from ray_tpu_torch.runtime_env import process_env

        env_vars = process_env(spec.runtime_env)
        key = _env_key(env_vars)
        # serialize host acquisition per pool key: a burst of concurrent
        # creates must PACK into one spawning host, not each spawn its own
        lock = self._lane_locks.setdefault(key, asyncio.Lock())
        async with lock:
            if not spec.resources.fits_in(self.available):
                return {"ok": False, "retryable": True,
                        "error": "insufficient node resources for actor "
                                 "lane"}
            host = None
            for w in self.workers.values():
                if (w.state == "actor" and w.lane_host and w.env_key == key
                        and w.job_id == spec.job_id.binary()
                        and len(w.lanes) < self.cfg.actor_lanes_per_worker):
                    host = w
                    break
            if host is None:
                # fail fast at the worker cap instead of waiting inside
                # the lane lock (the GCS retries at 0.2 s; a long wait
                # here would head-of-line-block creates that could fill
                # lanes freed in the meantime). ANY idle worker counts:
                # _pop_worker evicts mismatched-env idles immediately.
                has_idle = any(w.state == "idle"
                               for w in self.workers.values())
                if not has_idle and self._countable_workers() >= \
                        self.cfg.max_workers_per_node:
                    return {"ok": False, "retryable": True,
                            "error": "lane capacity exhausted "
                                     "(max_workers_per_node x "
                                     "actor_lanes_per_worker); retry"}
                host = await self._pop_worker(env_vars)
                if host is None:
                    return {"ok": False, "retryable": True,
                            "error": "no worker available for lane host"}
                # the admission check above is stale after the await
                # (leases draw on the same pool concurrently): re-check
                # before reserving, or available goes negative
                if not spec.resources.fits_in(self.available):
                    self._worker_idle.set()   # host stays idle in pool
                    return {"ok": False, "retryable": True,
                            "error": "insufficient node resources for "
                                     "actor lane"}
                host.state = "actor"
                host.lane_host = True
                host.job_id = spec.job_id.binary()
            # reserve under the lock; the creation RPC itself runs outside
            # it so lane ctors still overlap
            self.available.subtract(spec.resources)
            host.lanes[spec.actor_id] = spec.resources.copy()
        client = self.pool.get(tuple(host.addr))
        try:
            res = await client.call("create_actor", spec=spec,
                                    timeout=self.cfg.worker_start_timeout_s)
        except ConnectionLost as e:
            # transport broke: the host process is gone/wedged — killing
            # it death-reports every lane for restart
            self._lane_rollback(host, spec.actor_id)
            self._kill_worker(host, f"lane creation rpc failed: {e}")
            return {"ok": False, "retryable": True, "error": str(e)}
        except (RemoteError, OSError) as e:
            # THIS lane's creation failed (ctor hang past the deadline,
            # or a handler error); sibling lanes are healthy — tombstone
            # the lane worker-side so a late-finishing ctor can't install
            # a zombie, and keep the host
            self._lane_rollback(host, spec.actor_id)
            try:
                await client.call("destroy_actor", actor_id=spec.actor_id,
                                  timeout=5.0)
            except Exception:
                pass
            self._lane_host_maybe_idle(host)
            return {"ok": False, "retryable": True, "error": str(e)}
        if not res.get("ok"):
            # ctor raised: the host process is healthy — only the lane dies
            self._lane_rollback(host, spec.actor_id)
            self._lane_host_maybe_idle(host)
            return {"ok": False, "retryable": False,
                    "error": res.get("error")}
        return {"ok": True, "worker_addr": host.addr,
                "worker_id": host.worker_id}

    def _lane_rollback(self, host: WorkerRecord, actor_id):
        """Return a reserved lane's resources exactly once: if the host
        died mid-create, _on_worker_dead already cleared w.lanes and
        refunded them — a defaulted pop would double-add and inflate
        self.available past the node total."""
        res = host.lanes.pop(actor_id, None)
        if res is not None:
            self.available.add(res)

    def _lane_host_maybe_idle(self, w: WorkerRecord):
        """An empty lane host returns to the idle pool (reusable by any
        lease, reclaimed by the idle reaper) instead of sitting in state
        'actor' forever holding a max_workers_per_node slot."""
        if w.lane_host and not w.lanes and w.state == "actor":
            w.state = "idle"
            w.lane_host = False
            w.actor_id = None
            w.job_id = None
            w.last_idle = time.time()
            self._worker_idle.set()

    async def rpc_create_actor(self, spec: TaskSpec,
                               idem: Optional[str] = None) -> dict:
        """Lease a dedicated worker and run the creation task on it
        (ref: gcs_actor_scheduler leases from raylet + pushes creation).
        Fractional-CPU actors take the lane path instead.

        ``idem`` is the GCS's token, stable across its retries of one
        (actor, incarnation): a retry after a dropped response replays
        the recorded placement instead of leasing a second worker and
        running ``__init__`` twice. Failures are not cached — the retry
        exists to attempt creation again."""
        return await self._idem_create.run(
            idem, lambda: self._create_actor(spec),
            cache_if=lambda r: r.get("ok"))

    async def _create_actor(self, spec: TaskSpec) -> dict:
        if self._laneable(spec):
            return await self._create_actor_lane(spec)
        pg = None
        if spec.scheduling.kind == "PLACEMENT_GROUP":
            pg = (spec.scheduling.pg_id, spec.scheduling.bundle_index)
        from ray_tpu_torch.runtime_env import process_env

        r = await self.rpc_request_lease(
            resources=spec.resources, pg=pg, job_id=spec.job_id.binary(),
            retriable=False, env_vars=process_env(spec.runtime_env))
        if r["status"] != "granted":
            return {"ok": False, "retryable": r["status"] in ("retry", "spillback"),
                    "error": r.get("error", r["status"])}
        w = self.leases[r["lease_id"]]
        w.state = "actor"
        w.job_id = spec.job_id.binary()
        w.actor_id = spec.actor_id
        client = self.pool.get(tuple(w.addr))
        try:
            res = await client.call("create_actor", spec=spec,
                                    timeout=self.cfg.worker_start_timeout_s)
        except (ConnectionLost, RemoteError, OSError) as e:
            self._kill_worker(w, f"actor creation rpc failed: {e}")
            return {"ok": False, "retryable": True, "error": str(e)}
        if not res.get("ok"):
            self._kill_worker(w, "actor __init__ failed")
            return {"ok": False, "retryable": False, "error": res.get("error")}
        return {"ok": True, "worker_addr": w.addr, "worker_id": w.worker_id}

    # ------------------------------------------------------- placement groups

    async def rpc_pg_prepare(self, pg_id: PlacementGroupID, bundle_index: int,
                             resources: ResourceSet) -> dict:
        if not resources.fits_in(self.available):
            return {"ok": False}
        self.available.subtract(resources)
        self.pg_bundles.setdefault(pg_id, {})[bundle_index] = {
            "resources": resources.copy(), "available": resources.copy(),
            "committed": False}
        return {"ok": True}

    async def rpc_pg_commit(self, pg_id: PlacementGroupID, bundle_index: int) -> dict:
        b = self.pg_bundles.get(pg_id, {}).get(bundle_index)
        if b is None:
            return {"ok": False}
        b["committed"] = True
        self._drain_pending()
        return {"ok": True}

    async def rpc_pg_return(self, pg_id: PlacementGroupID, bundle_index: int) -> dict:
        b = self.pg_bundles.get(pg_id, {}).pop(bundle_index, None)
        if b is not None:
            self.available.add(b["resources"])
            self._drain_pending()
        return {"ok": True}

    # ----------------------------------------------------------- object plane
    #
    # Spilling (ref: local_object_manager.h:41 spill-under-pressure +
    # external_storage.py FileSystemStorage): a background pass copies sealed
    # LRU objects to disk *before* native eviction could drop them, then
    # frees the unpinned ones. Pinned primaries are only dropped after their
    # owner releases the pin (rpc_free_space reply → owner unpins → native
    # LRU eviction reclaims, with the disk copy as the durable tier).

    def _spill_usage(self) -> float:
        cap = self.store.capacity() or 1
        return self.store.bytes_in_use() / cap

    async def _spill_loop(self):
        period = 0.2
        while not self._stopping:
            try:
                if self._spill_usage() > self.cfg.object_spill_threshold:
                    low = int(self.cfg.object_spill_low_water
                              * self.store.capacity())
                    target = self.store.bytes_in_use() - low
                    await self._spill_pass(target)
            except Exception:
                logger.exception("spill pass failed")
            await asyncio.sleep(period)

    async def _spill_pass(self, target_bytes: int) -> dict:
        """Spill sealed LRU objects until ~target_bytes are freed.

        An object is freeable once its only pin is the nodelet's own
        primary pin (reader pins block freeing but not the disk copy).
        Freeing uses the atomic evict-if-unpinned native primitive so a
        reader pinning after our snapshot is never invalidated."""
        freed = 0
        for oid, size, _pins in self.store.list_objects():
            if freed >= target_bytes:
                break
            if not self.spill.contains(oid):
                view = self.store.get_view(oid)
                if view is None:
                    continue
                try:
                    data = bytes(view)
                finally:
                    del view
                    self.store.release(oid)
                await asyncio.to_thread(self.spill.spill, oid, data)
                self._spill_bytes_total += len(data)
            our_pin = 1 if oid in self.primary_pins else 0
            if self.store.evict_if_unpinned(oid, max_pins=our_pin):
                self.primary_pins.discard(oid)
                _memattr().release(oid)   # left shm; the spill tier holds it
                self._spilled_then_dropped += 1
                freed += size
        return {"freed": freed}

    async def rpc_free_space(self, need_bytes: int, **_compat) -> dict:
        """Make room for an incoming allocation (owner-side put retry path)."""
        if self.spill is None:
            return {"ok": False, "freed": 0, "error": "spilling disabled"}
        r = await self._spill_pass(need_bytes)
        r["ok"] = True
        return r

    async def rpc_pin_object(self, oid: ObjectID) -> dict:
        """Pin a primary copy on behalf of its owner (ref: raylet
        PinObjectIDs). Idempotent; the pin lives until delete or spill."""
        if oid in self.primary_pins:
            return {"ok": True}
        view = self.store.get_view(oid)
        if view is None:
            # Already only on disk (or gone); the spill tier is the pin.
            ok = self.spill is not None and self.spill.contains(oid)
            return {"ok": ok}
        size = len(view)
        del view  # keep the refcount from ts_get; release happens at unpin
        self.primary_pins.add(oid)
        mem = _memattr()
        mem.attribute(oid, "user", size, owner=self.node_id.hex()[:12])
        mem.pin(oid, "primary")
        return {"ok": True}

    async def rpc_pin_objects(self, oids: List[ObjectID]) -> dict:
        """Batched rpc_pin_object: one RPC pins a whole wave of primaries.
        The collective zero-copy transport puts pipeline_chunks sub-chunk
        objects per ring step, and a KV handoff (serve/kv_transfer.py)
        pins one object per page group; pinning them individually would
        pay one awaited store transaction plus two memattr lock rounds
        per object. One synchronous store sweep (the leaked ts_get
        refcount IS the pin, exactly as rpc_pin_object) and a single
        memattr batch instead."""
        pinned, ok = 0, True
        batch = []
        for oid in oids:
            if oid in self.primary_pins:
                pinned += 1
                continue
            view = self.store.get_view(oid)
            if view is None:
                # already only on disk (or gone); the spill tier is the pin
                if self.spill is not None and self.spill.contains(oid):
                    pinned += 1
                else:
                    ok = False
                continue
            size = len(view)
            del view  # keep the refcount from ts_get; release at unpin
            self.primary_pins.add(oid)
            batch.append((oid, size))
            pinned += 1
        if batch:
            _memattr().attribute_pin_many(
                batch, reason="primary", owner=self.node_id.hex()[:12])
        return {"ok": ok, "pinned": pinned}

    async def _restore_local(self, oid: ObjectID) -> bool:
        """Disk → shm (ref: restore_spilled_object). False if absent/full."""
        if self.spill is None or not self.spill.contains(oid):
            return False
        if self.store.contains(oid):
            return True
        data = await asyncio.to_thread(self.spill.restore, oid)
        if data is None:
            return False
        view = self.store.create_view(oid, len(data))
        if view is None:
            # Make room (other spilled-but-resident objects can go).
            await self._spill_pass(len(data))
            view = self.store.create_view(oid, len(data))
        if view is None:
            return self.store.contains(oid)
        try:
            view[:] = data
        except BaseException:
            del view
            self.store.abort(oid)
            raise
        del view
        self.store.seal(oid)
        self._restored += 1
        self._restore_bytes_total += len(data)
        return True

    async def rpc_has_object(self, oid: ObjectID) -> bool:
        return self.store.contains(oid) or (
            self.spill is not None and self.spill.contains(oid))

    async def rpc_read_chunk(self, oid: ObjectID, offset: int, size: int) -> Optional[dict]:
        """Serve one chunk of a local sealed object (ref: HandlePush chunks).
        Falls back to the spill tier, streaming straight off disk."""
        view = self.store.get_view(oid)
        if view is None:
            if self.spill is not None:
                r = await asyncio.to_thread(self.spill.read_range, oid,
                                            offset, size)
                if r is not None:
                    return {"total": r[0], "data": r[1]}
            return None
        try:
            total = len(view)
            data = bytes(view[offset:offset + size])
        finally:
            del view
            self.store.release(oid)
        return {"total": total, "data": data}

    async def rpc_xfer_addr(self) -> dict:
        """The native transfer plane's endpoint (xfer.cc), or port -1 if
        it did not start (pullers then use the chunk RPC path)."""
        return {"host": self.server.host, "port": self.xfer_port}

    async def _xfer_port_for(self, key: Tuple) -> int:
        """Cached peer xfer port. Failures are cached only briefly (a
        peer busy at startup must not disable the native plane forever)
        and successes expire too (a restarted peer binds a new port)."""
        cached = self._xfer_ports.get(key)
        now = time.time()
        if cached is not None and now < cached[1]:
            return cached[0]
        try:
            r = await self.pool.get(key).call("xfer_addr", timeout=10.0)
            port = int(r["port"])
            ttl = 300.0
        except (ConnectionLost, RemoteError, OSError, KeyError):
            port, ttl = -1, 15.0
        self._xfer_ports[key] = (port, now + ttl)
        return port

    async def _pull_native(self, oid: ObjectID, source: Address) -> str:
        """Try the zero-staging native plane first. Returns "ok" (sealed
        locally), "busy" (source at its serve cap — the puller should
        retry, ideally at another holder), or "fallback" (use chunk
        RPC)."""
        key = tuple(source)
        port = await self._xfer_port_for(key)
        if port <= 0:
            return "fallback"
        host = source[0]
        rc, total = await asyncio.to_thread(self.store.xfer_fetch, host,
                                            port, oid)
        if rc == 3 and self.spill is not None:
            # allocation failed: free exactly what the object needs (the
            # source already told us) plus slack, then retry
            await self._spill_pass(max(total,
                                       self.cfg.object_store_memory // 8))
            rc, total = await asyncio.to_thread(self.store.xfer_fetch, host,
                                                port, oid)
        if rc == 5:
            # A racing pull/producer owns the buffer: wait for its seal
            # instead of transferring a second copy. Bounded: a racer
            # SIGKILLed mid-write leaves the entry kCreating forever (no
            # progress signal is exposed), so after the io-timeout window
            # the native path gives up and the chunk-RPC fallback's own
            # create/contains logic takes over.
            deadline = time.time() + 150.0
            while time.time() < deadline:
                if self.store.contains(oid):
                    return "ok"
                st = self.store.state(oid)
                if st == 0:   # racer aborted; retry once natively
                    rc2, _ = await asyncio.to_thread(self.store.xfer_fetch,
                                                     host, port, oid)
                    if rc2 == 0:
                        self._native_pulls += 1
                        return "ok"
                    if rc2 == 6:
                        return "busy"
                    if rc2 != 5:
                        return "fallback"
                await asyncio.sleep(0.05)
            return "fallback"
        if rc == 6:
            return "busy"
        if rc == 2:
            # io error: peer may have restarted on a new port — requery
            self._xfer_ports.pop(key, None)
            return "fallback"
        if rc == 0:
            self._native_pulls += 1
            return "ok"
        return "fallback"

    def _object_nbytes(self, oid: ObjectID) -> int:
        """Size of a sealed local object (edge-telemetry stamping)."""
        view = self.store.get_view(oid)
        if view is None:
            return 0
        try:
            return view.nbytes
        finally:
            del view
            self.store.release(oid)

    async def rpc_pull_object(self, oid: ObjectID, source: Address) -> dict:
        """Pull a remote object into the local store: native zero-staging
        plane (xfer.cc) when the source runs one, chunked RPC otherwise
        (ref: PullManager pull_manager.h:52 + ObjectManager::Push).
        `nbytes` is present ONLY when bytes actually crossed the wire —
        already-local / restored hits omit it so pullers don't record
        phantom transfer edges."""
        if self.store.contains(oid):
            return {"ok": True}
        if await self._restore_local(oid):
            return {"ok": True}
        if tuple(source) == (self.server.host, self.server.port):
            return {"ok": False, "error": "object not at source"}
        native = await self._pull_native(oid, source)
        if native == "ok":
            return {"ok": True, "nbytes": self._object_nbytes(oid)}
        if native == "busy":
            # do NOT fall through to chunk RPC: that would route the
            # same bytes through the same saturated source, just slower.
            # The caller retries — against a peer once one registers.
            return {"ok": False, "busy": True, "error": "source busy"}
        src = self.pool.get(tuple(source))
        chunk = self.cfg.object_transfer_chunk_bytes
        try:
            first = await src.call("read_chunk", oid=oid, offset=0, size=chunk)
        except (ConnectionLost, RemoteError, OSError) as e:
            return {"ok": False, "error": f"source unreachable: {e}"}
        if first is None:
            return {"ok": False, "error": "object not at source"}
        total = first["total"]
        view = self.store.create_view(oid, total)
        if view is None and self.spill is not None:
            await self._spill_pass(total)
            view = self.store.create_view(oid, total)
        if view is None:
            if self.store.contains(oid):
                return {"ok": True}
            return {"ok": False, "error": "local store full"}
        try:
            data = first["data"]
            view[0:len(data)] = data
            off = len(data)
            while off < total:
                r = await src.call("read_chunk", oid=oid, offset=off, size=chunk)
                if r is None:
                    raise ConnectionLost("object vanished at source mid-pull")
                view[off:off + len(r["data"])] = r["data"]
                off += len(r["data"])
        except Exception as e:
            del view
            self.store.abort(oid)
            return {"ok": False, "error": str(e)}
        del view
        self.store.seal(oid)
        return {"ok": True, "nbytes": total}

    async def rpc_delete_objects(self, oids: List[ObjectID]) -> dict:
        for oid in oids:
            if oid in self.primary_pins:
                self.store.release(oid)
                self.primary_pins.discard(oid)
            self.store.delete(oid)
            _memattr().release(oid)
            if self.spill is not None:
                self.spill.delete(oid)
        return {"ok": True}

    # ------------------------------------------------------------------- misc

    async def rpc_job_finished(self, job_id: bytes) -> dict:
        for w in list(self.workers.values()):
            if w.job_id == job_id:
                self._kill_worker(w, "job finished")
        return {"ok": True}

    async def rpc_node_stats(self) -> dict:
        return {
            "node_id": self.node_id,
            "workers": {w.worker_id.hex()[:8]: w.state for w in self.workers.values()},
            "available": self.available.quantities,
            "total": self.total.quantities,
            "store_bytes": self.store.bytes_in_use(),
            "store_capacity": self.store.capacity(),
            "store_objects": self.store.num_objects(),
            "store_evictions": self.store.num_evictions(),
            # spilling-readiness: occupancy + pinned (unspillable) share
            # + pin-count distribution (object_store.pin_summary)
            **{f"store_{k}": v for k, v in self.store.pin_summary().items()},
            "spilled_objects": (self.spill.num_spilled()
                                if self.spill is not None else 0),
            "spilled_bytes": (self.spill.bytes_spilled()
                              if self.spill is not None else 0),
            "restored_objects": self._restored,
            # spill-tier lifecycle: objects dropped from shm after their
            # disk copy became the pin, plus cumulative disk traffic
            "spilled_then_dropped": self._spilled_then_dropped,
            "spill_bytes_total": self._spill_bytes_total,
            "restore_bytes_total": self._restore_bytes_total,
            "native_pulls": self._native_pulls,
            "serve_busy_rejections": (self.store.xfer_busy_rejections()
                                      if self.xfer_port > 0 else 0),
            "xfer_port": self.xfer_port,
            "pending_leases": len(self.pending),
            "oom_kills": self.memory_monitor.kills,
            # Memory-attribution snapshot rides the node_stats KV push
            # (the nodelet has no TelemetryAgent); the GCS folds it at
            # memory_report() read time.
            "memory": self._memory_snapshot(),
        }

    def _memory_snapshot(self):
        try:
            from ray_tpu_torch.observability import memory as _mem
            return _mem.snapshot_for_report(self.store)
        except Exception:
            return None

    async def rpc_ping(self) -> dict:
        return {"ok": True}

    async def rpc_shutdown(self) -> dict:
        self._stopping = True
        for w in list(self.workers.values()):
            self._kill_worker(w, "nodelet shutdown")
        if self.store is not None:
            self.store.xfer_serve_stop()
            # keep the segment mapped until os._exit: a live xfer thread
            # mid-transfer must fault on a closed socket, not on munmap
            self.store.close(destroy=True, unmap=False)
        asyncio.get_running_loop().call_later(0.05, lambda: os._exit(0))
        return {"ok": True}


def main():
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--config", default="{}")
    parser.add_argument("--ready-fd", type=int, default=-1)
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[nodelet] %(asctime)s %(levelname)s %(message)s")
    cfg = Config.from_json(args.config)
    gh, gp = args.gcs.rsplit(":", 1)

    async def run():
        nodelet = Nodelet(cfg, (gh, int(gp)), args.session_dir,
                          resources=json.loads(args.resources),
                          labels=json.loads(args.labels))
        host, port = await nodelet.start(args.host, args.port)
        if args.ready_fd >= 0:
            os.write(args.ready_fd,
                     f"{host}:{port}:{nodelet.node_id.hex()}:{nodelet.store_name}\n".encode())
            os.close(args.ready_fd)
        logger.info("nodelet %s on %s:%d", nodelet.node_id.hex()[:8], host, port)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(run())


if __name__ == "__main__":
    main()
