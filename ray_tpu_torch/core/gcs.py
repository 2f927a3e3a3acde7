"""Cluster control plane ("GCS").

Reference: src/ray/gcs/gcs_server/gcs_server.cc:192-237 wires the same
subsystems this module holds in one asyncio process:

- node membership + passive health checks (ref: GcsNodeManager,
  GcsHealthCheckManager; thresholds ray_config_def.h:793-799)
- resource view fed by nodelet heartbeats (ref: RaySyncer gossip — here a
  star topology: every nodelet reports (seqno, available) each period)
- actor manager with restart FSM and named-actor registry
  (ref: gcs_actor_manager.cc:246,271,1100)
- placement groups with two-phase PREPARE/COMMIT reservation across nodelets
  (ref: gcs_placement_group_scheduler.h)
- internal KV (ref: gcs_kv_manager.h) — also the function/class code store
  (ref: function_manager.py:61 exports via GCS KV)
- job table, task-event sink (ref: gcs_task_manager.h), pub/sub push
  (ref: src/ray/pubsub/)

Storage is pluggable (ref: GcsTableStorage memory/Redis backends,
gcs_table_storage.h:252): "memory" (default, no durability) or "file" —
debounced pickle snapshots PLUS a per-mutation append-WAL
(core/gcs_storage.py), so every acked write survives a GCS crash, not
just state as of the last snapshot point.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.common import (Address, NodeInfo, ResourceSet, TaskSpec)
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.core.rpc import ClientPool, ConnectionLost, RemoteError, RpcServer
from ray_tpu_torch.core.scheduling_policy import (HybridPolicy, SchedNode,
                                            SpreadPolicy, pack_bundles)

logger = logging.getLogger("ray_tpu_torch.gcs")

# Actor FSM states (ref: rpc::ActorTableData::ActorState)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


def _shape(resources: Dict[str, float]) -> frozenset:
    """A resource ask's identity for unmet-demand bookkeeping."""
    return frozenset(resources.items())


class ActorRecord:
    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.actor_id: ActorID = spec.actor_id
        self.state = PENDING_CREATION
        self.address: Optional[Address] = None      # worker RPC address
        self.node_id: Optional[NodeID] = None
        self.worker_id: bytes = b""
        self.num_restarts = 0
        self.max_restarts = spec.max_restarts
        self.name = spec.actor_name
        self.namespace = spec.namespace
        self.death_cause: str = ""

    def view(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id,
            "num_restarts": self.num_restarts,
            "max_restarts": self.max_restarts,
            "name": self.name,
            "namespace": self.namespace,
            "death_cause": self.death_cause,
            "class_name": self.spec.name,
        }


class GcsServer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        # deadlines/keepalive knobs + optional chaos plan bind from the
        # inherited Config so the whole cluster shares one failure model
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.devtools import chaos as _chaos
        _rpc.configure(cfg)
        _chaos.maybe_install(cfg, role="gcs")
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.available: Dict[NodeID, ResourceSet] = {}
        self.heartbeat_seq: Dict[NodeID, int] = {}
        self.last_seen: Dict[NodeID, float] = {}
        self.actors: Dict[ActorID, ActorRecord] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.jobs: Dict[JobID, dict] = {}
        self.kv: Dict[Tuple[str, bytes], bytes] = {}
        self.pgs: Dict[PlacementGroupID, dict] = {}
        self.subscribers: Dict[str, set] = defaultdict(set)  # channel -> {addr}
        self.pending_leases: Dict[NodeID, int] = {}
        self.unmet_demand: List[dict] = []  # infeasible resource asks
        # resource shape -> when an ask of it was last placed
        self._demand_met: Dict[frozenset, float] = {}
        # reporter-keyed gang shortfalls (elastic training refill/grow;
        # same reporter-keyed + staleness-aged shape as serve
        # report_load) — folded into get_load()'s unmet_demand
        self.gang_demand: Dict[str, dict] = {}
        # reporter -> highest seq applied (monotonic fence against
        # reordered/duplicated stale gang-demand reports)
        self._gang_demand_seq: Dict[str, int] = {}
        self.task_events: deque = deque(maxlen=cfg.task_event_buffer_size)
        # per-edge EWMA latency/bandwidth fed by batched telemetry
        # reports (in-memory: telemetry, re-learned after failover)
        from ray_tpu_torch.observability.edges import EdgeModel
        self.edge_model = EdgeModel()
        # stall watchdog + straggler detection over beacon snapshots
        # riding the same telemetry reports (in-memory, like edge_model)
        from ray_tpu_torch.observability.health import HealthAggregator
        self.health = HealthAggregator(
            straggler_k=cfg.straggler_k,
            straggler_min_peers=cfg.straggler_min_peers)
        # memory attribution fold over per-process tracker snapshots
        # riding the same reports (in-memory, like health/edge_model)
        from ray_tpu_torch.observability.memory import MemoryAggregator
        self.memory = MemoryAggregator(
            leak_suspect_s=cfg.memory_leak_suspect_s,
            cold_after_s=cfg.memory_cold_after_s,
            stale_after_s=max(60.0, 10 * cfg.telemetry_report_interval_s))
        self.pool = ClientPool()
        self.server = RpcServer(self)
        # pluggable node-picking policies (ref: scheduling/policy/)
        self._hybrid_policy = HybridPolicy(
            spread_threshold=cfg.scheduler_spread_threshold,
            top_k_fraction=cfg.scheduler_top_k_fraction)
        self._spread_policy = SpreadPolicy()
        self._stopping = False
        self._dirty = False
        # pluggable persistence: snapshot + append-WAL (ref:
        # gcs_table_storage.h:252 over memory/redis store clients)
        from ray_tpu_torch.core.gcs_storage import FileGcsStorage, MemoryGcsStorage
        if cfg.gcs_storage == "file" and cfg.gcs_file_storage_path:
            self.storage = FileGcsStorage(cfg.gcs_file_storage_path)
        else:
            self.storage = MemoryGcsStorage()
        # node_id -> {actor_id_hex: {"addr", "worker_id"}} from re-registration
        self._hosted: Dict[NodeID, dict] = {}
        # global KV-prefix directory (serve/disagg): page-group chain
        # hash -> exported page-group object in the zero-copy store, so
        # ANY replica can adopt a warm shared prefix instead of
        # re-prefilling it. LRU-bounded; in-memory like edge_model —
        # entries are a cache of what prefill replicas currently retain,
        # re-registered on the next prefill after a GCS failover.
        from collections import OrderedDict
        self.prefix_dir: "OrderedDict[bytes, dict]" = OrderedDict()
        self.prefix_dir_stats: Dict[str, int] = {
            "registered": 0, "hits": 0, "misses": 0, "evicted": 0,
            "dropped": 0}

    # ------------------------------------------------------------------ boot

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Address:
        self.server.host, self.server.port = host, port
        addr = await self.server.start()
        self._maybe_restore()
        loop = asyncio.get_running_loop()
        loop.create_task(self._health_loop())
        if self._snapshot_path():
            loop.create_task(self._snapshot_loop())
        if self.actors:
            # Restored from a snapshot: reconcile after nodelets rejoin
            # (ref: gcs_actor_manager restart reconstruction on failover).
            loop.create_task(self._failover_reconcile())
        return addr

    async def _failover_reconcile(self):
        """Post-restart actor reconciliation. Surviving nodelets re-register
        within a heartbeat (their register_node carries hosted actors, which
        rpc_register_node adopts). After that grace window:
        - still-PENDING/RESTARTING records re-drive creation (their original
          creation either never ran or was adopted above),
        - ALIVE records whose node never came back, or whose worker is no
          longer hosted there, get the normal restart FSM treatment."""
        await asyncio.sleep(max(1.0, self.cfg.health_check_period_s * 3))
        for rec in list(self.actors.values()):
            if rec.state in (PENDING_CREATION, RESTARTING):
                asyncio.get_running_loop().create_task(self._create_actor(rec))
            elif rec.state == ALIVE:
                info = self.nodes.get(rec.node_id)
                hosted = self._hosted.get(rec.node_id, {})
                if (info is None or not info.alive
                        or rec.actor_id.hex() not in hosted):
                    await self._reconstruct_actor(
                        rec, "worker lost during GCS failover")

    async def _health_loop(self):
        period = self.cfg.health_check_period_s
        timeout = period * self.cfg.health_check_failure_threshold
        while not self._stopping:
            await asyncio.sleep(period)
            now = time.time()
            for nid, info in list(self.nodes.items()):
                if info.alive and now - self.last_seen.get(nid, now) > timeout:
                    await self._on_node_death(nid, "health check timeout")
            # watchdog sweep: beacons whose owner stopped reporting, and
            # straggler candidates that crossed k x p95 since last report
            try:
                self.health.check(now)
                self._drain_health_events()
            except Exception:
                logger.exception("health watchdog sweep failed")

    async def _on_node_death(self, node_id: NodeID, reason: str):
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        self.available.pop(node_id, None)
        # drop the dead node's agent-pushed stats: the dashboard must not
        # export a frozen last sample forever
        self.kv.pop(("node_stats", node_id.binary()), None)
        # ...and its beacons: node death is already attributed; those
        # loops must not also fire as anonymous stalls
        self.health.forget_node(node_id.hex())
        # ...and its memory attribution: the store died with the node
        self.memory.forget_node(node_id.hex())
        # ...and prefix-directory entries whose exported page groups were
        # owned there: their primary copies died with the store, so a
        # lookup must miss (and the requester re-prefill) rather than
        # hand out a dangling ref.
        node_hex = node_id.hex()
        stale = [h for h, e in self.prefix_dir.items()
                 if e.get("owner_node") == node_hex]
        for h in stale:
            del self.prefix_dir[h]
        if stale:
            self.prefix_dir_stats["dropped"] += len(stale)
        logger.warning("node %s dead: %s", node_id.hex()[:8], reason)
        await self._publish("node", {"node_id": node_id, "alive": False})
        # Restart actors that lived there (ref: gcs_actor_manager.cc:1100).
        for rec in list(self.actors.values()):
            if rec.node_id == node_id and rec.state == ALIVE:
                await self._reconstruct_actor(rec, f"node died: {reason}")
        # Release placement-group bundles on the dead node; PGs with STRICT
        # placement become (partially) unplaced — reschedule best-effort.
        for pgid, pg in self.pgs.items():
            changed = False
            for b in pg["bundles"]:
                if b.get("node_id") == node_id:
                    b["node_id"] = None
                    changed = True
            if changed:
                self._wal("pgs", pgid, pg, strict=False)  # node-death path
                self._mark_dirty()
                await self._try_place_pg(pgid)

    # -------------------------------------------------------------- membership

    async def rpc_register_node(self, info: NodeInfo,
                                hosted: Optional[dict] = None) -> dict:
        self.nodes[info.node_id] = info
        self.available[info.node_id] = info.resources_total.copy()
        self.last_seen[info.node_id] = time.time()
        from ray_tpu_torch.devtools.chaos import note_peer
        note_peer(tuple(info.nodelet_addr), "nodelet")
        # A rejoining nodelet reports the actors it hosts; adopt them so a
        # restarted GCS doesn't double-create actors whose creation landed
        # after the last snapshot (ref: failover reconstruction).
        self._hosted[info.node_id] = hosted or {}
        for aid_hex, h in (hosted or {}).items():
            for rec in self.actors.values():
                if rec.actor_id.hex() == aid_hex and rec.state != ALIVE:
                    rec.state = ALIVE
                    rec.address = tuple(h["addr"])
                    rec.worker_id = h["worker_id"]
                    rec.node_id = info.node_id
                    await self._publish_actor(rec)
        await self._publish("node", {"node_id": info.node_id, "alive": True})
        return {"ok": True, "config": self.cfg.to_json()}

    async def rpc_heartbeat(self, node_id: NodeID, seqno: int,
                            available: ResourceSet,
                            pending_leases: int = 0,
                            infeasible: Optional[List[dict]] = None) -> dict:
        # ref: ray_syncer.h versioned snapshots — stale seqnos are dropped.
        if seqno >= self.heartbeat_seq.get(node_id, -1):
            self.heartbeat_seq[node_id] = seqno
            if node_id in self.nodes:
                self.available[node_id] = available
                self.pending_leases[node_id] = pending_leases
        if infeasible is not None:
            # permanently-infeasible lease asks the nodelet queued (no
            # node fits, no spillback target): replace this nodelet's
            # prior rows so the autoscaler sees current state, not a
            # history (ref: infeasible queue -> autoscaler state)
            src = f"nodelet:{node_id.hex()}"
            self.unmet_demand = [d for d in self.unmet_demand
                                 if d.get("source") != src]
            for row in infeasible:
                self.unmet_demand.append({
                    "resources": dict(row.get("resources") or {}),
                    "ts": float(row.get("ts", time.time())),
                    "source": src})
            del self.unmet_demand[:-100]
        self.last_seen[node_id] = time.time()
        if node_id not in self.nodes:
            # Fresh GCS after restart: membership is rebuilt from the
            # still-running nodelets (ref: clients resubscribe/re-register
            # after GCS failover, _raylet.pyx _auto_reconnect).
            return {"ok": False, "reregister": True}
        info = self.nodes.get(node_id)
        if info is not None and not info.alive:
            # Node came back (e.g. transient stall) — reference treats this as
            # a new node; we resurrect membership.
            info.alive = True
            await self._publish("node", {"node_id": node_id, "alive": True})
        return {"ok": True}

    async def rpc_drain_node(self, node_id: NodeID) -> dict:
        await self._on_node_death(node_id, "drained")
        return {"ok": True}

    async def rpc_get_nodes(self) -> List[NodeInfo]:
        return list(self.nodes.values())

    async def rpc_get_available_resources(self) -> Dict[bytes, Dict[str, float]]:
        return {nid.binary(): rs.quantities for nid, rs in self.available.items()}

    async def rpc_get_load(self) -> dict:
        """Cluster load for the autoscaler (ref: LoadMetrics
        load_metrics.py:63 fed from GCS resource state)."""
        now = time.time()
        # a miss counts for 30 s, or until an ask of its shape was placed
        # after it (unlike the reference, whose met asks stay demand for
        # their 30 s and relaunch a node the autoscaler just scaled down);
        # placement-group rows are cleared by the pg itself
        met = self._demand_met
        demand = [d for d in self.unmet_demand if now - d["ts"] < 30.0
                  and ("pg" in d or d["ts"] > met.get(
                      _shape(d["resources"]), float("-inf")))]
        # gang shortfalls (elastic training): one row per missing worker,
        # tagged with the gang so the autoscaler can attribute the launch
        for reporter, g in list(self.gang_demand.items()):
            if now - g["ts"] >= 30.0:
                del self.gang_demand[reporter]
                continue
            demand.extend({"resources": dict(g["resources"]), "ts": g["ts"],
                           "gang": g["name"]}
                          for _ in range(min(int(g["count"]), 16)))
        return {
            "pending_leases": {nid.hex(): n
                               for nid, n in self.pending_leases.items()},
            "unmet_demand": demand,
            "idle_nodes": [nid.hex() for nid, info in self.nodes.items()
                           if info.alive and self.available.get(nid) is not None
                           and self.available[nid].quantities ==
                           info.resources_total.quantities],
        }

    async def rpc_report_gang_demand(self, name: str, reporter: str,
                                     resources: Dict[str, float],
                                     count: int,
                                     seq: Optional[int] = None) -> dict:
        """An elastic gang (ray_tpu_torch.train.elastic) is `count` workers
        short of its target. Reporter-keyed with a timestamp — the same
        idempotent, staleness-aged shape the serve controller's
        report_load uses — so re-reports replace rather than accumulate,
        count=0 clears, and a dead coordinator's row ages out.

        ``seq`` is the reporter's monotonic sequence number: a delayed
        or duplicated stale report (reordered under partition, or
        chaos-injected) must not overwrite — or resurrect after a
        count=0 clear — a newer row. seq=None keeps the old
        last-writer-wins semantics for legacy reporters."""
        if seq is not None:
            last = self._gang_demand_seq.get(reporter, -1)
            if seq <= last:
                return {"ok": True, "stale": True}
            self._gang_demand_seq[reporter] = seq
        if count <= 0:
            self.gang_demand.pop(reporter, None)
        else:
            self.gang_demand[reporter] = {
                "name": name, "resources": dict(resources),
                "count": int(count), "ts": time.time()}
        return {"ok": True}

    async def rpc_report_remediation(self, event: dict) -> dict:
        """An elastic coordinator reports a remediation action (shrink,
        refill, grow, degraded start). Folded into the health event
        stream: timeline instant + log line via _drain_health_events,
        visible in health_report()/`cli doctor`."""
        self.health.observe_remediation(dict(event))
        self._drain_health_events()
        return {"ok": True}

    # ------------------------------------------------------------- scheduling

    async def rpc_pick_node(self, resources: ResourceSet, strategy_kind: str = "DEFAULT",
                            exclude: Optional[list] = None) -> Optional[dict]:
        """Spillback target selection (ref: ClusterResourceScheduler::
        GetBestSchedulableNode, cluster_resource_scheduler.cc:129).

        Delegates to the standalone policy suite (scheduling_policy.py):
        DEFAULT -> HybridPolicy (truncated critical-utilization score,
        top-k pick), SPREAD -> round-robin over available nodes."""
        exclude_set = set(exclude) if exclude else set()
        snapshot = [
            SchedNode(node_id=nid, total=info.resources_total,
                      available=self.available.get(nid, ResourceSet()),
                      alive=info.alive)
            for nid, info in self.nodes.items() if nid not in exclude_set]
        if strategy_kind == "SPREAD":
            nid = self._spread_policy.schedule(resources, snapshot)
        else:
            nid = self._hybrid_policy.schedule(resources, snapshot)
        if nid is None:
            # record unmet demand for the autoscaler
            # (ref: infeasible queue -> gcs_autoscaler_state_manager.h)
            self.unmet_demand.append({"resources": resources.quantities,
                                      "ts": time.time()})
            del self.unmet_demand[:-100]
            return None
        # an ask of this shape now fits: get_load drops its misses
        # recorded until now (a still-waiting ask of the same shape
        # records itself again at its next retry)
        self._demand_met[_shape(resources.quantities)] = time.time()
        return {"node_id": nid, "addr": self.nodes[nid].nodelet_addr}

    # ------------------------------------------------------------------ actors

    async def rpc_register_actor(self, spec: TaskSpec) -> dict:
        """ref: gcs_actor_manager.cc:246 RegisterActor. Idempotent: clients
        retry across GCS restarts (gcs_call auto-reconnect), so a replayed
        registration of an already-known actor_id must succeed without
        double-creating."""
        if spec.actor_id in self.actors:
            return {"ok": True}
        if spec.actor_name:
            key = (spec.namespace, spec.actor_name)
            if key in self.named_actors and self.named_actors[key] != spec.actor_id:
                existing = self.actors[self.named_actors[key]]
                if existing.state != DEAD:
                    return {"ok": False, "error": f"actor name {key} taken"}
            self.named_actors[key] = spec.actor_id
            self._wal("named_actors", key, spec.actor_id)
        rec = ActorRecord(spec)
        self.actors[spec.actor_id] = rec
        # Write-through: registration must survive an immediate GCS crash
        # (ref: Redis-backed GcsTableStorage persists before the reply) —
        # one WAL record, not a whole-state snapshot per registration.
        self._wal("actors", spec.actor_id, rec)
        asyncio.get_running_loop().create_task(self._create_actor(rec))
        return {"ok": True}

    async def _create_actor(self, rec: ActorRecord):
        """Lease a worker somewhere and push the creation task
        (ref: gcs_actor_scheduler.h lease-based actor scheduling)."""
        spec = rec.spec
        deadline = time.time() + self.cfg.worker_lease_timeout_s * 10
        # Stable per-incarnation idempotency token: every retry of THIS
        # creation attempt (e.g. after a dropped response) carries the
        # same token, so the nodelet replays the recorded placement
        # instead of leasing a second worker and running __init__ twice.
        # A restart bumps num_restarts and legitimately creates anew.
        idem = f"{rec.actor_id.hex()}:{rec.num_restarts}"
        while not self._stopping:
            target = await self._pick_for_spec(spec)
            if target is None:
                if time.time() > deadline:
                    rec.state = DEAD
                    rec.death_cause = "no feasible node for actor resources"
                    await self._publish_actor(rec)
                    return
                await asyncio.sleep(0.2)
                continue
            nid = target["node_id"]
            client = self.pool.get(tuple(target["addr"]))
            try:
                # Creation waits on a worker lease + __init__, so it gets
                # its own bound rather than the default rpc deadline.
                r = await client.call(
                    "create_actor", spec=spec, idem=idem,
                    timeout=self.cfg.worker_start_timeout_s
                    + self.cfg.worker_lease_timeout_s + 10.0)
            except (ConnectionLost, RemoteError, OSError) as e:
                logger.warning("actor create on %s failed: %s", nid.hex()[:8], e)
                await asyncio.sleep(0.2)
                continue
            if not r.get("ok"):
                if r.get("retryable", True):
                    await asyncio.sleep(0.2)
                    continue
                rec.state = DEAD
                rec.death_cause = r.get("error", "creation failed")
                await self._publish_actor(rec)
                return
            rec.state = ALIVE
            rec.address = tuple(r["worker_addr"])
            rec.worker_id = r["worker_id"]
            rec.node_id = nid
            await self._publish_actor(rec)
            return

    async def _pick_for_spec(self, spec: TaskSpec) -> Optional[dict]:
        if spec.scheduling.kind == "PLACEMENT_GROUP":
            pg = self.pgs.get(spec.scheduling.pg_id)
            if pg is None:
                return None
            idx = spec.scheduling.bundle_index
            bundles = pg["bundles"]
            cands = [bundles[idx]] if idx >= 0 else bundles
            for b in cands:
                if b.get("node_id") is not None:
                    info = self.nodes.get(b["node_id"])
                    if info and info.alive:
                        return {"node_id": b["node_id"], "addr": info.nodelet_addr}
            return None
        if spec.scheduling.kind == "NODE_AFFINITY":
            info = self.nodes.get(spec.scheduling.node_id)
            if info and info.alive:
                return {"node_id": info.node_id, "addr": info.nodelet_addr}
            if not spec.scheduling.soft:
                return None
        return await self.rpc_pick_node(resources=spec.resources,
                                        strategy_kind=spec.scheduling.kind)

    async def _reconstruct_actor(self, rec: ActorRecord, cause: str):
        """ref: gcs_actor_manager.cc:1100 ReconstructActor."""
        unlimited = rec.max_restarts < 0
        if not unlimited and rec.num_restarts >= rec.max_restarts:
            rec.state = DEAD
            rec.death_cause = cause
            await self._publish_actor(rec)
            return
        rec.num_restarts += 1
        rec.state = RESTARTING
        rec.address = None
        await self._publish_actor(rec)
        await self._create_actor(rec)

    async def rpc_report_worker_death(self, worker_id: bytes, node_id: NodeID,
                                      intentional: bool = False,
                                      reason: str = "worker died",
                                      actor_id=None) -> dict:
        # actor_id scopes the report to one lane of a lane-host worker
        # (the process survives, only that actor died)
        for rec in list(self.actors.values()):
            if rec.worker_id == worker_id and rec.state == ALIVE and (
                    actor_id is None or rec.actor_id == actor_id):
                if intentional:
                    rec.state = DEAD
                    rec.death_cause = reason
                    await self._publish_actor(rec)
                else:
                    await self._reconstruct_actor(rec, reason)
        return {"ok": True}

    async def rpc_kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> dict:
        rec = self.actors.get(actor_id)
        if rec is None:
            return {"ok": False, "error": "no such actor"}
        if no_restart:
            rec.max_restarts = rec.num_restarts  # exhaust budget
        if rec.address is not None and rec.node_id in self.nodes:
            client = self.pool.get(self.nodes[rec.node_id].nodelet_addr)
            try:
                # actor_id lets a lane-host nodelet kill ONLY this lane
                await client.call("kill_worker", worker_id=rec.worker_id,
                                  actor_id=actor_id, reason="ray_tpu_torch.kill",
                                  timeout=10.0)
            except (ConnectionLost, RemoteError, OSError):
                pass
        if no_restart:
            rec.state = DEAD
            rec.death_cause = "killed via ray_tpu_torch.kill"
            await self._publish_actor(rec)
        return {"ok": True}

    async def rpc_get_actor(self, actor_id: ActorID) -> Optional[dict]:
        rec = self.actors.get(actor_id)
        return rec.view() if rec else None

    async def rpc_get_named_actor(self, name: str, namespace: str = "default") -> Optional[dict]:
        aid = self.named_actors.get((namespace, name))
        if aid is None:
            return None
        rec = self.actors.get(aid)
        if rec is None or rec.state == DEAD:
            return None
        return {"spec": rec.spec, "view": rec.view()}

    async def rpc_list_actors(self) -> List[dict]:
        return [r.view() for r in self.actors.values()]

    async def rpc_wait_actor_alive(self, actor_id: ActorID, wait_timeout: float = 30.0) -> dict:
        deadline = time.time() + wait_timeout
        while time.time() < deadline:
            rec = self.actors.get(actor_id)
            if rec is not None and rec.state == ALIVE:
                return {"ok": True, "view": rec.view()}
            if rec is not None and rec.state == DEAD:
                return {"ok": False, "view": rec.view()}
            await asyncio.sleep(0.05)
        # timed out: return the current view so callers can tell a
        # still-starting actor (keep waiting) from an unknown id (fail)
        rec = self.actors.get(actor_id)
        return {"ok": False, "view": rec.view() if rec is not None else None}

    async def _publish_actor(self, rec: ActorRecord):
        await self._publish(f"actor:{rec.actor_id.hex()}", rec.view())
        # every FSM transition; no RPC caller to fail -> non-strict
        self._wal("actors", rec.actor_id, rec, strict=False)
        self._mark_dirty()

    # -------------------------------------------------------- placement groups

    async def rpc_create_placement_group(self, pg_id: PlacementGroupID,
                                         bundles: List[ResourceSet],
                                         strategy: str = "PACK",
                                         name: str = "") -> dict:
        """2-phase reservation across nodelets
        (ref: gcs_placement_group_scheduler.h PREPARE/COMMIT)."""
        self.pgs[pg_id] = {
            "pg_id": pg_id,
            "bundles": [{"resources": b, "node_id": None, "index": i}
                        for i, b in enumerate(bundles)],
            "strategy": strategy,
            "name": name,
            "state": "PENDING",
        }
        ok = await self._try_place_pg(pg_id)
        self._wal("pgs", pg_id, self.pgs.get(pg_id))
        self._mark_dirty()
        return {"ok": ok, "state": self.pgs[pg_id]["state"]}

    def _record_pg_demand(self, pg_id: PlacementGroupID,
                          unplaced: List[dict]) -> None:
        """A PENDING placement group is unmet demand too (ref: the
        autoscaler counts pending PG bundles, resource_demand_scheduler):
        one row per unplaced bundle, replacing this pg's prior rows so
        retries don't accumulate."""
        tag = pg_id.hex()
        now = time.time()
        self.unmet_demand = [d for d in self.unmet_demand
                             if d.get("pg") != tag]
        for b in unplaced:
            res = b["resources"]
            self.unmet_demand.append({
                "resources": dict(getattr(res, "quantities", res)),
                "ts": now, "pg": tag})
        del self.unmet_demand[:-100]

    def _clear_pg_demand(self, pg_id: PlacementGroupID) -> None:
        tag = pg_id.hex()
        self.unmet_demand = [d for d in self.unmet_demand
                             if d.get("pg") != tag]

    async def _try_place_pg(self, pg_id: PlacementGroupID) -> bool:
        pg = self.pgs[pg_id]
        strategy = pg["strategy"]
        unplaced = [b for b in pg["bundles"] if b["node_id"] is None]
        if not unplaced:
            pg["state"] = "CREATED"
            self._clear_pg_demand(pg_id)
            self._wal("pgs", pg_id, pg)
            self._mark_dirty()
            return True
        # Phase 0: plan via the standalone bundle-packing policy
        # (ref: bundle_scheduling_policy.cc), honoring bundles already
        # placed by a previous partial attempt / node-failure replacement.
        placed_on_by_strict = set(
            b["node_id"] for b in pg["bundles"] if b["node_id"] is not None)
        snapshot = [
            SchedNode(node_id=nid, total=info.resources_total,
                      available=self.available.get(nid, ResourceSet()),
                      alive=info.alive)
            for nid, info in self.nodes.items()]
        if strategy == "STRICT_PACK" and placed_on_by_strict:
            # the gang already lives on one node; the rest must join it
            snapshot = [n for n in snapshot
                        if n.node_id in placed_on_by_strict]
        exclude = placed_on_by_strict if strategy == "STRICT_SPREAD" \
            else None
        assignment = pack_bundles([b["resources"] for b in unplaced],
                                  snapshot, strategy,
                                  exclude_nodes=exclude)
        if assignment is None:
            pg["state"] = "PENDING"
            self._record_pg_demand(pg_id, unplaced)
            return False
        plan: List[Tuple[dict, NodeID]] = list(zip(unplaced, assignment))
        # Phase 1: PREPARE on each nodelet.
        prepared: List[Tuple[dict, NodeID]] = []
        for b, nid in plan:
            client = self.pool.get(self.nodes[nid].nodelet_addr)
            try:
                # tight bound: a gray nodelet must not stall the 2PC
                # prepare loop for the default deadline per bundle
                r = await client.call("pg_prepare", pg_id=pg_id, bundle_index=b["index"],
                                      resources=b["resources"], timeout=10.0)
            except (ConnectionLost, RemoteError, OSError):
                r = {"ok": False}
            if not r.get("ok"):
                for pb, pnid in prepared:  # rollback
                    try:
                        await self.pool.get(self.nodes[pnid].nodelet_addr).call(
                            "pg_return", pg_id=pg_id, bundle_index=pb["index"],
                            timeout=10.0)
                    except Exception:
                        pass
                pg["state"] = "PENDING"
                self._record_pg_demand(pg_id, unplaced)
                return False
            prepared.append((b, nid))
        # Phase 2: COMMIT.
        for b, nid in prepared:
            try:
                await self.pool.get(self.nodes[nid].nodelet_addr).call(
                    "pg_commit", pg_id=pg_id, bundle_index=b["index"],
                    timeout=10.0)
            except (ConnectionLost, RemoteError, OSError):
                pass
            b["node_id"] = nid
        pg["state"] = "CREATED"
        self._clear_pg_demand(pg_id)
        # placement succeeded through PREPARE/COMMIT: the bundle->node
        # assignments are now reservations held by nodelets and MUST
        # survive a GCS crash, or restore would double-reserve elsewhere
        self._wal("pgs", pg_id, pg, strict=False)
        self._mark_dirty()
        await self._publish(f"pg:{pg_id.hex()}", {"state": "CREATED"})
        return True

    async def rpc_remove_placement_group(self, pg_id: PlacementGroupID) -> dict:
        pg = self.pgs.pop(pg_id, None)
        self._clear_pg_demand(pg_id)
        if pg is None:
            return {"ok": False}
        self._wal("pgs", pg_id, None)
        self._mark_dirty()
        for b in pg["bundles"]:
            nid = b.get("node_id")
            if nid is not None and nid in self.nodes:
                try:
                    await self.pool.get(self.nodes[nid].nodelet_addr).call(
                        "pg_return", pg_id=pg_id, bundle_index=b["index"],
                        timeout=10.0)
                except Exception:
                    pass
        return {"ok": True}

    async def rpc_get_placement_group(self, pg_id: PlacementGroupID) -> Optional[dict]:
        pg = self.pgs.get(pg_id)
        if pg is None:
            return None
        return {"pg_id": pg_id, "state": pg["state"], "strategy": pg["strategy"],
                "name": pg["name"],
                "bundles": [{"index": b["index"], "node_id": b["node_id"],
                             "resources": b["resources"].quantities}
                            for b in pg["bundles"]]}

    async def rpc_list_placement_groups(self) -> List[dict]:
        """All placement groups in rpc_get_placement_group's view shape
        (ref: GcsPlacementGroupManager::HandleGetAllPlacementGroup)."""
        return [{"pg_id": pg_id, "state": pg["state"],
                 "strategy": pg["strategy"], "name": pg["name"],
                 "bundles": [{"index": b["index"], "node_id": b["node_id"],
                              "resources": b["resources"].quantities}
                             for b in pg["bundles"]]}
                for pg_id, pg in self.pgs.items()]

    async def rpc_wait_placement_group(self, pg_id: PlacementGroupID,
                                       wait_timeout: float = 30.0) -> dict:
        deadline = time.time() + wait_timeout
        while time.time() < deadline:
            pg = self.pgs.get(pg_id)
            if pg is None:
                return {"ok": False, "error": "removed"}
            if pg["state"] == "CREATED":
                return {"ok": True}
            await self._try_place_pg(pg_id)
            if self.pgs[pg_id]["state"] == "CREATED":
                return {"ok": True}
            await asyncio.sleep(0.2)
        return {"ok": False, "error": "timeout"}

    # ---------------------------------------------------------------- jobs/kv

    async def rpc_add_job(self, job_id: JobID, driver_addr: Address, meta: dict) -> dict:
        self.jobs[job_id] = {"job_id": job_id, "driver": driver_addr,
                             "meta": meta, "start": time.time(), "end": None}
        self._wal("jobs", job_id, self.jobs[job_id])
        self._mark_dirty()
        return {"ok": True}

    async def rpc_finish_job(self, job_id: JobID) -> dict:
        if job_id in self.jobs:
            self.jobs[job_id]["end"] = time.time()
            self._wal("jobs", job_id, self.jobs[job_id])
            self._mark_dirty()
        return {"ok": True}

    async def rpc_list_jobs(self) -> List[dict]:
        return list(self.jobs.values())

    async def rpc_kv_put(self, ns: str, key: bytes, value: bytes,
                         overwrite: bool = True) -> bool:
        k = (ns, key)
        if not overwrite and k in self.kv:
            # Idempotent for client retries across GCS restarts: replaying
            # the same first-write succeeds; a genuine conflict still fails.
            return self.kv[k] == value
        self.kv[k] = value
        self._wal("kv", k, value)
        self._mark_dirty()
        return True

    async def rpc_kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        return self.kv.get((ns, key))

    async def rpc_kv_del(self, ns: str, key: bytes) -> bool:
        existed = self.kv.pop((ns, key), None) is not None
        if existed:
            self._wal("kv", (ns, key), None)
            self._mark_dirty()
        return existed

    async def rpc_kv_exists(self, ns: str, key: bytes) -> bool:
        return (ns, key) in self.kv

    async def rpc_kv_keys(self, ns: str, prefix: bytes = b"") -> List[bytes]:
        return [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]

    # ------------------------------------------------------------- task events

    async def rpc_add_task_events(self, events: List[dict]) -> dict:
        # ref: gcs_task_manager.h bounded task-event store for observability.
        self.task_events.extend(events)
        for ev in events:
            self.health.observe_task_event(ev)
        return {"ok": True}

    async def rpc_telemetry_report(self, report: dict) -> dict:
        """One batched report from a process's TelemetryAgent (ref:
        metrics_agent.py push): task events + spans extend the bounded
        event store, metric deltas merge into KV ns="metrics" (WAL'd like
        kv_put so scrapers survive failover), edge observations feed the
        EWMA edge model, and beacon snapshots feed the stall watchdog.
        The reply names the reporter's own stalled components so the
        stalled process can dump its flight recorder within one report
        interval of detection."""
        import json

        from ray_tpu_torch.util.metrics import merge_payload

        events = report.get("events") or []
        if events:
            self.task_events.extend(events)
            for ev in events:
                self.health.observe_task_event(ev)
        stalled: List[str] = []
        beacons = report.get("beacons")
        if beacons:
            stalled = self.health.update(str(report.get("worker", "?")),
                                         report.get("node"), beacons)
            self._drain_health_events()
        mem = report.get("memory")
        if mem:
            self.memory.update(str(report.get("worker", "?")),
                               report.get("node"), mem)
        susp = report.get("rpc_suspicions")
        if susp:
            # rpc-deadline misses reported by callers: folded into
            # peer-suspicion health events (gray-failure evidence)
            self.health.observe_rpc_suspicions(
                str(report.get("worker", "?")), report.get("node"), susp)
            self._drain_health_events()
        for ob in report.get("edges") or []:
            self.edge_model.observe(ob.get("src"), ob.get("dst"),
                                    ob.get("nbytes", 0.0),
                                    ob.get("seconds", 0.0),
                                    ob.get("kind", "transfer"))
        dirty = False
        for delta in report.get("metrics") or []:
            name = delta.get("name")
            if not name:
                continue
            k = ("metrics", name.encode())
            try:
                base = json.loads(self.kv[k]) if k in self.kv else None
            except Exception:
                base = None
            value = json.dumps(merge_payload(base, delta)).encode()
            self.kv[k] = value
            self._wal("kv", k, value)
            dirty = True
        if dirty:
            self._mark_dirty()
        return {"ok": True, "stalled": stalled}

    def _drain_health_events(self) -> None:
        """New StallEvents become log lines + timeline instants, exactly
        once each (instants render in chrome_trace as 'i' markers on a
        per-worker health track)."""
        for ev in self.health.drain_fresh():
            logger.warning("health: %s %s worker=%s age=%.1fs context=%s",
                           ev.get("kind"), ev.get("component"),
                           ev.get("worker"), ev.get("age_s", 0.0),
                           ev.get("context"))
            self.task_events.append({
                "kind": "instant",
                "name": f"{ev.get('kind')}::{ev.get('component')}",
                "ts": ev.get("ts"), "worker": ev.get("worker"),
                "component": ev.get("component"),
                "age_s": ev.get("age_s"), "context": ev.get("context"),
            })

    async def rpc_health_report(self) -> dict:
        """The state-API / `cli doctor` view: every known beacon with
        its freshness, recent stall/straggler events, and the telemetry
        drop counters."""
        import json as _json

        rep = self.health.report()
        drops = {}
        for name in ("ray_tpu_task_events_dropped",
                     "ray_tpu_telemetry_reports_dropped"):
            raw = self.kv.get(("metrics", name.encode()))
            total = 0.0
            if raw:
                try:
                    payload = _json.loads(raw)
                    total = sum(s.get("value", 0.0)
                                for s in payload.get("series", []))
                except Exception:
                    total = 0.0
            drops[name] = total
        rep["drop_counters"] = drops
        rep["nodes_alive"] = sum(1 for n in self.nodes.values() if n.alive)
        rep["nodes_dead"] = sum(1 for n in self.nodes.values() if not n.alive)
        return rep

    async def rpc_memory_report(self, top_n: int = 20) -> dict:
        """Cluster memory attribution view (observability/memory.py):
        worker tracker snapshots folded by the aggregator, joined with
        the per-node store occupancy the nodelet agents push to KV
        ns="node_stats" — which also carries each nodelet's own tracker
        payload (primary-pin records), folded here on read."""
        import json as _json

        node_stats: Dict[str, dict] = {}
        for (ns, key) in list(self.kv):
            if ns != "node_stats":
                continue
            try:
                st = _json.loads(self.kv[(ns, key)])
            except Exception:
                continue
            node_hex = key.hex()
            node_stats[node_hex] = st
            mem = st.get("memory")
            if mem:
                self.memory.update(f"nodelet:{node_hex[:12]}", node_hex, mem)
        return self.memory.report(node_stats, top_n=top_n)

    # ------------------------------------------- global KV-prefix directory

    async def rpc_prefix_register(self, entries: List[dict]) -> dict:
        """serve/disagg: a prefill replica registers exported page-group
        objects, keyed by the group-boundary page-chain hash. Entry:
        {"hash", "ref", "owner", "owner_node", "nbytes", "group_tokens"}.
        First-writer-wins across owners (same rule as PagePool.register)
        so concurrent prefills of a shared prefix converge on one copy;
        a re-register by the incumbent owner refreshes its entry."""
        now = time.time()
        for e in entries:
            h = e["hash"]
            cur = self.prefix_dir.pop(h, None)
            if cur is not None and cur.get("owner") != e.get("owner"):
                e = cur   # keep the incumbent's ref, just refresh LRU
            e["last_touch"] = now
            self.prefix_dir[h] = e
            self.prefix_dir_stats["registered"] += 1
        cap = max(int(getattr(self.cfg, "gcs_prefix_dir_capacity", 4096)), 1)
        while len(self.prefix_dir) > cap:
            self.prefix_dir.popitem(last=False)
            self.prefix_dir_stats["evicted"] += 1
        return {"size": len(self.prefix_dir)}

    async def rpc_prefix_lookup(self, hashes: List[bytes]) -> List[Optional[dict]]:
        """Resolve the longest warm leading run of page groups: one entry
        (or None) per group-boundary hash, in order, stopping at the
        first miss — a group is only adoptable if every group before it
        is too (chain hashes encode position, not just content)."""
        now = time.time()
        out: List[Optional[dict]] = []
        miss = False
        for h in hashes:
            e = None if miss else self.prefix_dir.get(h)
            if e is None:
                miss = True
                self.prefix_dir_stats["misses"] += 1
                out.append(None)
            else:
                e["last_touch"] = now
                self.prefix_dir.move_to_end(h)
                self.prefix_dir_stats["hits"] += 1
                out.append(dict(e))
        return out

    async def rpc_prefix_drop(self, hashes: List[bytes],
                              owner: str = "") -> int:
        """A prefill replica evicted retained groups locally (or is
        draining): its directory entries must go too, or lookups hand
        out refs whose primaries are about to be unpinned. With owner
        set, only that owner's entries drop (a different owner may have
        re-registered the hash since)."""
        n = 0
        for h in hashes:
            e = self.prefix_dir.get(h)
            if e is None:
                continue
            if owner and e.get("owner") != owner:
                continue
            del self.prefix_dir[h]
            n += 1
        if n:
            self.prefix_dir_stats["dropped"] += n
        return n

    async def rpc_prefix_stats(self) -> dict:
        st = dict(self.prefix_dir_stats)
        st["size"] = len(self.prefix_dir)
        st["capacity"] = int(getattr(self.cfg, "gcs_prefix_dir_capacity",
                                     4096))
        return st

    async def rpc_edge_stats(self) -> Dict[str, dict]:
        return self.edge_model.stats()

    async def rpc_list_task_events(self, limit: int = 1000,
                                   job_id: Optional[JobID] = None) -> List[dict]:
        out = []
        for ev in reversed(self.task_events):
            if job_id is not None and ev.get("job_id") != job_id:
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        return out

    # ----------------------------------------------------------------- pubsub

    async def rpc_subscribe(self, channel: str, addr: Address) -> dict:
        self.subscribers[channel].add(tuple(addr))
        self._wal("subscribers", channel, self.subscribers[channel])
        self._mark_dirty()
        return {"ok": True}

    async def rpc_unsubscribe(self, channel: str, addr: Address) -> dict:
        self.subscribers[channel].discard(tuple(addr))
        self._wal("subscribers", channel, self.subscribers[channel])
        self._mark_dirty()
        return {"ok": True}

    async def rpc_publish(self, channel: str, message: Any) -> dict:
        await self._publish(channel, message)
        return {"ok": True}

    async def _publish(self, channel: str, message: Any):
        dead = []
        # snapshot: subscribe/unsubscribe coroutines can mutate the set
        # while the oneway push awaits ("Set changed size during
        # iteration" otherwise)
        for addr in tuple(self.subscribers.get(channel, ())):  # push model
            try:
                await self.pool.get(addr).oneway("pubsub_message",
                                                channel=channel, message=message)
            except (ConnectionLost, OSError):
                dead.append(addr)
        for addr in dead:
            self.subscribers[channel].discard(addr)
            self.pool.drop(addr)

    # ------------------------------------------------------------ persistence

    def _snapshot_path(self) -> Optional[str]:
        if self.cfg.gcs_storage == "file" and self.cfg.gcs_file_storage_path:
            return os.path.join(self.cfg.gcs_file_storage_path, "gcs_snapshot.pkl")
        return None

    def _mark_dirty(self):
        self._dirty = True

    def _wal(self, table: str, key, value, strict: bool = True):
        """Durably log one mutation BEFORE the RPC reply (value=None is a
        delete). Restore = snapshot + replay; see gcs_storage.py.

        strict=True (mutation RPC handlers): an append failure raises, so
        the RPC FAILS instead of acking a write that won't survive a crash
        (ref: the Redis-backed table storage fails the request when the
        store write fails). strict=False (background FSM transitions with
        no caller to fail): log and continue — in-memory state stays
        authoritative until the disk recovers."""
        try:
            self.storage.append(pickle.dumps((table, key, value),
                                             protocol=4))
        except Exception:
            logger.exception("gcs wal append failed (table=%s)", table)
            if strict:
                raise RuntimeError(
                    "GCS storage append failed; write not durable") from None

    async def _snapshot_loop(self):
        """Debounced persistence: at most one snapshot per period
        (ref: Redis-backed GcsTableStorage writes per-mutation; a periodic
        whole-state snapshot gives the same restart guarantee here)."""
        while not self._stopping:
            await asyncio.sleep(0.5)
            if self._dirty:
                self._dirty = False
                await self._snapshot_async()

    def _snapshot_bytes(self) -> bytes:
        return pickle.dumps({"kv": self.kv, "named_actors": self.named_actors,
                             "jobs": self.jobs, "actors": self.actors,
                             "pgs": self.pgs,
                             "subscribers": dict(self.subscribers)})

    async def _snapshot_async(self):
        """Pickle on the loop (consistent state view; the WAL rotates at
        the same instant, so snapshot+newer-segments is always complete),
        write off-loop so heartbeats/leases aren't blocked on disk."""
        path = self._snapshot_path()
        if not path:
            return
        try:
            data = self._snapshot_bytes()
            watermark = self.storage.rotate()
            await asyncio.to_thread(self.storage.commit_snapshot, data,
                                    watermark)
        except Exception:
            logger.exception("gcs snapshot failed")

    def _maybe_restore(self):
        try:
            snap, records = self.storage.restore()
        except Exception:
            logger.exception("gcs restore failed")
            return
        if snap is not None:
            try:
                data = pickle.loads(snap)
                self.kv = data.get("kv", {})
                self.named_actors = data.get("named_actors", {})
                self.jobs = data.get("jobs", {})
                self.actors = data.get("actors", {})
                self.pgs = data.get("pgs", {})
                for ch, addrs in data.get("subscribers", {}).items():
                    self.subscribers[ch] |= set(addrs)
            except Exception:
                logger.exception("gcs snapshot restore failed")
        replayed = 0
        for raw in records:
            try:
                table, key, value = pickle.loads(raw)
            except Exception:
                continue
            if table == "subscribers":
                if value is None:
                    self.subscribers.pop(key, None)
                else:
                    self.subscribers[key] = set(value)
                replayed += 1
                continue
            tab = getattr(self, table, None)
            if not isinstance(tab, dict):
                continue
            if value is None:
                tab.pop(key, None)
            else:
                tab[key] = value
            replayed += 1
        if snap is not None or replayed:
            logger.info(
                "gcs restored %d kv entries, %d actors, %d pgs "
                "(+%d WAL records)", len(self.kv), len(self.actors),
                len(self.pgs), replayed)

    async def rpc_ping(self) -> dict:
        return {"ok": True, "time": time.time()}

    async def rpc_shutdown(self) -> dict:
        self._stopping = True
        try:
            self.storage.close()   # final fsync of the live WAL segment
        except Exception:
            pass
        asyncio.get_running_loop().call_later(0.05, _exit_soon)
        return {"ok": True}


def _exit_soon():
    os._exit(0)


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--config", default="{}")
    parser.add_argument("--ready-fd", type=int, default=-1)
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[gcs] %(asctime)s %(levelname)s %(message)s")
    cfg = Config.from_json(args.config)

    async def run():
        gcs = GcsServer(cfg)
        host, port = await gcs.start(args.host, args.port)
        if args.ready_fd >= 0:
            os.write(args.ready_fd, f"{host}:{port}\n".encode())
            os.close(args.ready_fd)
        logger.info("gcs listening on %s:%d", host, port)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(run())


if __name__ == "__main__":
    main()
