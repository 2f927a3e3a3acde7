"""Runtime configuration flags.

Reference: src/ray/common/ray_config_def.h:18 — a single macro table of
RAY_CONFIG(type, name, default) entries, overridable via RAY_<NAME> env vars
or a serialized system-config dict handed down from `init()`. We reproduce
the same three-layer precedence (default < env RAY_TPU_<NAME> < explicit
_system_config) with a plain dataclass-of-record table.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict


@dataclass
class Config:
    # --- object store -------------------------------------------------------
    object_store_memory: int = 2 * 1024**3       # host shm tier bytes
    object_store_max_objects: int = 1 << 15
    # Objects <= this many bytes take the in-process memory-store path and are
    # inlined into task replies (ref: RayConfig max_direct_call_object_size).
    max_direct_call_object_size: int = 100 * 1024
    object_transfer_chunk_bytes: int = 8 * 1024**2  # ref: 64MiB gRPC chunks; we
                                                    # default smaller for 1-host
    # Native zero-staging transfer plane (native/xfer.cc); off -> always
    # use the portable chunk-RPC pull path.
    native_transfer_enabled: bool = True
    # Max concurrent outbound serves PER OBJECT per node (0 = unlimited;
    # pulls of distinct objects always multiplex freely). Over-cap
    # pullers get "busy" and retry against whichever holders have
    # registered copies by then — a fan-in broadcast of one hot object
    # cascades through peers instead of serializing behind one source
    # (ref: pull_manager.h:52 pulls spread across every holder).
    object_serve_concurrency: int = 2
    # kCreating store entries older than this are orphans of a dead
    # producer and get reaped. The transfer plane heartbeats the entry
    # per read() batch while bytes flow, and each read() is bounded by
    # the 120 s socket timeout — so a live pull's touch interval never
    # exceeds ~120 s and a stalled one aborts. MUST stay comfortably
    # above that 120 s bound or the reaper can free a buffer an active
    # (trickling) receive is still writing into.
    creating_orphan_age_s: float = 300.0
    # --- HBM device object tier (SURVEY §7 step 2; core/device_store.py) ----
    # put(torch.Tensor) keeps the tensor where it is; D2H happens only on
    # first remote need or on HBM pressure (spill chain HBM->shm->disk).
    device_object_tier: bool = True
    device_object_store_bytes: int = 2 * 1024**3
    # --- object spilling (ref: local_object_manager.h:41 + external_storage) -
    object_spill_enabled: bool = True
    object_spill_threshold: float = 0.8          # spill when usage crosses this
    object_spill_low_water: float = 0.5          # ...down to this fraction
    object_spill_dir: str = ""                   # default: <session>/spill
    # --- data streaming executor (ray_tpu_torch/data/execution/) ------------------
    # Share of object_store_memory the executor may hold in unconsumed
    # operator outputs (ResourceManager budget; split evenly across the
    # pipeline's budgetable operators). Also bounds the fused path's
    # generator byte backpressure.
    data_execution_budget_fraction: float = 0.25
    # Max concurrent tasks a single physical operator keeps in flight.
    data_execution_max_tasks_per_op: int = 4
    # --- scheduler / raylet -------------------------------------------------
    worker_lease_timeout_s: float = 30.0
    # -1 = auto: min(node CPU total, 2) workers spawn at node start (ref:
    # worker_pool.h prestart — the reference raylet prestarts num_cpus
    # python workers; a cold pool makes the first task waves pay worker
    # spawn + the lease-grant race serially)
    worker_pool_prestart: int = -1
    max_workers_per_node: int = 8
    # Fractional-CPU actors (0 < num_cpus < 1, no other resources) pack
    # into shared lane-host workers, this many per process — density
    # without a 0.5+ s interpreter spawn per actor (ref: the reference's
    # one-process-per-actor model tops out at worker-spawn rate; its 40k
    # actor benchmark uses num_cpus=0.001). 0 disables lane packing.
    # SEMANTIC TRADE: lane-packed actors share an interpreter, so
    # per-PROCESS state (module globals, class attributes) is shared
    # across them where the reference isolates it. Actor code needing
    # "which actor am I" must use get_runtime_context().get_actor_id()
    # (per lane thread), as util/collective does; actors needing real
    # process isolation should request num_cpus>=1.
    actor_lanes_per_worker: int = 16
    worker_idle_timeout_s: float = 300.0
    scheduler_spread_threshold: float = 0.5      # ref: RAY_scheduler_spread_threshold
    scheduler_top_k_fraction: float = 0.2        # ref: hybrid_scheduling_policy.h:29
    # --- OOM defense (ref: memory_monitor.h:52, ray_config_def.h:74) --------
    memory_monitor_refresh_ms: int = 0           # 0 disables (ref default 250)
    memory_usage_threshold: float = 0.95
    memory_monitor_kill_policy: str = "group_by_owner"  # | "retriable_fifo"
    memory_monitor_test_usage_file: str = ""     # tests: file with fake fraction
    # --- health / failure detection -----------------------------------------
    health_check_period_s: float = 1.0           # ref: ray_config_def.h:793-799
    health_check_timeout_s: float = 5.0
    health_check_failure_threshold: int = 5
    actor_max_restarts_default: int = 0
    task_max_retries_default: int = 3
    # --- gcs ----------------------------------------------------------------
    gcs_storage: str = "memory"                  # "memory" | "file" (ft restart)
    gcs_file_storage_path: str = ""
    # How long clients retry GCS calls across a restart (ref:
    # gcs_failover_worker_reconnect_timeout ray_config_def.h:62).
    gcs_reconnect_timeout_s: float = 30.0
    # --- timeouts -----------------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    # Default transport deadline for every control-plane RpcClient.call()
    # that does not pass its own: a gray-failed peer (black-holed link,
    # wedged handler) surfaces as a typed RpcTimeout instead of hanging
    # the caller forever. Long-running data-plane calls (push_task) opt
    # out with an explicit, lint-allowlisted timeout=None.
    rpc_call_timeout_s: float = 60.0
    # Application-level keepalive: each RpcClient pings its server every
    # interval; a connection that stays rx-silent past the timeout is
    # aborted, converting a black-holed link into ConnectionLost (TCP
    # alone buffers writes for minutes before noticing — the gray
    # failure mode of Huang et al. HotOS'17). 0 disables pinging.
    rpc_keepalive_interval_s: float = 5.0
    rpc_keepalive_timeout_s: float = 20.0
    # Serialized devtools.chaos.FaultPlan (JSON) — when non-empty, every
    # process in the session installs the same seeded fault-injection
    # interposer into its transport at startup (the plan inherits through
    # the spawned-process --config chain, so one plan governs the whole
    # cluster and one seed reproduces one fault sequence).
    chaos_plan: str = ""
    get_timeout_warn_s: float = 10.0
    # --- workers ------------------------------------------------------------
    worker_start_timeout_s: float = 60.0
    # A pump whose queue drained holds its lease parked for this grace
    # window before returning it; a task submitted within the window is
    # pushed straight to the already-leased worker — no acquire/return
    # RPC pair (ref: worker lease reuse / idle-worker keep-alive,
    # direct_task_transport.cc pipelining). Sequential submit->get loops
    # go from 3 RPCs/task to 1.
    lease_reuse_grace_s: float = 0.025
    # --- host collectives (ray_tpu_torch/collective/) -----------------------------
    # Per-hop blocks below this go as ONE inline mailbox message with no
    # chunking or sub-chunk pipelining — at small sizes the per-chunk
    # fixed costs (actor RPC + pickle) dominate and pipelining only
    # multiplies them (the eager tier).
    collective_eager_threshold_bytes: int = 64 * 1024
    # Chunks at or above this are put() into the object store once and
    # only the ObjectRef is mailed; the receiver resolves it via the
    # pinned zero-copy local read (the zero-copy tier). Must stay above
    # max_direct_call_object_size or the "store" copy is just an inline
    # blob riding the ref. 0 disables (everything rides the mailbox).
    collective_zerocopy_threshold_bytes: int = 256 * 1024
    # --- accelerator ----------------------------------------------------------
    # Logical accelerator resource name: one unit per local CUDA device
    # (node.py detect_gpus); num_gpus= on a task or actor requests it.
    chip_resource: str = "GPU"
    # --- LLM serving (ray_tpu_torch/serve/llm_router.py) --------------------------
    # Prompt tokens hashed for prefix-affinity routing: streams sharing at
    # least this many leading tokens rendezvous onto the same replica, so
    # its paged-KV prefix cache (llm.py PrefixCache) actually gets hits.
    llm_router_prefix_tokens: int = 32
    # Router-wide in-flight bound; admissions beyond it shed with
    # LLMQueueFull + Retry-After instead of queueing unboundedly.
    llm_router_max_inflight: int = 256
    # Affinity override point: when the prefix-preferred replica's
    # pressure exceeds overload_factor x the fleet mean, fall through to
    # the next replica in rendezvous order (cache locality is not worth
    # an unbounded hot spot).
    llm_router_overload_factor: float = 2.0
    # Background poll period for per-replica LLMServer.stats() feeding
    # the pressure score (busy-fraction EWMA).
    llm_router_stats_interval_s: float = 1.0
    # Drive the router->replica stream-frame hop through a compiled
    # two-node graph (dag/compiled.py standing channels) instead of
    # per-call handle_request_streaming.remote() dispatch; falls back to
    # the legacy path per replica on compile failure.
    llm_router_compiled_hop: bool = True
    # Scale-down grace: a draining replica is unpublished from routers
    # immediately, then given this long to finish in-flight streams
    # before the controller kills it.
    serve_drain_timeout_s: float = 10.0
    # --- model multiplexing (ray_tpu_torch/serve/multiplex.py) --------------------
    # Per-replica LRU bound on concurrently-loaded models; loading one
    # past the bound evicts the least-recently-used model through the
    # cache's unloader hook (engine teardown + page-pool release).
    serve_max_models_per_replica: int = 4
    # Weighted-fair tenant admission: JSON map of tenant -> weight, e.g.
    # '{"free": 1, "pro": 4}'. "" means every tenant weighs 1. A tenant
    # absent from the map gets weight 1. Shares of the router's
    # max_inflight are split by weight over the tenants active at
    # admission time; a tenant is always admitted up to its guaranteed
    # share and may borrow idle capacity up to the global cap. (A JSON
    # string, not a dict field: RAY_TPU_* env overrides parse by field
    # type and only bool/int/float/str survive that path.)
    serve_tenant_weights: str = ""
    # Per-model autoscaling target: desired mean per-model queue depth
    # per replica serving that model. The controller sizes each model's
    # replica set to ceil(model_load / this) within the deployment's
    # model_autoscaling_config bounds.
    serve_model_target_load: float = 2.0
    # --- disaggregated serving (ray_tpu_torch/serve/disagg.py) --------------------
    # Tokens per KV page for the handoff/prefix-directory hashing (the
    # sim granularity; the real engine hashes at its own page_size).
    serve_disagg_page_tokens: int = 16
    # Full KV pages per handoff chunk: the prefill replica put()s one
    # store object per GROUP of pages, so the prefill->decode envelope
    # carries O(prompt/group) refs instead of O(prompt/page).
    serve_disagg_group_pages: int = 4
    # Prefill-replica retention of directory-registered page groups
    # (local LRU): evicting one drops its global-directory entry too.
    # Retention past store capacity rides the nodelet spill tier.
    serve_disagg_retained_groups: int = 512
    # GCS global prefix directory LRU capacity (page-group entries).
    gcs_prefix_dir_capacity: int = 4096
    # --- observability ------------------------------------------------------
    task_event_buffer_size: int = 10000          # ref: task_event_buffer.h:199
    metrics_report_interval_s: float = 5.0       # nodelet node-stats agent
    # Per-process TelemetryAgent batching window: metric deltas, task
    # events, spans, and edge observations accumulate locally and ship in
    # ONE GCS report per interval (ref: metrics_agent.py batched push).
    telemetry_report_interval_s: float = 1.0
    # --- health plane (observability/health.py) -----------------------------
    # Flight recorder: bounded per-process ring of recent task events /
    # spans / channel-frame metadata, dumped to a post-mortem JSON under
    # flight_recorder_dir ("" -> <session root>/flight) on stall detection,
    # uncaught worker exception, or CollectiveError. 0 disables.
    flight_recorder_size: int = 2048
    flight_recorder_dir: str = ""
    # A RUNNING task older than straggler_k x p95 of its completed
    # same-name peers (needs >= straggler_min_peers completions) raises a
    # straggler event in health_report() and a timeline instant.
    straggler_k: float = 3.0
    straggler_min_peers: int = 5
    # Collective recv/coordination waits arm a progress beacon with this
    # deadline; the GCS watchdog emits a StallEvent (naming the suspect
    # rank) once it passes without progress — typically long before the
    # collective's own timeout would fire.
    collective_stall_deadline_s: float = 10.0
    # --- elastic training (ray_tpu_torch/train/elastic.py) -------------------------
    # Monitor beat: how often the ElasticCoordinator polls every rank for
    # reports / liveness while a gang attempt runs.
    elastic_poll_interval_s: float = 0.25
    # How often the coordinator pulls the GCS health report to fold
    # StallEvents (wedged rank, stuck collective) into suspect ranks.
    elastic_health_poll_interval_s: float = 1.0
    # Report-cadence straggler demotion: once every rank has filed at
    # least elastic_straggler_min_reports reports, a rank whose
    # inter-report EWMA exceeds elastic_straggler_k x the gang median is
    # quarantined. (The task-level straggler_k above can't see actor
    # loops — report cadence is the trainer-level analog.)
    elastic_straggler_k: float = 3.0
    elastic_straggler_min_reports: int = 4
    # Grow path: how often a shrunken gang probes the cluster for the
    # capacity to refill/grow toward its target world size.
    elastic_grow_check_interval_s: float = 5.0
    # Placement-group reservation wait used by elastic refill/grow
    # attempts (short on purpose: a failed attempt reports gang demand
    # and retries next probe instead of blocking the monitor).
    elastic_reserve_timeout_s: float = 10.0
    # Grace window before remediation kills surviving ranks: the monitor
    # keeps polling rank 0 until one more report lands (a report entry
    # appends only AFTER its checkpoint save commits, so one fresh
    # report == a complete checkpoint to resume from) or this expires.
    # Without it a death seconds into a run can kill rank 0 mid-first-
    # save and resume from scratch.
    elastic_drain_grace_s: float = 10.0
    # --- memory attribution plane (observability/memory.py) -----------------
    # Per-object ownership/pin/temperature records riding the batched
    # telemetry report; False strips the put/get hot-path hooks to bare
    # dict probes (bench.py --bench memory measures the difference).
    memory_attribution: bool = True
    # A record still pinned this long after its last owner ref died is a
    # leak suspect in memory_report() (ref: `ray memory` leak triage).
    memory_leak_suspect_s: float = 60.0
    # An unpinned non-primary record idle this long is a spill candidate
    # (the eviction shortlist the spilling pass will consume).
    memory_cold_after_s: float = 30.0
    log_to_driver: bool = True

    def override(self, d: Dict[str, Any]) -> "Config":
        for k, v in d.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown config key: {k}")
            setattr(self, k, v)
        return self

    @classmethod
    def load(cls, system_config: Dict[str, Any] | None = None) -> "Config":
        cfg = cls()
        for f in fields(cls):
            env = os.environ.get(f"RAY_TPU_{f.name.upper()}")
            if env is not None:
                cur = getattr(cfg, f.name)
                if isinstance(cur, bool):
                    setattr(cfg, f.name, env.lower() in ("1", "true", "yes"))
                elif isinstance(cur, int):
                    setattr(cfg, f.name, int(env))
                elif isinstance(cur, float):
                    setattr(cfg, f.name, float(env))
                else:
                    setattr(cfg, f.name, env)
        if system_config:
            cfg.override(system_config)
        return cfg

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls().override(json.loads(s))


GLOBAL_CONFIG: Config = Config.load()
