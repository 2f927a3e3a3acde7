"""LLMRouter: prefix-cache-aware routing across LLMServer replicas.

Multi-replica LLM serving needs a router that is smarter than the
generic power-of-two handle: paged-KV prefix caching (serve/paged_kv.py
PagePool + llm.py automatic prefix caching) makes replica choice
STATEFUL — a request whose prompt shares a prefix with earlier traffic
is dramatically cheaper on the replica that already holds those KV
pages (TTFT skips the prefix's prefill compute AND its page memory).
Ref: vLLM's prefix-aware routing in production routers (e.g. the
llm-d / vllm-router session-affinity schemes); the reference serve
stack has no LLM-aware routing at all.

Routing policy, per request:

1. PREFIX AFFINITY — hash the first ``llm_router_prefix_tokens`` prompt
   tokens and rank replicas by rendezvous (highest-random-weight)
   hashing of (prefix_hash x replica actor id). All streams sharing a
   prefix agree on the same ranking without any shared state, and a
   replica joining/leaving only remaps the streams that hashed to it —
   no global reshuffle (the property consistent hashing buys).
2. OVERLOAD FALLBACK — affinity yields to load: if the preferred
   replica's pressure exceeds ``llm_router_overload_factor`` x the
   fleet mean, walk down the rendezvous ranking; if every replica is
   hot, take the least-pressured (pure load balancing).
   pressure = (router in-flight + engine pending) * (1 + busy), where
   busy is an EWMA of the replica's admit_s + decode_block_s rate from
   LLMServer.stats() — a replica spending all its wall time in
   admission/decode is saturated even at equal queue depth.
3. ADMISSION — a router-wide in-flight bound (``llm_router_max_inflight``)
   sheds excess demand with a typed 429 + Retry-After first frame
   instead of queueing unboundedly (same contract as LLMQueueFull at
   the engine).

Streaming failover: the router owns each replica stream and re-routes a
mid-stream replica death by resubmitting prompt + tokens-generated-so-far
(max_new_tokens decremented by the emitted count) to a surviving
replica. The client-visible stream continues with no duplicated or
dropped tokens — the resubmission's prompt IS the already-emitted
sequence, so the new replica only ever generates the continuation.

Stream-frame transport: with ``llm_router_compiled_hop`` (default on)
the router compiles one standing two-node graph per replica —
``InputNode -> replica.handle_request_streaming`` (dag/compiled.py) —
and each request is a raw channel enqueue; token frames ride the
standing channel back instead of paying per-call ``.remote()`` dispatch
plus a driver-mediated ref per frame. Replica death still surfaces as
``ActorDiedError`` from the frame iterator, feeding the same failover
path; compile failures fall back to the legacy per-call hop.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.handle import DeploymentHandle, Router
from ray_tpu_torch.util import metrics as _um
from ray_tpu_torch.util.tracing import span

_END = object()


def _next_item(frames):
    """One blocking stream step (runs on an executor thread: raylint
    blocking-in-async). Raises the replica's ActorDiedError here when it
    died mid-stream — the async caller re-routes."""
    try:
        return next(frames)
    except StopIteration:
        return _END


def _legacy_frames(gen):
    """Frame iterator over the per-call dispatch path: each step submits
    nothing new but pulls the next streamed ObjectRef and resolves it."""
    while True:
        try:
            ref = next(gen)
        except StopIteration:
            return
        yield ray_tpu_torch.get(ref)


def prefix_hash(tokens: List[int], n: int) -> str:
    """Stable cross-process hash of the first n prompt tokens."""
    head = ",".join(str(int(t)) for t in tokens[:n])
    return hashlib.sha1(head.encode()).hexdigest()


class LLMRouter:
    """Ingress deployment fronting an LLMServer deployment.

    Compose with serve.deployment + bind (see llm_deployment.build_llm_app):
    the LLMServer application is passed to bind() and arrives here as a
    DeploymentHandle; the router reads its replica set (long-poll pushed)
    through the handle's underlying Router but makes its OWN placement
    decisions.
    """

    def __init__(self, llm_handle: DeploymentHandle, *,
                 policy: str = "affinity",
                 prefix_tokens: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 overload_factor: Optional[float] = None,
                 stats_interval_s: Optional[float] = None,
                 report_load: bool = True,
                 max_attempts: int = 6,
                 compiled_hop: Optional[bool] = None,
                 tenant_weights: Optional[Dict[str, float]] = None):
        if policy not in ("affinity", "p2c", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self._handle = llm_handle
        self.policy = policy
        cfg = GLOBAL_CONFIG
        # Weighted-fair tenant admission: explicit arg wins, else the
        # serve_tenant_weights JSON knob; unmapped tenants weigh 1.
        if tenant_weights is None and cfg.serve_tenant_weights:
            import json as _json
            try:
                tenant_weights = _json.loads(cfg.serve_tenant_weights)
            except Exception:
                tenant_weights = None
        self.tenant_weights: Dict[str, float] = {
            str(k): float(v) for k, v in (tenant_weights or {}).items()}
        self._compiled_hop = (compiled_hop if compiled_hop is not None
                              else cfg.llm_router_compiled_hop)
        #: replica key -> CompiledDAG of the standing stream-frame hop
        self._compiled: Dict[str, Any] = {}
        self.prefix_tokens = (prefix_tokens if prefix_tokens is not None
                              else cfg.llm_router_prefix_tokens)
        self.max_inflight = (max_inflight if max_inflight is not None
                             else cfg.llm_router_max_inflight)
        self.overload_factor = (overload_factor if overload_factor is not None
                                else cfg.llm_router_overload_factor)
        self._stats_interval = (stats_interval_s if stats_interval_s
                                is not None
                                else cfg.llm_router_stats_interval_s)
        self._report_load = report_load
        self.max_attempts = max_attempts
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}   # per-replica, router-local
        self._total_inflight = 0
        #: per-tenant / per-model in-flight splits of _total_inflight
        self._tenant_inflight: Dict[str, int] = {}
        self._model_inflight: Dict[str, int] = {}
        #: per-tenant admit/shed/TTFT aggregates (stats() + bench)
        self._tenant_stats: Dict[str, Dict[str, float]] = {}
        #: per-replica view from the stats poll thread:
        #: {pending, active, draining, busy, models, model_queue, ...}
        self._replica_stats: Dict[str, Dict[str, Any]] = {}
        self.counters = {"requests": 0, "shed": 0, "replica_shed": 0,
                         "replica_failed": 0, "tenant_shed": 0,
                         "reroutes": 0, "affinity_picks": 0,
                         "fallback_picks": 0, "warm_model_picks": 0,
                         "cold_model_picks": 0, "compiled_streams": 0,
                         "legacy_streams": 0}
        try:
            me = (ray_tpu_torch.get_runtime_context().get_actor_id() or "driver")
        except Exception:
            me = "local"
        self._reporter = f"llm_router_{str(me)[:12]}"
        tag = {"router": self._reporter[-12:]}
        self._m_requests = _um.Counter(
            "ray_tpu_llm_router_requests", "requests routed",
            tag_keys=("router",)).set_default_tags(tag)
        self._m_sheds = _um.Counter(
            "ray_tpu_llm_router_sheds",
            "requests shed at the router admission bound",
            tag_keys=("router",)).set_default_tags(tag)
        self._m_reroutes = _um.Counter(
            "ray_tpu_llm_router_reroutes",
            "mid-stream failovers to a surviving replica",
            tag_keys=("router",)).set_default_tags(tag)
        self._m_affinity = _um.Counter(
            "ray_tpu_llm_router_affinity_picks",
            "placements on the rendezvous-preferred replica",
            tag_keys=("router",)).set_default_tags(tag)
        self._m_inflight = _um.Gauge(
            "ray_tpu_llm_router_inflight", "streams in flight",
            tag_keys=("router",)).set_default_tags(tag)
        self._m_ttft = _um.Histogram(
            "ray_tpu_llm_router_ttft_s",
            "router-observed time to first token",
            boundaries=[0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30],
            tag_keys=("router",)).set_default_tags(tag)
        # per-tenant telemetry: the tenant tag splits each series so the
        # dashboard/bench can see WHO was admitted, shed, and how slow
        self._m_tenant_requests = _um.Counter(
            "ray_tpu_serve_tenant_requests",
            "requests admitted per tenant",
            tag_keys=("router", "tenant")).set_default_tags(tag)
        self._m_tenant_sheds = _um.Counter(
            "ray_tpu_serve_tenant_sheds",
            "requests shed per tenant by weighted-fair admission",
            tag_keys=("router", "tenant")).set_default_tags(tag)
        self._m_tenant_ttft = _um.Histogram(
            "ray_tpu_serve_tenant_ttft_s",
            "per-tenant router-observed time to first token",
            boundaries=[0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30],
            tag_keys=("router", "tenant")).set_default_tags(tag)
        # Dedicated executor for blocking stream pulls: every in-flight
        # stream PARKS a thread in _next_item waiting for the replica's
        # next frame, so the event loop's small default pool would cap
        # concurrency at ~cpu+4 streams and stall the rest.
        import concurrent.futures

        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(self.max_inflight + 4, 512),
            thread_name_prefix="llm_router")
        self._stop = threading.Event()
        self._stats_thread = threading.Thread(target=self._stats_loop,
                                              daemon=True)
        self._stats_thread.start()

    # ---- replica view ------------------------------------------------------

    def _snapshot(self, force: bool = False) -> List[Tuple[str, Any]]:
        return self._snapshot_of(self._handle, force)

    @staticmethod
    def _snapshot_of(handle: DeploymentHandle,
                     force: bool = False) -> List[Tuple[str, Any]]:
        rt = handle._get_router()
        rt._ensure_poller()
        rt._refresh(force)
        with rt._lock:
            reps = list(rt._replicas)
        return [(Router._key(r), r) for r in reps]

    def _pressure(self, key: str) -> float:
        st = self._replica_stats.get(key, {})
        load = self._inflight.get(key, 0) + st.get("pending", 0)
        return load * (1.0 + st.get("busy", 0.0))

    def _poll_pool(self, handle: DeploymentHandle,
                   stats_map: Dict[str, Dict[str, Any]]) -> Optional[set]:
        """One stats sweep over a pool: poll each replica's stats(),
        fold the busy-fraction EWMA into stats_map, prune departed
        replicas. Returns the live key set (None: snapshot failed).
        Pool-generic so DisaggRouter reuses it for the prefill pool."""
        alpha = 0.5
        try:
            reps = self._snapshot_of(handle)
        except Exception:
            return None
        now = time.time()
        for key, replica in reps:
            try:
                raw = ray_tpu_torch.get(
                    replica.handle_request.remote("stats", (), {}, None),
                    timeout=5)
            except Exception:
                continue   # dead replicas age out via the long-poll set
            busy_s = float(raw.get("admit_s", 0.0)) + \
                float(raw.get("decode_block_s", 0.0))
            with self._lock:
                prev = stats_map.get(key)
                frac = 0.0
                if prev is not None and now > prev["_ts"]:
                    frac = max(busy_s - prev["_raw_busy_s"], 0.0) \
                        / (now - prev["_ts"])
                ewma = (frac if prev is None
                        else alpha * frac + (1 - alpha) * prev["busy"])
                stats_map[key] = {
                    "pending": int(raw.get("pending", 0)),
                    "active": int(raw.get("active_slots", 0)),
                    "draining": bool(raw.get("draining", False)),
                    "busy": min(ewma, 4.0),
                    # advertised model set + per-model backlog from
                    # multiplexed replicas (absent -> single-model)
                    "models": list(raw.get("models") or []),
                    "model_queue": dict(raw.get("model_queue") or {}),
                    "_raw_busy_s": busy_s, "_ts": now,
                }
        with self._lock:
            live = {k for k, _ in reps}
            for k in list(stats_map):
                if k not in live:
                    del stats_map[k]
        return live

    def _report(self, deployment_name: str, depth: int,
                model_depths: Optional[Dict[str, int]] = None) -> None:
        """Push one pool's router-observed queue depth to the controller
        so autoscaling sees demand the replicas haven't accepted yet.
        model_depths carries the per-model split feeding the controller's
        per-model replica scaler."""
        if not self._report_load:
            return
        try:
            controller = ray_tpu_torch.get_actor("_serve_controller",
                                                 namespace="serve")
            ray_tpu_torch.get(controller.report_load.remote(
                deployment_name, self._reporter, depth, model_depths),
                timeout=5)
        except Exception:
            pass   # controller restarting: next tick re-reports

    def _stats_loop(self):
        """Poll LLMServer.stats() per replica on a fixed cadence; derive
        the busy-fraction EWMA feeding the pressure score, and push the
        router's own queue depth to the controller so autoscaling sees
        demand the replicas haven't accepted yet."""
        while not self._stop.wait(self._stats_interval):
            self._stats_tick()

    def _stats_tick(self):
        live = self._poll_pool(self._handle, self._replica_stats)
        if live is None:
            return
        with self._lock:
            stale = [(k, c) for k, c in self._compiled.items()
                     if k not in live]
            for k, _ in stale:
                del self._compiled[k]
            depth = self._total_inflight
            mdepth = {m: v for m, v in self._model_inflight.items()
                      if v > 0}
        for _, comp in stale:   # off-lock: teardown RPCs block
            try:
                comp.teardown(kill_actors=False)
            except Exception:
                pass
        # always send the dict (even empty): a None would leave the
        # controller holding this reporter's LAST split for up to its
        # 10 s age-out, pinning per-model demand that already drained
        self._report(self._handle.deployment_name, depth, mdepth)

    # ---- placement ---------------------------------------------------------

    def _pick(self, prompt: List[int], model: str,
              avoid: set) -> Tuple[str, Any]:
        """Choose a replica (blocking; call from an executor thread).
        avoid = replicas that already shed this request. The rendezvous
        key is (model_id, prefix): all traffic for one model converges on
        the same sub-ranking, and within it shared prefixes converge
        further. Replicas ADVERTISING the model (loaded + published) are
        stably promoted ahead of cold ones so the overload walk prefers
        paying queueing over paying a model load."""
        import random

        reps = self._snapshot()
        if not reps:
            reps = self._snapshot(force=True)
        with self._lock:
            stats = dict(self._replica_stats)
        usable = [(k, r) for k, r in reps
                  if k not in avoid
                  and not stats.get(k, {}).get("draining", False)]
        if not usable:
            # every replica draining/avoided: last resort is the raw set
            usable = [(k, r) for k, r in reps if k not in avoid]
        if not usable:
            raise RuntimeError(
                f"no usable replicas for {self._handle.deployment_name!r}")
        with span("llm_router.route", {"policy": self.policy,
                                       "n_replicas": len(usable)}):
            if self.policy == "random" or len(usable) == 1:
                return usable[random.randrange(len(usable))]
            if self.policy == "p2c":
                a, b = random.sample(range(len(usable)), 2)
                ka, kb = usable[a][0], usable[b][0]
                return usable[a if self._pressure(ka)
                              <= self._pressure(kb) else b]
            ph = prefix_hash(prompt, self.prefix_tokens)
            rkey = f"{model}\x00{ph}" if model else ph
            ranked = sorted(
                usable, key=lambda kr: hashlib.sha1(
                    f"{rkey}:{kr[0]}".encode()).digest(), reverse=True)
            if model:
                # stable warm-first partition (rendezvous order kept
                # within each half): a replica with the model resident
                # skips the load entirely
                warm_keys = {k for k, _ in ranked
                             if model in (stats.get(k, {}).get("models")
                                          or [])}
                if warm_keys:
                    ranked = ([kr for kr in ranked if kr[0] in warm_keys]
                              + [kr for kr in ranked
                                 if kr[0] not in warm_keys])
            else:
                warm_keys = set()
            mean = sum(self._pressure(k) for k, _ in usable) / len(usable)
            limit = self.overload_factor * max(mean, 1.0)
            chosen = None
            chosen_rank = 0
            for rank, (k, r) in enumerate(ranked):
                if self._pressure(k) <= limit:
                    chosen, chosen_rank = (k, r), rank
                    break
            if chosen is None:
                chosen = min(ranked, key=lambda kr: self._pressure(kr[0]))
                chosen_rank = -1
            with self._lock:
                if chosen_rank == 0:
                    self.counters["affinity_picks"] += 1
                else:
                    self.counters["fallback_picks"] += 1
                if model:
                    if chosen[0] in warm_keys:
                        self.counters["warm_model_picks"] += 1
                    else:
                        self.counters["cold_model_picks"] += 1
            if chosen_rank == 0:
                self._m_affinity.inc()
            return chosen

    # ---- weighted-fair tenant admission ------------------------------------

    def _tenant_weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    def _tenant_share_locked(self, tenant: str) -> float:
        """`tenant`'s guaranteed slice of max_inflight: weights are
        normalized over the tenants ACTIVE right now (plus the asker),
        so idle tenants do not strand capacity. Caller holds _lock."""
        active = {t for t, v in self._tenant_inflight.items() if v > 0}
        active.add(tenant)
        wsum = sum(self._tenant_weight(t) for t in active)
        return self.max_inflight * self._tenant_weight(tenant) \
            / max(wsum, 1e-9)

    def _admit_locked(self, tenant: str) -> bool:
        """Weighted-fair queuing over in-flight shares. A tenant within
        its guaranteed share ALWAYS admits — even with the global cap
        transiently exceeded by another tenant's borrowing (overshoot is
        bounded by the sum of guaranteed shares = max_inflight). Past
        its share, a tenant may only borrow idle capacity under the
        global cap — so when the router saturates, the most-over-quota
        tenant is exactly the one shed first."""
        cur = self._tenant_inflight.get(tenant, 0)
        if cur + 1 <= self._tenant_share_locked(tenant):
            return True
        return self._total_inflight < self.max_inflight

    def _tenant_stat(self, tenant: str) -> Dict[str, float]:
        return self._tenant_stats.setdefault(
            tenant, {"requests": 0, "shed": 0,
                     "ttft_sum": 0.0, "ttft_count": 0})

    # ---- request paths -----------------------------------------------------

    async def stream_request(self, request) -> Any:
        """End-to-end streaming entry (HTTP ?stream=1 / SSE, or handle
        calls): weighted-fair admission -> model/prefix placement -> fan
        the replica's token frames through, surviving replica death
        mid-stream by re-routing with prompt + generated-so-far. The
        model id and tenant tag come from the body ("model"/"tenant")
        or, for handle calls via .options(), the call context."""
        from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                                   get_request_tenant)
        body = request if isinstance(request, dict) else request.json()
        prompt = list(body["prompt"])
        max_new = int(body.get("max_new_tokens", 32))
        temperature = float(body.get("temperature", 0.0))
        model = str(body.get("model") or get_multiplexed_model_id() or "")
        tenant = str(body.get("tenant") or get_request_tenant()
                     or "default")
        with self._lock:
            if not self._admit_locked(tenant):
                self.counters["shed"] += 1
                self.counters["tenant_shed"] += 1
                self._tenant_stat(tenant)["shed"] += 1
                shed = True
            else:
                self._total_inflight += 1
                self._tenant_inflight[tenant] = \
                    self._tenant_inflight.get(tenant, 0) + 1
                if model:
                    self._model_inflight[model] = \
                        self._model_inflight.get(model, 0) + 1
                self.counters["requests"] += 1
                self._tenant_stat(tenant)["requests"] += 1
                shed = False
            self._m_inflight.set(self._total_inflight)
        if shed:
            self._m_sheds.inc()
            self._m_tenant_sheds.inc(tags={"tenant": tenant})
            yield {"error": f"tenant {tenant!r} over fair share at "
                            f"max_inflight={self.max_inflight}; "
                            "retry later",
                   "status": 429, "retry_after_s": 1.0, "done": True}
            return
        self._m_requests.inc()
        self._m_tenant_requests.inc(tags={"tenant": tenant})
        ctx = ({"multiplexed_model_id": model, "tenant": tenant}
               if (model or tenant != "default") else None)
        loop = asyncio.get_running_loop()
        t0 = time.time()
        first_t: Optional[float] = None
        emitted: List[int] = []
        avoid: set = set()
        attempts = 0
        last_err: Optional[str] = None
        try:
            while True:
                attempts += 1
                if attempts > self.max_attempts:
                    yield {"error": last_err
                                    or "no replica could finish the stream",
                           "status": 503, "done": True,
                           "n_tokens": len(emitted)}
                    return
                try:
                    key, replica = await loop.run_in_executor(
                        self._executor, self._pick, prompt, model, avoid)
                except RuntimeError as e:
                    yield {"error": (f"{e}; last replica error: {last_err}"
                                     if last_err else str(e)),
                           "status": 503, "done": True,
                           "n_tokens": len(emitted)}
                    return
                sub = {"prompt": prompt + emitted,
                       "max_new_tokens": max_new - len(emitted),
                       "temperature": temperature}
                if model:
                    sub["model"] = model
                if tenant != "default":
                    sub["tenant"] = tenant
                with self._lock:
                    self._inflight[key] = self._inflight.get(key, 0) + 1
                rerouted = False
                try:
                    frames = await loop.run_in_executor(
                        self._executor, self._open_stream, key, replica,
                        (sub,), "stream_request", ctx)
                    while True:
                        try:
                            item = await loop.run_in_executor(
                                self._executor, _next_item, frames)
                        except (ray_tpu_torch.exceptions.ActorDiedError,
                                ray_tpu_torch.exceptions.ActorUnavailableError
                                ) as e:
                            self._on_replica_death(key, e)
                            rerouted = True
                            break
                        if item is _END:
                            # clean end without a done frame (defensive)
                            yield self._final(emitted, first_t, t0,
                                              attempts, key)
                            return
                        if isinstance(item, dict) and \
                                item.get("status") == 429:
                            # replica shed (queue full or draining):
                            # route around it, do not fail the client
                            with self._lock:
                                self.counters["replica_shed"] += 1
                            avoid.add(key)
                            rerouted = True
                            break
                        if isinstance(item, dict) and item.get("done") \
                                and int(item.get("status") or 0) >= 500:
                            # replica-side hard failure (e.g. cold-model
                            # load failed): another replica may still
                            # serve it — route around, fail the client
                            # only when every attempt is spent
                            with self._lock:
                                self.counters["replica_failed"] += 1
                            last_err = item.get("error")
                            avoid.add(key)
                            rerouted = True
                            break
                        if isinstance(item, dict) and item.get("done"):
                            out = self._final(emitted, first_t, t0,
                                              attempts, key)
                            if item.get("error"):
                                out["error"] = item["error"]
                            yield out
                            return
                        toks = (item or {}).get("tokens", [])
                        if toks:
                            if first_t is None:
                                first_t = time.time()
                                ttft = first_t - t0
                                self._m_ttft.observe(ttft)
                                self._m_tenant_ttft.observe(
                                    ttft, tags={"tenant": tenant})
                                with self._lock:
                                    st = self._tenant_stat(tenant)
                                    st["ttft_sum"] += ttft
                                    st["ttft_count"] += 1
                            emitted.extend(toks)
                            yield {"tokens": toks}
                finally:
                    with self._lock:
                        if self._inflight.get(key, 0) > 0:
                            self._inflight[key] -= 1
                if not rerouted:
                    return
        finally:
            with self._lock:
                self._total_inflight = max(self._total_inflight - 1, 0)
                # drop zeroed entries: the split dicts stay bounded by
                # ACTIVE tenants/models, not the lifetime catalog
                if self._tenant_inflight.get(tenant, 0) > 1:
                    self._tenant_inflight[tenant] -= 1
                else:
                    self._tenant_inflight.pop(tenant, None)
                if model:
                    if self._model_inflight.get(model, 0) > 1:
                        self._model_inflight[model] -= 1
                    else:
                        self._model_inflight.pop(model, None)
                self._m_inflight.set(self._total_inflight)

    # ---- stream transport --------------------------------------------------

    def _open_stream(self, key: str, replica, args: tuple,
                     method: str = "stream_request",
                     context: Optional[dict] = None):
        """Open one replica stream (blocking; executor thread). Compiled
        hop when enabled: a raw enqueue onto the replica's standing
        channel; otherwise the per-call dispatch path. The method is an
        execute-time input on the standing graph, so the SAME channel
        per replica carries any streaming method — stream_request for
        the monolithic pool, adopt_decode for the disagg decode hop.
        `context` (multiplexed_model_id / tenant) is an execute-time
        input too, so BOTH hops deliver identical per-call context to
        the replica's contextvars."""
        if self._compiled_hop:
            try:
                comp = self._compiled_for(key, replica)
                ref = comp.execute(method=method, args=args,
                                   kwargs={}, context=context)
                with self._lock:
                    self.counters["compiled_streams"] += 1
                return iter(ref)
            except (ray_tpu_torch.exceptions.ActorDiedError,
                    ray_tpu_torch.exceptions.ActorUnavailableError):
                raise
            except Exception:
                # compile/enqueue failure that is NOT the replica dying:
                # drop the graph and serve via the legacy hop
                self._drop_compiled(key)
        with self._lock:
            self.counters["legacy_streams"] += 1
        gen = replica.handle_request_streaming.remote(
            method, args, {}, context)
        return _legacy_frames(gen)

    def _compiled_for(self, key: str, replica):
        with self._lock:
            comp = self._compiled.get(key)
        if comp is not None:
            return comp
        from ray_tpu_torch.dag import InputNode, bind_actor

        with InputNode() as inp:
            dag = bind_actor(replica).handle_request_streaming.bind(
                inp.method, inp.args, inp.kwargs, inp.context)
        comp = dag.experimental_compile()
        with self._lock:
            racing = self._compiled.get(key)
            if racing is not None:
                comp_, comp = comp, racing
            else:
                self._compiled[key] = comp
                comp_ = None
        if comp_ is not None:
            comp_.teardown(kill_actors=False)
        return comp

    def _drop_compiled(self, key: str) -> None:
        """Release a replica's standing channel off the event loop (the
        teardown RPCs block)."""
        with self._lock:
            comp = self._compiled.pop(key, None)
        if comp is not None:
            try:
                self._executor.submit(comp.teardown, False)
            except RuntimeError:
                pass   # executor already shut down (drain)

    def _on_replica_death(self, key: str, err) -> None:
        """Mid-stream death: evict from the shared replica view so no
        request (ours included) re-picks the corpse, then account the
        re-route. The in-flight decrement rides the attempt's finally —
        the leak the old index-keyed Router had."""
        rt = self._handle._get_router()
        rt.evict(getattr(err, "actor_id", None) or key)
        self._drop_compiled(key)
        with self._lock:
            self._replica_stats.pop(key, None)
            self.counters["reroutes"] += 1
        self._m_reroutes.inc()

    def _final(self, emitted, first_t, t0, attempts, key) -> Dict[str, Any]:
        return {"done": True, "n_tokens": len(emitted),
                "ttft_s": (first_t - t0) if first_t is not None else None,
                "reroutes": attempts - 1, "replica": key[:12]}

    async def __call__(self, request) -> Any:
        """Non-streaming entry: same routing/failover machinery, result
        collected. 429s map to Response(429, Retry-After) for the proxy."""
        body = request if isinstance(request, dict) else request.json()
        tokens: List[int] = []
        final: Dict[str, Any] = {}
        async for frame in self.stream_request(body):
            if frame.get("status") == 429:
                from ray_tpu_torch.serve.http_proxy import Response

                retry = frame.get("retry_after_s", 1.0)
                return Response({"error": frame.get("error")},
                                status_code=429,
                                headers={"Retry-After": f"{retry:g}"})
            if frame.get("done"):
                final = frame
            tokens.extend(frame.get("tokens", []))
        if final.get("error"):
            from ray_tpu_torch.serve.http_proxy import Response

            return Response({"error": final["error"]},
                            status_code=int(final.get("status", 500)))
        return {"tokens": tokens, "ttft_s": final.get("ttft_s"),
                "reroutes": final.get("reroutes", 0)}

    # ---- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {**dict(self.counters),
                    "policy": self.policy,
                    "total_inflight": self._total_inflight,
                    "inflight": dict(self._inflight),
                    "tenant_weights": dict(self.tenant_weights),
                    "tenant_inflight": dict(self._tenant_inflight),
                    "model_inflight": dict(self._model_inflight),
                    "tenant_stats": {t: dict(v) for t, v in
                                     self._tenant_stats.items()},
                    "replica_stats": {
                        k: {kk: vv for kk, vv in v.items()
                            if not kk.startswith("_")}
                        for k, v in self._replica_stats.items()}}

    def queue_len(self) -> int:
        with self._lock:
            return self._total_inflight

    def drain(self) -> None:
        """Router replica retiring: stop the stats thread and release the
        standing channels; in-flight streams keep running (the controller
        waits on queue_len)."""
        self._stop.set()
        with self._lock:
            comps = list(self._compiled.values())
            self._compiled.clear()
        for comp in comps:
            try:
                self._executor.submit(comp.teardown, False)
            except RuntimeError:
                pass
        self._executor.shutdown(wait=False)
