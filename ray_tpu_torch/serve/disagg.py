"""Disaggregated prefill/decode serving (ref: DistServe, Mooncake).

Prefill is batch-friendly and compute-bound; decode is latency-sensitive
and memory-bound — co-locating them makes each worse (a long prompt's
prefill stalls every decode stream sharing the engine). ``build_llm_app
(disaggregated=True)`` (llm_deployment.py) deploys two pools instead:

    DisaggRouter (ingress) -> {name}_prefill x N  +  {name}_decode x M

and this router runs the two-stage flow per request:

1. GLOBAL PREFIX LOOKUP — the prompt's page-GROUP chain hashes are
   resolved against the GCS global prefix directory (gcs.py
   rpc_prefix_*). A warm prefix is adoptable by ANY prefill replica, so
   the rendezvous ranking the monolithic router uses for replica-LOCAL
   cache affinity extends cluster-global: directory hits route by load,
   cold prefixes still route by rendezvous so locality builds.
2. PREFILL — ``prefill_request`` on the chosen prefill replica fills the
   paged-KV pages (skipping locally-cached AND directory-warm groups),
   exports each new page group ONCE through the zero-copy store
   (kv_transfer.HandoffExporter), and returns the handoff envelope:
   ``{handoff_id, groups: [{hash, ref, nbytes}], ...}`` — refs, never
   page bytes.
3. DECODE — the envelope rides the decode replica's compiled standing
   channel (the same per-replica graph the monolithic router uses; the
   method is an execute-time input) as ``adopt_decode(envelope, body)``;
   the decode replica maps the groups in from the store and streams
   token frames back over the channel.
4. ACK — whatever the attempt's outcome, the router acks the handoff to
   the prefill replica so the per-handoff pins release; retained groups
   stay pinned via the exporter's LRU for future reuse.

Failover keeps the LLM router's token-continuity contract: a dead prefill
replica re-routes the prefill to a survivor; a decode-side death or a
``handoff_lost`` frame (exporter died before adoption) re-prefills
prompt + emitted-so-far, force-dropping the envelope's now-dangling
directory entries first. The client stream never duplicates or drops a
token.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.llm_router import LLMRouter, _next_item, prefix_hash
from ray_tpu_torch.util import metrics as _um
from ray_tpu_torch.util.tracing import span

_END = object()


class DisaggRouter(LLMRouter):
    """Ingress for the two-pool topology. The base class manages the
    DECODE pool end to end (stats poll, pressure, compiled standing
    channels, per-pool load report); this subclass adds the prefill pool
    view, the global-directory-aware prefill pick, and the two-stage
    request path."""

    def __init__(self, decode_handle: DeploymentHandle, *,
                 prefill_app: Optional[DeploymentHandle] = None,
                 page_tokens: Optional[int] = None,
                 group_pages: Optional[int] = None,
                 **kwargs):
        if prefill_app is None:
            raise ValueError("DisaggRouter needs prefill_app= (the bound "
                             "prefill deployment)")
        cfg = GLOBAL_CONFIG
        # set before super().__init__: the stats thread it starts runs
        # our _stats_tick, which reads these
        self._pf_handle = prefill_app
        self._pf_stats: Dict[str, Dict[str, Any]] = {}
        self._pf_inflight: Dict[str, int] = {}
        self._directory = None   # lazy: needs the in-actor runtime
        self.page_tokens = (page_tokens if page_tokens is not None
                            else cfg.serve_disagg_page_tokens)
        self.group_pages = (group_pages if group_pages is not None
                            else cfg.serve_disagg_group_pages)
        super().__init__(decode_handle, **kwargs)
        self.counters.update({
            "handoffs": 0, "handoffs_lost": 0, "prefill_reroutes": 0,
            "prefill_shed": 0, "global_lookups": 0, "global_hits": 0})
        tag = {"router": self._reporter[-12:]}
        self._m_handoff_bytes = _um.Counter(
            "ray_tpu_llm_router_handoff_bytes",
            "KV page bytes referenced by prefill->decode envelopes",
            tag_keys=("router",)).set_default_tags(tag)
        self._m_handoff_s = _um.Histogram(
            "ray_tpu_llm_router_handoff_s",
            "envelope-to-first-decode-frame latency",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5],
            tag_keys=("router",)).set_default_tags(tag)
        self._m_pool_inflight = _um.Gauge(
            "ray_tpu_llm_router_pool_inflight",
            "streams in flight per pool",
            tag_keys=("router", "pool")).set_default_tags(tag)

    # ---- prefill pool view -------------------------------------------------

    def _stats_tick(self):
        super()._stats_tick()   # decode pool + its load report
        self._poll_pool(self._pf_handle, self._pf_stats)
        with self._lock:
            pf_depth = sum(self._pf_inflight.values())
            dec_depth = sum(self._inflight.values())
        self._m_pool_inflight.set(pf_depth, tags={"pool": "prefill"})
        self._m_pool_inflight.set(dec_depth, tags={"pool": "decode"})
        # prefill demand reported under the prefill deployment's name:
        # the controller's per-deployment fold autoscales each pool on
        # its OWN queue, the point of disaggregating
        self._report(self._pf_handle.deployment_name, pf_depth)

    def _pf_pressure(self, key: str) -> float:
        st = self._pf_stats.get(key, {})
        load = self._pf_inflight.get(key, 0) + st.get("pending", 0)
        return load * (1.0 + st.get("busy", 0.0))

    # ---- global prefix directory -------------------------------------------

    def _dir(self):
        if self._directory is None:
            from ray_tpu_torch.serve.kv_transfer import PrefixDirectory
            self._directory = PrefixDirectory()
        return self._directory

    def _lookup_warm(self, tokens: List[int]) -> int:
        """Leading tokens resolvable from the global directory, any
        owner (blocking; executor thread). 0 on any directory error —
        a cold route is always correct, just slower."""
        from ray_tpu_torch.serve.kv_transfer import group_boundary_hashes
        try:
            hashes = group_boundary_hashes(tokens, self.page_tokens,
                                           self.group_pages)
            if not hashes:
                return 0
            with self._lock:
                self.counters["global_lookups"] += 1
            hits = self._dir().lookup(hashes)
        except Exception:
            return 0
        n = 0
        for e in hits:
            if e is None:
                break
            n += 1
        return n * self.page_tokens * self.group_pages

    def _drop_dangling(self, envelope: Dict[str, Any]) -> None:
        """A handoff was lost: the envelope's refs dangle (the exporter
        or its node died), so force-drop their directory entries — the
        next prefill re-exports and re-registers fresh ones. Without
        this, first-writer-wins would pin the directory to a dead
        owner's refs forever."""
        try:
            self._dir().drop([g["hash"] for g in envelope["groups"]])
        except Exception:
            pass

    # ---- placement ---------------------------------------------------------

    def _pick_prefill(self, prompt: List[int], avoid: set,
                      warm_tokens: int) -> Tuple[str, Any]:
        """Choose a prefill replica (blocking; executor thread). Cold
        prefixes rank by rendezvous so locality builds, exactly like the
        monolithic router; a prefix warm in the GLOBAL directory is
        adoptable anywhere, so those route purely by load — the
        cluster-global extension of the local-affinity pick."""
        import random

        reps = self._snapshot_of(self._pf_handle)
        if not reps:
            reps = self._snapshot_of(self._pf_handle, force=True)
        with self._lock:
            stats = dict(self._pf_stats)
        usable = [(k, r) for k, r in reps
                  if k not in avoid
                  and not stats.get(k, {}).get("draining", False)]
        if not usable:
            usable = [(k, r) for k, r in reps if k not in avoid]
        if not usable:
            raise RuntimeError(
                f"no usable replicas for "
                f"{self._pf_handle.deployment_name!r}")
        span_attrs = {"n_replicas": len(usable),
                      "warm_tokens": warm_tokens}
        with span("llm_router.route_prefill", span_attrs):
            if len(usable) == 1:
                return usable[0]
            affinity_span = min(len(prompt), self.prefix_tokens)
            if warm_tokens >= affinity_span > 0:
                # globally warm: any replica adopts the prefix from the
                # store; load wins
                with self._lock:
                    self.counters["global_hits"] += 1
                return min(usable, key=lambda kr: self._pf_pressure(kr[0]))
            if self.policy == "random":
                return usable[random.randrange(len(usable))]
            ph = prefix_hash(prompt, self.prefix_tokens)
            ranked = sorted(
                usable, key=lambda kr: hashlib.sha1(
                    f"{ph}:{kr[0]}".encode()).digest(), reverse=True)
            mean = sum(self._pf_pressure(k) for k, _ in usable) \
                / len(usable)
            limit = self.overload_factor * max(mean, 1.0)
            for rank, (k, r) in enumerate(ranked):
                if self._pf_pressure(k) <= limit:
                    with self._lock:
                        if rank == 0:
                            self.counters["affinity_picks"] += 1
                        else:
                            self.counters["fallback_picks"] += 1
                    return k, r
            with self._lock:
                self.counters["fallback_picks"] += 1
            return min(ranked, key=lambda kr: self._pf_pressure(kr[0]))

    def _pick_decode(self, avoid: set) -> Tuple[str, Any]:
        """Decode replicas hold no prefix state — the envelope makes any
        of them equivalent — so decode placement is pure load."""
        reps = self._snapshot()
        if not reps:
            reps = self._snapshot(force=True)
        with self._lock:
            stats = dict(self._replica_stats)
        usable = [(k, r) for k, r in reps
                  if k not in avoid
                  and not stats.get(k, {}).get("draining", False)]
        if not usable:
            usable = [(k, r) for k, r in reps if k not in avoid]
        if not usable:
            raise RuntimeError(
                f"no usable replicas for {self._handle.deployment_name!r}")
        return min(usable, key=lambda kr: self._pressure(kr[0]))

    # ---- prefill + ack transport -------------------------------------------

    def _prefill_call(self, key: str, replica, sub: dict) -> dict:
        """One prefill RPC (blocking; executor thread). Request/response
        — not a stream — so it rides the plain dispatch path, not the
        standing channel."""
        ref = replica.handle_request.remote(
            "prefill_request", (sub,), {}, None)
        return ray_tpu_torch.get(ref, timeout=60)

    def _ack(self, replica, handoff_id: str) -> None:
        """Release the handoff's pins on the prefill side. Fire-and-
        forget: a dead exporter has nothing left to unpin."""
        try:
            # raylint: disable=leaked-object-ref -- fire-and-forget ack
            replica.handle_request.remote("ack_handoff",
                                          (handoff_id,), {}, None)
        except Exception:
            pass

    # ---- request path ------------------------------------------------------

    async def stream_request(self, request) -> Any:
        """Two-stage streaming entry: admission -> global lookup ->
        prefill (envelope) -> decode stream, with failover at each
        stage. Same admission bound and client-visible frame contract as
        the monolithic router."""
        body = request if isinstance(request, dict) else request.json()
        prompt = list(body["prompt"])
        max_new = int(body.get("max_new_tokens", 32))
        temperature = float(body.get("temperature", 0.0))
        with self._lock:
            if self._total_inflight >= self.max_inflight:
                self.counters["shed"] += 1
                shed = True
            else:
                self._total_inflight += 1
                self.counters["requests"] += 1
                shed = False
            self._m_inflight.set(self._total_inflight)
        if shed:
            self._m_sheds.inc()
            yield {"error": f"router at max_inflight={self.max_inflight}; "
                            "retry later",
                   "status": 429, "retry_after_s": 1.0, "done": True}
            return
        self._m_requests.inc()
        loop = asyncio.get_running_loop()
        t0 = time.time()
        first_t: Optional[float] = None
        emitted: List[int] = []
        avoid_pf: set = set()
        avoid_dec: set = set()
        attempts = 0
        try:
            while True:
                attempts += 1
                if attempts > self.max_attempts:
                    yield {"error": "no replica could finish the stream",
                           "status": 503, "done": True,
                           "n_tokens": len(emitted)}
                    return
                sub = {"prompt": prompt + emitted,
                       "max_new_tokens": max_new - len(emitted),
                       "temperature": temperature}
                # -- stage 1: prefill ------------------------------------
                warm = await loop.run_in_executor(
                    self._executor, self._lookup_warm, sub["prompt"])
                try:
                    pf_key, pf_replica = await loop.run_in_executor(
                        self._executor, self._pick_prefill, sub["prompt"],
                        avoid_pf, warm)
                except RuntimeError as e:
                    yield {"error": str(e), "status": 503, "done": True,
                           "n_tokens": len(emitted)}
                    return
                with self._lock:
                    self._pf_inflight[pf_key] = \
                        self._pf_inflight.get(pf_key, 0) + 1
                try:
                    res = await loop.run_in_executor(
                        self._executor, self._prefill_call, pf_key,
                        pf_replica, sub)
                except (ray_tpu_torch.exceptions.ActorDiedError,
                        ray_tpu_torch.exceptions.ActorUnavailableError) as e:
                    self._on_prefill_death(pf_key, e)
                    avoid_pf.add(pf_key)
                    continue
                except Exception as e:
                    # prefill RPC failed some other way: avoid + retry
                    with self._lock:
                        self.counters["prefill_reroutes"] += 1
                    avoid_pf.add(pf_key)
                    if attempts >= self.max_attempts:
                        yield {"error": f"prefill failed: {e}",
                               "status": 503, "done": True,
                               "n_tokens": len(emitted)}
                        return
                    continue
                finally:
                    with self._lock:
                        if self._pf_inflight.get(pf_key, 0) > 0:
                            self._pf_inflight[pf_key] -= 1
                if res.get("status") == 429:
                    with self._lock:
                        self.counters["prefill_shed"] += 1
                    avoid_pf.add(pf_key)
                    continue
                envelope = res["envelope"]
                t_env = time.time()
                with self._lock:
                    self.counters["handoffs"] += 1
                self._m_handoff_bytes.inc(int(envelope.get("nbytes", 0)))
                # -- stage 2: decode -------------------------------------
                try:
                    dec_key, dec_replica = await loop.run_in_executor(
                        self._executor, self._pick_decode, avoid_dec)
                except RuntimeError as e:
                    self._ack(pf_replica, envelope["handoff_id"])
                    yield {"error": str(e), "status": 503, "done": True,
                           "n_tokens": len(emitted)}
                    return
                with self._lock:
                    self._inflight[dec_key] = \
                        self._inflight.get(dec_key, 0) + 1
                rerouted = False
                handoff_seen = False
                try:
                    frames = await loop.run_in_executor(
                        self._executor, self._open_stream, dec_key,
                        dec_replica, (envelope, sub), "adopt_decode")
                    while True:
                        try:
                            item = await loop.run_in_executor(
                                self._executor, _next_item, frames)
                        except (ray_tpu_torch.exceptions.ActorDiedError,
                                ray_tpu_torch.exceptions.ActorUnavailableError
                                ) as e:
                            self._on_replica_death(dec_key, e)
                            avoid_dec.add(dec_key)
                            rerouted = True
                            break
                        if item is _END or (
                                not isinstance(item, dict)):
                            yield self._final(emitted, first_t, t0,
                                              attempts, dec_key)
                            return
                        if item.get("handoff_lost"):
                            # exporter (or its store) died before the
                            # decode replica mapped the pages: the
                            # envelope's refs — and their directory
                            # entries — are dangling
                            with self._lock:
                                self.counters["handoffs_lost"] += 1
                            await loop.run_in_executor(
                                self._executor, self._drop_dangling,
                                envelope)
                            rerouted = True
                            break
                        if item.get("status") == 429:
                            with self._lock:
                                self.counters["replica_shed"] += 1
                            avoid_dec.add(dec_key)
                            rerouted = True
                            break
                        if item.get("done"):
                            out = self._final(emitted, first_t, t0,
                                              attempts, dec_key)
                            if item.get("error"):
                                out["error"] = item["error"]
                            yield out
                            return
                        toks = item.get("tokens", [])
                        if toks:
                            if first_t is None:
                                first_t = time.time()
                                self._m_ttft.observe(first_t - t0)
                            if not handoff_seen:
                                handoff_seen = True
                                self._m_handoff_s.observe(
                                    time.time() - t_env)
                            emitted.extend(toks)
                            yield {"tokens": toks}
                finally:
                    with self._lock:
                        if self._inflight.get(dec_key, 0) > 0:
                            self._inflight[dec_key] -= 1
                    # ack EVERY attempt's handoff — completed, rerouted,
                    # or abandoned by the client — so the prefill-side
                    # pins never outlive the attempt
                    self._ack(pf_replica, envelope["handoff_id"])
                if not rerouted:
                    return
        finally:
            with self._lock:
                self._total_inflight = max(self._total_inflight - 1, 0)
                self._m_inflight.set(self._total_inflight)

    def _on_prefill_death(self, key: str, err) -> None:
        """Prefill replica died mid-call: evict it from the prefill
        pool's shared replica view and account the re-route."""
        rt = self._pf_handle._get_router()
        rt.evict(getattr(err, "actor_id", None) or key)
        with self._lock:
            self._pf_stats.pop(key, None)
            self.counters["prefill_reroutes"] += 1
        self._m_reroutes.inc()

    # ---- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._lock:
            out["prefill_inflight"] = dict(self._pf_inflight)
            out["prefill_replica_stats"] = {
                k: {kk: vv for kk, vv in v.items()
                    if not kk.startswith("_")}
                for k, v in self._pf_stats.items()}
        return out
