"""LLM serving application builder + deterministic sim replica.

build_llm_app composes the two-tier serving graph the router needs
(ref: serve deployment-graph composition, api.py bind/_handleize):

    LLMRouter (ingress, 1 replica)  ->  LLMServer x N (paged KV engines)

serve.run deploys children first, so the router's injected
DeploymentHandle resolves live replicas immediately.

SimLLMServer is a deterministic LLMServer stand-in for router tests and
the serve_router bench: it honors the same streaming contract
(stream_request frames, LLMQueueFull-as-429 first frame), the same
stats() fields the router's pressure score reads, and a prefix cache
with the same register/match semantics — but its "generation" is
asyncio.sleep-based, so routing properties (affinity hit rate, shed
behavior, failover token continuity, replica scaling) are measured as
real wall-clock effects without a real engine. Token i of a submission
whose prompt has L tokens is L + i: after a mid-stream failover
resubmits prompt+generated, the continuation is exactly the next
integer — token continuity asserts are exact, not statistical.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve.llm_router import LLMRouter

_PAGE = 16   # sim prefix-cache granularity (tokens per "page")


class SimLLMServer:
    """Deterministic fake engine with real queueing/caching dynamics."""

    def __init__(self, *, max_slots: int = 8,
                 max_queue_depth: Optional[int] = 64,
                 prefill_s_per_token: float = 0.0002,
                 decode_s_per_token: float = 0.002,
                 tokens_per_frame: int = 4,
                 prefix_caching: bool = True,
                 prefix_cache_pages: int = 64,
                 mode: str = "monolithic",
                 page_tokens: int = _PAGE,
                 group_pages: int = 4,
                 retained_groups: int = 512,
                 use_directory: bool = True,
                 colocation_interference: float = 0.0,
                 multiplexed: bool = False,
                 max_models: Optional[int] = None,
                 model_load_s: float = 0.05,
                 model_load_fail_ids: Optional[List[str]] = None):
        if mode not in ("monolithic", "prefill", "decode"):
            raise ValueError(f"unknown SimLLMServer mode {mode!r}")
        self.mode = mode
        self.page_tokens = int(page_tokens)
        self.group_pages = int(group_pages)
        self.retained_groups = int(retained_groups)
        self.use_directory = use_directory
        self._exporter = None   # lazy: needs the in-actor runtime
        self._adopter = None
        self.max_slots = max_slots
        self.max_queue_depth = max_queue_depth
        self.prefill_s_per_token = prefill_s_per_token
        self.decode_s_per_token = decode_s_per_token
        self.tokens_per_frame = max(int(tokens_per_frame), 1)
        self.prefix_caching = prefix_caching
        self.prefix_cache_pages = prefix_cache_pages
        # co-location contention model (ref: DistServe §2): a prefill
        # sharing the engine inflates every co-scheduled decode step by
        # this factor per co-running prefill. A replica that runs only
        # one phase (mode="prefill"/"decode") never pays it — the effect
        # disaggregation removes.
        self.colocation_interference = float(colocation_interference)
        self._prefill_active = 0
        # LRU by insertion/touch order, like PagePool's reclaim of
        # refcount-0 cached pages: a replica whose routed working set
        # exceeds capacity THRASHES — the effect prefix affinity exists
        # to avoid (it partitions prefix groups across replicas so each
        # replica's set fits).
        from collections import OrderedDict

        self._cached_pages: "OrderedDict[tuple, None]" = OrderedDict()
        self._slots = asyncio.Semaphore(max_slots)
        self._pending = 0
        self._active = 0
        self._draining = False
        self._lock = threading.Lock()
        # --- model multiplexing (mirrors LLMServer's contract) --------------
        # A "loaded model" here is a token dict; loading costs
        # model_load_s of wall clock — the effect model-affinity routing
        # exists to avoid (a request landing on a cold replica pays it).
        self.multiplexed = multiplexed
        self.model_load_s = float(model_load_s)
        # fault injection for tests: loading any of these ids raises,
        # exercising the router's load-failure route-around
        self.model_load_fail_ids = set(model_load_fail_ids or ())
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _gc
        from ray_tpu_torch.serve.multiplex import _ModelCache
        self._models = _ModelCache(
            type(self)._load_model,
            max_models if max_models is not None
            else _gc.serve_max_models_per_replica,
            unloader=type(self)._unload_model)
        self._unpublished: set = set()
        self._model_backlog: Dict[str, int] = {}
        self.metrics: Dict[str, Any] = {
            "requests": 0, "tokens_generated": 0, "rejected": 0,
            "prefix_hits": 0, "prefix_hit_tokens": 0,
            "admit_s": 0.0, "decode_block_s": 0.0,
            "ttft_sum": 0.0, "ttft_count": 0,
            # disagg counters (stay 0 in monolithic mode)
            "prefills": 0, "prefill_tokens": 0,
            "global_prefix_hits": 0, "global_prefix_hit_tokens": 0,
            "decodes": 0, "handoffs_lost": 0,
            "interference_stall_s": 0.0,
            # multiplex counters + the per-request context observations
            # the compiled-vs-legacy propagation test asserts on
            "model_loads": 0, "model_evictions": 0,
            "ctx_model_ids": [], "ctx_tenants": []}

    # -- model multiplexing --------------------------------------------------

    async def _load_model(self, model_id: str) -> Dict[str, Any]:
        await asyncio.sleep(self.model_load_s)
        if model_id in self.model_load_fail_ids:
            raise RuntimeError(f"injected load failure for {model_id!r}")
        with self._lock:
            self.metrics["model_loads"] += 1
        return {"model_id": model_id}

    def _unload_model(self, model_id: str, obj) -> None:
        with self._lock:
            self.metrics["model_evictions"] += 1

    async def load_model(self, model_id: str) -> List[str]:
        self._unpublished.discard(model_id)
        await self._models.get(self, model_id)
        return self.loaded_models()

    def unpublish_model(self, model_id: str) -> bool:
        if model_id in self._models.cache:
            self._unpublished.add(model_id)
            return True
        return False

    async def unload_model(self, model_id: str) -> bool:
        self._unpublished.discard(model_id)
        return await self._models.unload(self, model_id)

    def loaded_models(self) -> List[str]:
        return [m for m in self._models.models()
                if m not in self._unpublished]

    def model_queue_len(self, model_id: str) -> int:
        with self._lock:
            return self._model_backlog.get(model_id, 0)

    def model_stats(self) -> Dict[str, Any]:
        with self._lock:
            queues = dict(self._model_backlog)
        return {
            "models": self.loaded_models(),
            "resident": self._models.models(),
            "queues": queues,
            "loads": self.metrics["model_loads"],
            "evictions": self.metrics["model_evictions"],
            "retiring": 0,
            "draining": self._draining,
        }

    # -- disagg plumbing (mode="prefill" / "decode") -------------------------

    def _ensure_transfer(self):
        """Lazily build the exporter/adopter pair: both need the
        in-actor runtime (zero-copy put/get + gcs_call), which exists
        once the replica runs but not necessarily at construction."""
        from ray_tpu_torch.serve.kv_transfer import (HandoffAdopter,
                                                     HandoffExporter,
                                                     PrefixDirectory)
        if self._adopter is None:
            self._adopter = HandoffAdopter()
        if self._exporter is None and self.mode == "prefill":
            import uuid
            directory = PrefixDirectory() if self.use_directory else None
            self._exporter = HandoffExporter(
                owner=f"sim-{uuid.uuid4().hex[:12]}",
                page_tokens=self.page_tokens,
                group_pages=self.group_pages,
                retained_groups=self.retained_groups,
                directory=directory)

    def _global_adopt(self, prompt: List[int]) -> int:
        """Resolve the longest directory-warm leading run of page
        groups; groups owned elsewhere are fetched once (zero-copy get)
        and seeded into our exporter so OUR envelopes re-reference the
        original store objects instead of re-putting them. Returns warm
        tokens (any owner)."""
        from ray_tpu_torch.serve.kv_transfer import group_boundary_hashes
        ex = self._exporter
        if ex is None or ex.directory is None:
            return 0
        gb = group_boundary_hashes(prompt, self.page_tokens,
                                   self.group_pages)
        hits = ex.directory.lookup(gb)
        warm, foreign = 0, []
        for h, e in zip(gb, hits):
            if e is None:
                break
            warm += 1
            if e["owner"] != ex.owner and not ex.has(h):
                foreign.append((h, e))
        if foreign:
            self._adopter.adopt({"groups": [
                {"hash": h, "ref": e["ref"], "nbytes": e["nbytes"]}
                for h, e in foreign]})
            ex.seed([(h, e["ref"], e["nbytes"]) for h, e in foreign])
        return warm * ex.group_tokens

    # -- prefix cache sim: leading full pages by content hash ---------------

    def _page_hashes(self, prompt: List[int]) -> List[tuple]:
        out, acc = [], []
        for i in range(0, len(prompt) - len(prompt) % _PAGE, _PAGE):
            acc.extend(prompt[i:i + _PAGE])
            out.append(tuple(acc))
        return out

    def _match_and_register(self, prompt: List[int]) -> int:
        if not self.prefix_caching:
            return 0
        hashes = self._page_hashes(prompt)
        matched = 0
        for h in hashes:
            if h in self._cached_pages:
                matched += _PAGE
            else:
                break
        for h in hashes:   # touch + register (LRU order)
            self._cached_pages[h] = None
            self._cached_pages.move_to_end(h)
        while len(self._cached_pages) > self.prefix_cache_pages:
            self._cached_pages.popitem(last=False)
        if matched:
            self.metrics["prefix_hits"] += 1
            self.metrics["prefix_hit_tokens"] += matched
        return matched

    # -- serving contract ----------------------------------------------------

    async def stream_request(self, request) -> Any:
        from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                                   get_request_tenant)
        body = request if isinstance(request, dict) else request.json()
        prompt = list(body["prompt"])
        max_new = int(body.get("max_new_tokens", 32))
        model = str(body.get("model") or get_multiplexed_model_id() or "")
        with self._lock:
            # record the context this call actually observed (the
            # compiled-vs-legacy propagation test reads these; bounded)
            for k, v in (("ctx_model_ids", get_multiplexed_model_id()),
                         ("ctx_tenants", get_request_tenant())):
                lst = self.metrics[k]
                lst.append(v)
                if len(lst) > 512:
                    del lst[:-256]
            backlog = self._pending + self._active
            if self._draining or (self.max_queue_depth is not None
                                  and backlog >= self.max_queue_depth):
                self.metrics["rejected"] += 1
                shed = True
            else:
                self.metrics["requests"] += 1
                self._pending += 1
                if model:
                    self._model_backlog[model] = \
                        self._model_backlog.get(model, 0) + 1
                shed = False
        if shed or (model and model in self._unpublished):
            if not shed:   # admitted above, roll back before shedding
                with self._lock:
                    self._pending -= 1
                    self._model_backlog[model] -= 1
                    self.metrics["requests"] -= 1
                    self.metrics["rejected"] += 1
            yield {"error": (f"model {model!r} draining on this replica"
                             if not shed else
                             "sim queue full" if not self._draining
                             else "replica draining"),
                   "status": 429, "done": True}
            return
        if model and self.multiplexed:
            try:
                # cold replicas pay the load here — the wall-clock cost
                # model-affinity routing avoids on warm replicas
                await self._models.get(self, model)
            except Exception as e:
                with self._lock:
                    self._pending -= 1
                    self._model_backlog[model] -= 1
                yield {"error": f"model load failed: {e}", "status": 503,
                       "done": True}
                return
        t_sub = time.time()
        async with self._slots:
            with self._lock:
                self._pending -= 1
                self._active += 1
                matched = self._match_and_register(prompt)
            try:
                t0 = time.time()
                # prefill cost scales with the UNCACHED prompt tail —
                # this is the wall-clock effect prefix affinity buys
                with self._lock:
                    self._prefill_active += 1
                try:
                    await asyncio.sleep(
                        self.prefill_s_per_token * (len(prompt) - matched))
                finally:
                    with self._lock:
                        self._prefill_active -= 1
                dt = time.time() - t0
                with self._lock:
                    self.metrics["admit_s"] += dt
                L = len(prompt)
                ttft = None
                i = 0
                while i < max_new:
                    n = min(self.tokens_per_frame, max_new - i)
                    t1 = time.time()
                    base = self.decode_s_per_token * n
                    with self._lock:
                        stall = base * self.colocation_interference \
                            * self._prefill_active
                        self.metrics["interference_stall_s"] += stall
                    await asyncio.sleep(base + stall)
                    with self._lock:
                        self.metrics["decode_block_s"] += time.time() - t1
                        self.metrics["tokens_generated"] += n
                    if ttft is None:
                        ttft = time.time() - t_sub
                        with self._lock:
                            self.metrics["ttft_sum"] += ttft
                            self.metrics["ttft_count"] += 1
                    yield {"tokens": [L + j for j in range(i, i + n)]}
                    i += n
                yield {"done": True, "n_tokens": max_new, "ttft_s": ttft}
            finally:
                with self._lock:
                    self._active -= 1
                    if model:
                        self._model_backlog[model] = max(
                            0, self._model_backlog.get(model, 0) - 1)

    async def prefill_request(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """mode="prefill": run (only) the prefill for `body["prompt"]`,
        export the filled page groups through the zero-copy store, and
        return the handoff envelope. Deterministic: prefill wall-clock
        scales with the tokens NOT covered by the replica-local page
        cache or the global prefix directory — a directory hit on a
        second replica skips the shared prefix entirely."""
        assert self.mode == "prefill", self.mode
        import numpy as np
        self._ensure_transfer()
        prompt = list(body["prompt"])
        with self._lock:
            backlog = self._pending + self._active
            if self._draining or (self.max_queue_depth is not None
                                  and backlog >= self.max_queue_depth):
                self.metrics["rejected"] += 1
                return {"error": "sim queue full" if not self._draining
                        else "replica draining", "status": 429}
            self.metrics["requests"] += 1
            self._pending += 1
        async with self._slots:
            with self._lock:
                self._pending -= 1
                self._active += 1
            try:
                t0 = time.time()
                matched = self._match_and_register(prompt)
                # directory lookup + store put are blocking runtime
                # calls — banned on the event-loop thread (raylint
                # blocking-in-async), so hop to an executor thread
                warm = await asyncio.to_thread(self._global_adopt, prompt)
                skip = max(matched, warm)
                if warm > matched:
                    with self._lock:
                        self.metrics["global_prefix_hits"] += 1
                        self.metrics["global_prefix_hit_tokens"] += \
                            warm - matched
                await asyncio.sleep(
                    self.prefill_s_per_token * (len(prompt) - skip))
                envelope = await asyncio.to_thread(
                    self._exporter.export,
                    prompt,
                    lambda s, e: np.asarray(prompt[s:e], np.int32),
                    lambda a: int(a.nbytes))
                dt = time.time() - t0
                with self._lock:
                    self.metrics["admit_s"] += dt
                    self.metrics["prefills"] += 1
                    self.metrics["prefill_tokens"] += len(prompt) - skip
                return {"envelope": envelope, "matched_tokens": skip,
                        "prefill_s": dt}
            finally:
                with self._lock:
                    self._active -= 1

    def ack_handoff(self, handoff_id: str) -> bool:
        """Router ack: the decode replica adopted (or the attempt was
        abandoned) — release this handoff's pins."""
        if self._exporter is None:
            return False
        return self._exporter.ack(handoff_id)

    async def adopt_decode(self, envelope: Dict[str, Any], body) -> Any:
        """mode="decode": map the envelope's page groups in from the
        store (no re-serialize), then stream decode frames with the same
        token-continuity contract as stream_request — token i of a
        prompt of length L is L + i, so failover asserts stay exact."""
        assert self.mode == "decode", self.mode
        self._ensure_transfer()
        body = body if isinstance(body, dict) else body.json()
        max_new = int(body.get("max_new_tokens", 32))
        with self._lock:
            backlog = self._pending + self._active
            if self._draining or (self.max_queue_depth is not None
                                  and backlog >= self.max_queue_depth):
                self.metrics["rejected"] += 1
                shed = True
            else:
                self.metrics["requests"] += 1
                self._pending += 1
                shed = False
        if shed:
            yield {"error": "sim queue full" if not self._draining
                   else "replica draining", "status": 429, "done": True}
            return
        t_sub = time.time()
        async with self._slots:
            with self._lock:
                self._pending -= 1
                self._active += 1
            try:
                try:
                    # blocking zero-copy gets: executor thread, not loop
                    await asyncio.to_thread(self._adopter.adopt, envelope)
                except Exception:
                    # the exporter (or its store) died before we mapped
                    # the pages in: tell the router to re-prefill
                    with self._lock:
                        self.metrics["handoffs_lost"] += 1
                    yield {"handoff_lost": True, "done": True}
                    return
                L = int(envelope.get("prompt_len", 0))
                ttft = None
                i = 0
                while i < max_new:
                    n = min(self.tokens_per_frame, max_new - i)
                    t1 = time.time()
                    await asyncio.sleep(self.decode_s_per_token * n)
                    with self._lock:
                        self.metrics["decode_block_s"] += time.time() - t1
                        self.metrics["tokens_generated"] += n
                    if ttft is None:
                        ttft = time.time() - t_sub
                        with self._lock:
                            self.metrics["ttft_sum"] += ttft
                            self.metrics["ttft_count"] += 1
                    yield {"tokens": [L + j for j in range(i, i + n)]}
                    i += n
                with self._lock:
                    self.metrics["decodes"] += 1
                yield {"done": True, "n_tokens": max_new, "ttft_s": ttft,
                       "handoff_id": envelope.get("handoff_id")}
            finally:
                with self._lock:
                    self._active -= 1

    async def __call__(self, request) -> Dict[str, Any]:
        tokens: List[int] = []
        final: Dict[str, Any] = {}
        async for frame in self.stream_request(request):
            if frame.get("status") == 429:
                from ray_tpu_torch.serve.http_proxy import Response

                return Response({"error": frame.get("error")},
                                status_code=429,
                                headers={"Retry-After": "1"})
            if frame.get("done"):
                final = frame
            tokens.extend(frame.get("tokens", []))
        return {"tokens": tokens, "ttft_s": final.get("ttft_s")}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            m = dict(self.metrics)
            m["pending"] = self._pending
            m["active_slots"] = self._active
            m["max_slots"] = self.max_slots
            m["draining"] = self._draining
            m["mode"] = self.mode
            if self.multiplexed:
                m["model_queue"] = dict(self._model_backlog)
        if self.multiplexed:
            m["models"] = self.loaded_models()
        if m["ttft_count"]:
            m["mean_ttft_s"] = m["ttft_sum"] / m["ttft_count"]
        if self._exporter is not None:
            m.update({f"handoff_{k}": v
                      for k, v in self._exporter.stats().items()})
        if self._adopter is not None:
            m.update({f"adopt_{k}": v
                      for k, v in self._adopter.stats().items()})
        return m

    def queue_len(self) -> int:
        with self._lock:
            return self._pending + self._active

    def drain(self) -> None:
        self._draining = True
        if self._exporter is not None:
            # unpin retained + in-flight page groups and withdraw our
            # directory entries before the controller kills us
            self._exporter.close()


def build_llm_app(*, name: str = "llm_server",
                  num_replicas: int = 2,
                  router_policy: str = "affinity",
                  autoscaling_config: Optional[dict] = None,
                  model_autoscaling_config: Optional[dict] = None,
                  tenant_weights: Optional[dict] = None,
                  use_sim: bool = False,
                  router_kwargs: Optional[dict] = None,
                  disaggregated: bool = False,
                  prefill_replicas: Optional[int] = None,
                  decode_replicas: Optional[int] = None,
                  prefill_autoscaling_config: Optional[dict] = None,
                  decode_autoscaling_config: Optional[dict] = None,
                  **llm_kwargs) -> Any:
    """Build the router-fronted serving application. llm_kwargs go to
    LLMServer (preset, max_slots, kv_layout, ...) — or to SimLLMServer
    when use_sim=True (tests/bench). Returns the Application; deploy
    with serve.run(app, route_prefix=...).

    disaggregated=True builds the two-pool topology instead
    (serve/disagg.py): `{name}_prefill` x prefill_replicas and
    `{name}_decode` x decode_replicas behind a DisaggRouter ingress.
    Prefill replicas fill paged-KV pages and export them through the
    zero-copy store; decode replicas adopt and stream. Each pool
    autoscales independently (the router report_loads per pool)."""
    if use_sim:
        server_cls = SimLLMServer
    else:
        from ray_tpu_torch.serve.llm import LLMServer

        server_cls = LLMServer
    if disaggregated:
        from ray_tpu_torch.serve.disagg import DisaggRouter

        n_pf = prefill_replicas if prefill_replicas is not None \
            else max(1, num_replicas // 2)
        n_dec = decode_replicas if decode_replicas is not None \
            else max(1, num_replicas - n_pf)
        prefill = serve_api.deployment(
            server_cls, name=f"{name}_prefill", num_replicas=n_pf,
            autoscaling_config=prefill_autoscaling_config).bind(
            mode="prefill", **llm_kwargs)
        decode = serve_api.deployment(
            server_cls, name=f"{name}_decode", num_replicas=n_dec,
            autoscaling_config=decode_autoscaling_config).bind(
            mode="decode", **llm_kwargs)
        router = serve_api.deployment(
            DisaggRouter, name=f"{name}_router", num_replicas=1).bind(
            decode, prefill_app=prefill, policy=router_policy,
            **(router_kwargs or {}))
        return router
    llm = serve_api.deployment(
        server_cls, name=name, num_replicas=num_replicas,
        autoscaling_config=autoscaling_config,
        model_autoscaling_config=model_autoscaling_config).bind(
        **llm_kwargs)
    rkw = dict(router_kwargs or {})
    if tenant_weights is not None:
        rkw.setdefault("tenant_weights", tenant_weights)
    router = serve_api.deployment(
        LLMRouter, name=f"{name}_router", num_replicas=1).bind(
        llm, policy=router_policy, **rkw)
    return router
