"""Model multiplexing: many models per replica with LRU load/unload.

Reference: python/ray/serve/multiplex.py — @serve.multiplexed caches up to
max_num_models_per_replica models per replica keyed by the model id that the
caller sets via handle.options(multiplexed_model_id=...); the loader is the
decorated (async) method; serve.get_multiplexed_model_id() reads the id of
the current request.

Beyond the reference shape, this module carries the fleet layer's
per-request context (the tenant tag rides the same contextvar channel as
the model id) and the ModelRegistry: model weights are published ONCE
into the object store and resolved by model id through the GCS KV, so N
replicas on a node share one pinned zero-copy reading of the blob and
cold-model eviction costs nothing the spill tier can't restore.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import itertools
import pickle
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.util import metrics as _um

_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")
_tenant: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_request_tenant", default="")


def get_multiplexed_model_id() -> str:
    """Model id requested by the current call ('' if unset)."""
    return _model_id.get()


def _set_multiplexed_model_id(model_id: str):
    _model_id.set(model_id or "")


def get_request_tenant() -> str:
    """Tenant tag of the current call ('' if unset)."""
    return _tenant.get()


def _set_request_tenant(tenant: str):
    _tenant.set(tenant or "")


_cache_seq = itertools.count()

# Module-held instruments (the metrics registry is weak — instruments
# owned here outlive any one cache). Series split per cache via the tag.
_m_loaded = _um.Gauge(
    "ray_tpu_serve_models_loaded",
    "models resident in a replica's multiplex LRU",
    tag_keys=("cache",))
_m_evictions = _um.Counter(
    "ray_tpu_serve_model_evictions",
    "LRU evictions from replicas' multiplex caches",
    tag_keys=("cache",))


class _ModelCache:
    """Async LRU of loaded models with in-flight load dedup.

    Concurrent get()s of the same cold model share ONE loader call via a
    future; a loader failure wakes every waiter with the exception and
    leaves the id retryable. Eviction (LRU overflow or explicit
    unload()) runs the `unloader` hook so the evicted engine releases
    its page pool / device memory instead of leaking until GC.
    """

    def __init__(self, loader: Callable, max_models: int,
                 unloader: Optional[Callable] = None, name: str = ""):
        self.loader = loader
        self.unloader = unloader
        self.max_models = max_models
        self.cache: OrderedDict = OrderedDict()
        # immutable membership snapshot, republished under the lock on
        # every insert/evict: threads outside the event loop (the
        # replica's decode loop) iterate THIS, never the live
        # OrderedDict — get()'s move_to_end/popitem would otherwise race
        # their iteration with "dict mutated during iteration"
        self._values: tuple = ()
        self.loading: dict = {}   # model_id -> Future (in-flight dedup)
        self.lock = asyncio.Lock()
        self.name = name or f"cache-{next(_cache_seq)}"
        self._tags = {"cache": self.name}
        self.load_count = 0
        self.eviction_count = 0

    def models(self) -> List[str]:
        """Loaded model ids, LRU-first."""
        return list(self.cache.keys())

    def snapshot_items(self) -> List[Tuple[str, Any]]:
        return list(self.cache.items())

    def values_snapshot(self) -> Tuple[Any, ...]:
        """Loaded model objects as an immutable tuple — safe to iterate
        from any thread while the event loop mutates the cache."""
        return self._values

    def __contains__(self, model_id: str) -> bool:
        return model_id in self.cache

    async def get(self, owner, model_id: str):
        async with self.lock:
            if model_id in self.cache:
                self.cache.move_to_end(model_id)
                return self.cache[model_id]
            fut = self.loading.get(model_id)
            if fut is None:
                fut = asyncio.get_event_loop().create_future()
                self.loading[model_id] = fut
                is_loader = True
            else:
                is_loader = False
        if not is_loader:
            # someone else is loading this model; share their result
            return await asyncio.shield(fut)
        try:
            out = self.loader(owner, model_id)
            if asyncio.iscoroutine(out):
                out = await out
        except BaseException as e:
            async with self.lock:
                # clear the in-flight entry AND wake waiters with the
                # failure in one critical section — a waiter arriving
                # between the two would otherwise hang on an orphaned
                # future while the id looks retryable
                self.loading.pop(model_id, None)
                if not fut.done():
                    fut.set_exception(e)
                if fut.done() and not fut.cancelled():
                    fut.exception()   # consume: no "never retrieved"
                                      # warning when no waiter shows up
            raise
        evicted: List[Tuple[str, Any]] = []
        async with self.lock:
            self.cache[model_id] = out
            self.cache.move_to_end(model_id)
            self.loading.pop(model_id, None)
            while len(self.cache) > self.max_models:
                evicted.append(self.cache.popitem(last=False))
            self._values = tuple(self.cache.values())
            self.load_count += 1
            _m_loaded.set(len(self.cache), tags=self._tags)
        for mid, obj in evicted:
            await self._run_unloader(owner, mid, obj)
        if not fut.done():
            fut.set_result(out)
        return out

    async def unload(self, owner, model_id: str) -> bool:
        """Explicitly evict one model (controller scale-down path)."""
        async with self.lock:
            obj = self.cache.pop(model_id, None)
            if obj is not None:
                self._values = tuple(self.cache.values())
                _m_loaded.set(len(self.cache), tags=self._tags)
        if obj is None:
            return False
        await self._run_unloader(owner, model_id, obj)
        return True

    async def _run_unloader(self, owner, model_id: str, obj):
        self.eviction_count += 1
        _m_evictions.inc(tags=self._tags)
        _m_loaded.set(len(self.cache), tags=self._tags)
        if self.unloader is not None:
            try:
                maybe = self.unloader(owner, model_id, obj)
                if asyncio.iscoroutine(maybe):
                    await maybe
            except Exception:
                pass
        # best-effort legacy unload hook (ref: __del__-based unload)
        unload = getattr(obj, "__serve_unload__", None)
        if callable(unload):
            try:
                maybe = unload()
                if asyncio.iscoroutine(maybe):
                    await maybe
            except Exception:
                pass


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3,
                unloader: Optional[Callable] = None):
    """Decorator for the per-replica model loader method. `unloader`,
    if given, is called as unloader(self, model_id, model) when the LRU
    evicts a model."""

    def deco(loader: Callable):
        cache_attr = f"__serve_multiplex_cache_{loader.__name__}"

        @functools.wraps(loader)
        async def wrapper(self, model_id: str):
            cache = getattr(self, cache_attr, None)
            if cache is None:
                cache = _ModelCache(loader, max_num_models_per_replica,
                                    unloader=unloader)
                setattr(self, cache_attr, cache)
            return await cache.get(self, model_id)

        return wrapper

    if func is not None:
        return deco(func)
    return deco


_REGISTRY_NS = "serve_models"


class ModelRegistry:
    """Fleet-wide model-weights registry over the object store.

    publish() puts the weights blob once and maps model_id -> pickled
    ObjectRef in the GCS KV; fetch() on any node resolves the ref — a
    zero-copy local read when a copy is already node-resident, so N
    replicas on one node share a single pinned copy instead of N
    deserialized clones. The publisher keeps its ref alive in
    `_published` (the pin); evicted/spilled copies restore transparently
    through the store's spill tier, which is what makes cold-model LRU
    eviction on replicas free.
    """

    def __init__(self):
        from ray_tpu_torch.core import runtime as _rt
        self._rt = _rt.get_runtime()
        self._published: Dict[str, Any] = {}   # model_id -> ObjectRef pin

    def publish(self, model_id: str, weights: Any):
        """Put `weights` into the object store and register the ref
        under `model_id`. Returns the ObjectRef."""
        import ray_tpu_torch
        ref = ray_tpu_torch.put(weights)
        self._published[model_id] = ref
        self._rt.kv_put(_REGISTRY_NS, model_id.encode(), pickle.dumps(ref))
        return ref

    def contains(self, model_id: str) -> bool:
        return self._rt.kv_get(_REGISTRY_NS, model_id.encode()) is not None

    def ref(self, model_id: str):
        raw = self._rt.kv_get(_REGISTRY_NS, model_id.encode())
        if raw is None:
            raise KeyError(f"model {model_id!r} is not published")
        return pickle.loads(raw)

    def fetch(self, model_id: str, timeout: Optional[float] = 30.0) -> Any:
        """Resolve the published weights for `model_id` (KeyError if the
        id was never published)."""
        import ray_tpu_torch
        return ray_tpu_torch.get(self.ref(model_id), timeout=timeout)
