"""Actor API: @ray_tpu_torch.remote on classes, handles, method calls.

Reference: python/ray/actor.py — ActorClass._remote:665 (create), method
proxies ActorMethod._remote:167, restart options actor.py:332-351
(max_restarts / max_task_retries). Handles are serializable; a deserialized
handle resolves the actor's current address through the GCS, so handles keep
working across actor restarts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.core.common import ResourceSet, SchedulingStrategy
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core import runtime as rt


_ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "memory", "resources", "name", "namespace",
    "max_restarts", "max_task_retries", "max_concurrency",
    "scheduling_strategy", "lifetime", "runtime_env",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: Optional[int] = None) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           num_returns if num_returns is not None else self._num_returns)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.common import STREAMING

        nr = self._num_returns
        if nr in ("streaming", "dynamic"):
            nr = STREAMING
        runtime = rt.get_runtime()
        refs = runtime.submit_actor_call(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=nr,
            max_task_retries=self._handle._max_task_retries)
        if nr == STREAMING:
            return refs   # an ObjectRefGenerator
        if nr == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor method '{self._name}' must be called with .remote().")


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_meta: Dict[str, int],
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._max_task_retries = max_task_retries

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._method_meta
        if meta and name not in meta:
            raise AttributeError(f"actor has no method {name!r}")
        return ActorMethod(self, name, meta.get(name, 1) if meta else 1)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_meta,
                              self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})

    def options(self, **opts) -> "ActorClass":
        bad = set(opts) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"invalid actor options: {sorted(bad)}")
        merged = dict(self._options)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        o = self._options
        runtime = rt.get_runtime()
        resources = ResourceSet.from_options(
            o.get("num_cpus"), o.get("num_gpus"), o.get("memory"),
            o.get("resources"))
        actor_id = runtime.create_actor(
            self._cls, args, kwargs,
            name=o.get("name"), namespace=o.get("namespace", "default"),
            resources=resources,
            max_restarts=o.get("max_restarts",
                               runtime.cfg.actor_max_restarts_default),
            max_concurrency=o.get("max_concurrency", 1),
            scheduling=o.get("scheduling_strategy") or SchedulingStrategy(),
            lifetime=o.get("lifetime"),
            runtime_env=o.get("runtime_env"))
        return ActorHandle(actor_id, _method_meta(self._cls),
                           o.get("max_task_retries", 0))

    def bind(self, *args, **kwargs):
        """Build a lazy actor DAG node (ref: ray.dag ClassNode)."""
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly; use .remote().")


def _method_meta(cls: type) -> Dict[str, int]:
    meta = {}
    for name in dir(cls):
        if name.startswith("__"):
            continue
        m = getattr(cls, name, None)
        if callable(m):
            meta[name] = getattr(m, "_ray_tpu_torch_num_returns", 1)
    return meta


def method(num_returns: int = 1):
    """@ray_tpu_torch.method(num_returns=N) on actor methods (ref: @ray.method)."""
    def deco(fn):
        fn._ray_tpu_torch_num_returns = num_returns
        return fn
    return deco


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    """ref: ray.get_actor — named actor lookup via GCS."""
    runtime = rt.get_runtime()
    r = runtime.gcs_call("get_named_actor", name=name, namespace=namespace)
    if r is None:
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    spec = r["spec"]
    cls = runtime.load_function(spec.func_id)
    return ActorHandle(spec.actor_id, _method_meta(cls), 0)
