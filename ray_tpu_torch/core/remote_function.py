"""@ray_tpu_torch.remote for functions.

Reference: python/ray/remote_function.py:245 (RemoteFunction._remote → core
worker submit at :391) and option resolution in _private/ray_option_utils.py.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.core.common import ResourceSet, SchedulingStrategy
from ray_tpu_torch.core import runtime as rt


_TASK_OPTIONS = {
    "num_cpus", "num_gpus", "memory", "resources", "num_returns",
    "max_retries", "retry_exceptions", "scheduling_strategy", "name",
    "runtime_env", "generator_backpressure", "generator_backpressure_bytes",
}


class RemoteFunction:
    def __init__(self, fn: Callable, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        # options are immutable per RemoteFunction: build the ResourceSet
        # once, not per .remote() call (deep queues submit millions; the
        # spec pickles a copy on the wire, nothing mutates it owner-side)
        self._resources = ResourceSet.from_options(
            self._options.get("num_cpus"), self._options.get("num_gpus"),
            self._options.get("memory"), self._options.get("resources"))
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        bad = set(opts) - _TASK_OPTIONS
        if bad:
            raise ValueError(f"invalid task options: {sorted(bad)}")
        merged = dict(self._options)
        merged.update(opts)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.common import STREAMING

        o = self._options
        runtime = rt.get_runtime()
        nr = o.get("num_returns", 1)
        if nr in ("streaming", "dynamic"):
            nr = STREAMING   # generator task (ref: num_returns="dynamic")
        refs = runtime.submit_task(
            self._fn, args, kwargs,
            name=o.get("name") or getattr(self._fn, "__name__", "task"),
            num_returns=nr,
            resources=self._resources,
            max_retries=o.get("max_retries"),
            retry_exceptions=o.get("retry_exceptions", False),
            scheduling=o.get("scheduling_strategy"),
            runtime_env=o.get("runtime_env"),
            generator_backpressure=o.get("generator_backpressure"),
            generator_backpressure_bytes=o.get(
                "generator_backpressure_bytes"))
        if nr == STREAMING:
            return refs   # an ObjectRefGenerator
        if nr == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node (ref: ray.dag — DAGNode via .bind())."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._fn, '__name__', '?')}' cannot be "
            "called directly; use .remote().")
