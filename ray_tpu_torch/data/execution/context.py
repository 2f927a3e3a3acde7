"""DataContext: process-wide knobs for the streaming executor.

Reference: python/ray/data/context.py (DataContext.get_current) — a
singleton the Dataset execution paths consult, overridable per test or
per workload without threading parameters through every API.

A copy of ``ray_tpu/data/execution/context.py``; the runtime's config
is ``ray_tpu_torch.core.config.Config``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_POLICIES = ("auto", "fused", "streaming", "compiled")


@dataclass
class DataContext:
    #: "auto" (fused for single-op chains, streaming otherwise),
    #: "fused" (the legacy windowed generator path), "streaming", or
    #: "compiled" (whole chain fused onto a compiled-graph actor pool —
    #: standing channels, no per-block task dispatch; opt-in, never
    #: chosen by "auto")
    execution_policy: str = "auto"
    #: overrides Config.data_execution_budget_fraction when set
    budget_fraction: Optional[float] = None
    #: exact per-operator output budget (bytes); wins over the fraction
    per_op_budget_bytes: Optional[int] = None
    #: max concurrent tasks per operator (None -> Config value)
    max_tasks_per_op: Optional[int] = None
    #: actor-pool width for the "compiled" policy's fused chain operator
    compiled_pool_size: int = 2

    _current: "Optional[DataContext]" = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = cls()
        return cls._current

    def resolve_policy(self, explicit: Optional[str],
                       num_ops: int) -> str:
        pol = explicit or self.execution_policy
        if pol not in _POLICIES:
            raise ValueError(f"unknown execution policy {pol!r}; "
                             f"use one of {_POLICIES}")
        if pol == "auto":
            return "streaming" if num_ops > 1 else "fused"
        return pol

    def resolved_max_tasks_per_op(self) -> int:
        if self.max_tasks_per_op is not None:
            return self.max_tasks_per_op
        from ray_tpu_torch.core import runtime as rt

        r = rt.current_runtime_or_none()
        return (r.cfg.data_execution_max_tasks_per_op if r is not None
                else 4)


def get_context() -> DataContext:
    return DataContext.get_current()
