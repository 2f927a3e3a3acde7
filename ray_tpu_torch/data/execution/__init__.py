"""ray_tpu_torch.data.execution: the streaming, budget-aware executor.

The Data layer's physical execution engine (reference:
python/ray/data/_internal/execution/). A Dataset's logical op chain
compiles into a linear graph of PhysicalOperators — InputDataBuffer ->
map operators (task pool or actor pool) [-> OutputSplitter] — whose
queues carry block REFS + byte-size metadata, never blocks. The
StreamingExecutor's select_operator_to_run policy issues each next task
to the operator whose output queue is under a store-derived byte budget
(ResourceManager), so a slow downstream stage rate-limits its producers
instead of letting them flood the object store, while liveness rules
guarantee an idle pipeline always schedules.

`build_pipeline` is the compiler from (block_refs, logical ops) to a
ready StreamingExecutor; Dataset._iter_blocks / materialize /
_map_batches_actors / iter_split route through it. The legacy fused
path (one generator task per shard running the whole chain) survives as
the `fused` policy, the default for single-op chains.

A copy of ``ray_tpu/data/execution/__init__.py``.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ray_tpu_torch.data.execution.compiled_map import CompiledChainMapOperator
from ray_tpu_torch.data.execution.context import DataContext, get_context
from ray_tpu_torch.data.execution.interfaces import (BlockMeta, OpBuffer,
                                                     OpMetrics, PhysicalOperator,
                                                     RefBundle)
from ray_tpu_torch.data.execution.operators import (ActorPoolMapOperator,
                                                    InputDataBuffer,
                                                    OutputSplitter,
                                                    TaskPoolMapOperator)
from ray_tpu_torch.data.execution.resource_manager import (ResourceManager,
                                                           derive_budget_bytes)
from ray_tpu_torch.data.execution.streaming_executor import (
    StreamingExecutor, get_last_execution_stats)


def build_pipeline(block_refs: List[Any], logical_ops: List[tuple],
                   *, split: Optional[int] = None,
                   context: Optional[DataContext] = None,
                   policy: Optional[str] = None
                   ) -> StreamingExecutor:
    """Compile a Dataset plan into a StreamingExecutor: one
    TaskPoolMapOperator per logical op (each independently scheduled —
    that's the cross-operator pipelining), plus an optional
    OutputSplitter sink for per-host shard iterators. Under
    policy="compiled" the whole chain fuses into one
    CompiledChainMapOperator riding standing channels instead."""
    ctx = context or get_context()
    max_in_flight = ctx.resolved_max_tasks_per_op()
    ops: List[PhysicalOperator] = [InputDataBuffer(block_refs)]
    if policy == "compiled" and logical_ops:
        from ray_tpu_torch.data.execution.compiled_map import \
            CompiledChainMapOperator

        name = "+".join(spec[0] for spec in logical_ops)
        ops.append(CompiledChainMapOperator(
            name, logical_ops, ops[-1],
            pool_size=ctx.compiled_pool_size,
            max_in_flight=max_in_flight))
    else:
        for spec in logical_ops:
            ops.append(TaskPoolMapOperator(
                spec[0], [spec], ops[-1], max_in_flight=max_in_flight))
    if split is not None:
        ops.append(OutputSplitter(ops[-1], split))
    rm = ResourceManager(
        ops,
        total_budget_bytes=(derive_budget_bytes(ctx.budget_fraction)
                            if ctx.per_op_budget_bytes is None else None),
        per_op_budget_bytes=ctx.per_op_budget_bytes)
    return StreamingExecutor(ops, rm)


__all__ = [
    "ActorPoolMapOperator", "BlockMeta", "CompiledChainMapOperator",
    "DataContext", "InputDataBuffer",
    "OpBuffer", "OpMetrics", "OutputSplitter", "PhysicalOperator",
    "RefBundle", "ResourceManager", "StreamingExecutor", "build_pipeline",
    "derive_budget_bytes", "get_context", "get_last_execution_stats",
]
