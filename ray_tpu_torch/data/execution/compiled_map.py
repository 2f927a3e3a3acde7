"""CompiledChainMapOperator: the whole logical op chain as ONE physical
operator running over standing channels (ray_tpu_torch.dag.compiled).

The task-pool path pays a full submit round per block per operator:
build a task spec, lease a worker, ship the spec, watch the reply. For
a FIXED chain of pure map ops none of that per-call work carries
information — the chain is the same every block. Under the "compiled"
execution policy, build_pipeline fuses the chain into this operator: a
small pool of `_ChainWorker` actors, each fronted by a compiled
`InputNode -> worker.apply` graph whose channel was negotiated once at
start(). Per block, submit_next() is one oneway frame enqueue
(CompiledDAG.execute), and results stream back on the standing result
edge — no task specs, no scheduler round, no reply round-trips.

Data plane: the block REF rides the input frame (refs pickle to
borrows); the worker fetches, transforms, and returns the transformed
block inline on the result frame. The driver re-put()s it so the
resulting bundle ref is DRIVER-owned and survives pool teardown — the
pool actors die with the run, materialized blocks must not.

In-flight work here is CompiledDAGRefs, not ObjectRefs, so watch_refs()
is empty; the StreamingExecutor's idle branch covers that case by
napping briefly when any operator reports untracked in-flight work.

A copy of ``ray_tpu/data/execution/compiled_map.py`` over the port's
``dag/`` (``ray_tpu_torch.dag.InputNode``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Tuple

from ray_tpu_torch.data.execution.interfaces import (BlockMeta, PhysicalOperator,
                                                     RefBundle)


class CompiledChainMapOperator(PhysicalOperator):
    """Fused map chain over a compiled-graph actor pool.

    Completion order is per-actor FIFO (channel sequence numbers) but
    round-robin across the pool interleaves, so a reorder buffer
    restores source-block order exactly like TaskPoolMapOperator."""

    budgetable = True

    def __init__(self, name: str, ops: List[tuple],
                 input_op: PhysicalOperator, pool_size: int = 2,
                 max_in_flight: int = 4,
                 num_cpus_per_actor: float = 0.25):
        super().__init__(name, input_op, max_in_flight)
        self._ops = list(ops)
        self._pool_size = max(1, pool_size)
        # fractional so the pool lane-packs instead of demanding a whole
        # core per actor (same reasoning as ActorPoolStrategy's 0.5)
        self._num_cpus = num_cpus_per_actor
        self._dags: List[Any] = []
        self._rr = 0
        self._pending: Deque[Tuple[Any, int]] = deque()  # (ref, idx)
        self._order: Deque[int] = deque()
        self._reorder: Dict[int, RefBundle] = {}
        self._reorder_bytes = 0

    def start(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.dag import InputNode

        # ops ride the class closure (cloudpickle), same as
        # ActorPoolMapOperator's _MapWorker — user lambdas don't survive
        # the plain-pickle ctor-arg path
        chain_ops = self._ops

        @ray_tpu_torch.remote
        class _ChainWorker:
            def apply(self, block_ref):
                import ray_tpu_torch
                from ray_tpu_torch.data.dataset import (_block_nbytes, _block_rows,
                                                        _transform_block)

                block = ray_tpu_torch.get(block_ref)
                out = _transform_block(block, chain_ops)
                return {"block": out, "nbytes": _block_nbytes(out),
                        "rows": _block_rows(out)}

        cls = _ChainWorker.options(num_cpus=self._num_cpus)
        for _ in range(self._pool_size):
            with InputNode() as inp:
                leaf = cls.bind().apply.bind(inp)
            self._dags.append(leaf.experimental_compile())

    def num_in_flight(self) -> int:
        return len(self._pending)

    def submit_next(self) -> None:
        bundle = self.input_op.output.popleft()
        dag = self._dags[self._rr % len(self._dags)]
        self._rr += 1
        ref = dag.execute(bundle.block_ref)
        self._pending.append((ref, bundle.index))
        self._order.append(bundle.index)
        self.metrics.tasks_submitted += 1

    def poll(self) -> bool:
        import ray_tpu_torch

        progressed = False
        still: Deque[Tuple[Any, int]] = deque()
        while self._pending:
            ref, idx = self._pending.popleft()
            if not ref.done():
                still.append((ref, idx))
                continue
            res = ref.get(timeout=30.0)  # raises the chain's error, if any
            out_ref = ray_tpu_torch.put(res["block"])
            meta = {"nbytes": res["nbytes"], "rows": res["rows"]}
            bundle = RefBundle(out_ref, BlockMeta(**meta), idx)
            self._reorder[idx] = bundle
            self._reorder_bytes += bundle.nbytes
            self.metrics.tasks_finished += 1
            self.metrics.rows_out += meta.get("rows") or 0
            self.metrics.bytes_out += meta.get("nbytes") or 0
            progressed = True
        self._pending = still
        while self._order and self._order[0] in self._reorder:
            idx = self._order.popleft()
            bundle = self._reorder.pop(idx)
            self._reorder_bytes -= bundle.nbytes
            self.output.append(bundle)
        return progressed

    def _held_bundles(self) -> bool:
        return bool(self._reorder)

    def queued_output_bytes(self) -> int:
        return self.output.nbytes + self._reorder_bytes

    def shutdown(self) -> None:
        dags, self._dags = self._dags, []
        for dag in dags:
            try:
                dag.teardown()
            except Exception:
                pass
