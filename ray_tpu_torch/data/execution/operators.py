"""Concrete physical operators.

Reference map (python/ray/data/_internal/execution/operators/):
  InputDataBuffer            -> input_data_buffer.py (pre-existing refs
                                presented as an exhausted-source operator)
  TaskPoolMapOperator        -> task_pool_map_operator.py (one stateless
                                task per block; (block, meta) two-return
                                so the scheduler sees sizes without
                                fetching blocks)
  ActorPoolMapOperator       -> actor_pool_map_operator.py (stateful UDF
                                classes on a fixed pool; rides
                                util.ActorPool's ordered get_next)
  OutputSplitter             -> output_splitter.py (round-robin shard
                                queues for per-host train feeds)

A copy of ``ray_tpu/data/execution/operators.py`` over the port's
runtime and ``ray_tpu_torch.util.actor_pool.ActorPool``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch.data.execution.interfaces import (BlockMeta, OpBuffer,
                                                     PhysicalOperator, RefBundle)


def _make_map_task(ops: List[tuple]):
    """Remote fn applying a slice of the logical op chain to one block;
    returns (block, meta) as TWO objects — the meta lands inline in the
    task reply (small), the block stays in the store."""
    import ray_tpu_torch
    from ray_tpu_torch.data.dataset import (_block_nbytes, _block_rows,
                                            _transform_block)

    @ray_tpu_torch.remote
    def _map_block(block):
        out = _transform_block(block, ops)
        return out, {"nbytes": _block_nbytes(out), "rows": _block_rows(out)}

    return _map_block


class InputDataBuffer(PhysicalOperator):
    """Source operator: its output queue is the dataset's block refs.

    Byte sizes come from the owner-side object directory
    (Runtime.object_nbytes) — no fetch, no RPC; refs whose producing
    task hasn't finished report None and stay unknown until a
    downstream estimate covers them. Source bytes are NOT budgeted
    (the blocks exist regardless of scheduling)."""

    def __init__(self, block_refs: List[Any]):
        super().__init__("input", None)
        self._refs = list(block_refs)

    def start(self) -> None:
        from ray_tpu_torch.core import runtime as rt

        r = rt.current_runtime_or_none()
        for i, ref in enumerate(self._refs):
            nbytes = r.object_nbytes(ref) if r is not None else None
            self.output.append(RefBundle(ref, BlockMeta(nbytes=nbytes), i))
            self.metrics.tasks_submitted += 1
            self.metrics.tasks_finished += 1
            self.metrics.bytes_out += nbytes or 0
        # source bundles are free to consume; keep the buffer's byte
        # counter out of budget math by reporting zero queued bytes
        self._refs = []

    def queued_output_bytes(self) -> int:
        return 0

    def completed(self) -> bool:
        return not self.output


class TaskPoolMapOperator(PhysicalOperator):
    """One stateless remote task per input block (ref:
    task_pool_map_operator.py). Tasks finish out of order; a reorder
    buffer releases bundles to `output` in input order so the sink's
    stream is bitwise-identical to the fused path's."""

    budgetable = True

    def __init__(self, name: str, ops: List[tuple],
                 input_op: PhysicalOperator, max_in_flight: int = 4):
        super().__init__(name, input_op, max_in_flight)
        self._task = _make_map_task(ops)
        self._in_flight: Dict[Any, Tuple[Any, int]] = {}  # meta_ref -> (block_ref, idx)
        self._order: Deque[int] = deque()                 # submission order
        self._reorder: Dict[int, RefBundle] = {}
        self._reorder_bytes = 0

    def num_in_flight(self) -> int:
        return len(self._in_flight)

    def submit_next(self) -> None:
        bundle = self.input_op.output.popleft()
        block_ref, meta_ref = self._task.options(num_returns=2).remote(
            bundle.block_ref)
        self._in_flight[meta_ref] = (block_ref, bundle.index)
        self._order.append(bundle.index)
        self.metrics.tasks_submitted += 1

    def poll(self) -> bool:
        import ray_tpu_torch

        if not self._in_flight:
            return False
        refs = list(self._in_flight)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        progressed = False
        for meta_ref in ready:
            block_ref, idx = self._in_flight.pop(meta_ref)
            meta = ray_tpu_torch.get(meta_ref)   # raises the task's error, if any
            bundle = RefBundle(block_ref, BlockMeta(**meta), idx)
            self._reorder[idx] = bundle
            self._reorder_bytes += bundle.nbytes
            self.metrics.tasks_finished += 1
            self.metrics.rows_out += meta.get("rows") or 0
            self.metrics.bytes_out += meta.get("nbytes") or 0
            progressed = True
        while self._order and self._order[0] in self._reorder:
            idx = self._order.popleft()
            bundle = self._reorder.pop(idx)
            self._reorder_bytes -= bundle.nbytes
            self.output.append(bundle)
        return progressed

    def watch_refs(self) -> List[Any]:
        return list(self._in_flight)

    def _held_bundles(self) -> bool:
        return bool(self._reorder)

    def queued_output_bytes(self) -> int:
        return self.output.nbytes + self._reorder_bytes


class ActorPoolMapOperator(PhysicalOperator):
    """Stateful-UDF map over a fixed actor pool (ref:
    actor_pool_map_operator.py). The UDF class constructs once per actor;
    blocks travel as refs straight into the actors. Dispatch and harvest
    ride util.ActorPool: results come back via the ordered get_next
    (submission order == input order), so no reorder buffer is needed."""

    budgetable = True

    def __init__(self, name: str, fn_cls: type, ctor_args: tuple,
                 pool_size: int, num_cpus_per_actor: float,
                 batch_size: Optional[int],
                 fused_ops: List[tuple],
                 input_op: PhysicalOperator,
                 max_in_flight: Optional[int] = None):
        super().__init__(name, input_op, max_in_flight or pool_size)
        self._fn_cls = fn_cls
        self._ctor_args = tuple(ctor_args)
        self._pool_size = pool_size
        self._num_cpus = num_cpus_per_actor
        self._batch_size = batch_size
        self._fused_ops = fused_ops
        self._pool = None
        self._actors: List[Any] = []
        self._pending_out: Deque[Tuple[Any, int]] = deque()  # (block_ref, idx)
        self._submitted = 0
        self._finished = 0

    def start(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.util.actor_pool import ActorPool

        fused = self._fused_ops

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self, cls, args):
                self.fn = cls(*args)

            @ray_tpu_torch.method(num_returns=2)
            def apply(self, block, bs):
                from ray_tpu_torch.data.dataset import (_apply_rebatched,
                                                        _block_nbytes, _block_rows,
                                                        _transform_block)

                block = _transform_block(block, fused)
                out = _apply_rebatched(self.fn, block, bs)
                return out, {"nbytes": _block_nbytes(out),
                             "rows": _block_rows(out)}

        self._actors = [
            _MapWorker.options(num_cpus=self._num_cpus).remote(
                self._fn_cls, self._ctor_args)
            for _ in range(self._pool_size)]
        self._pool = ActorPool(self._actors)

    def num_in_flight(self) -> int:
        return self._submitted - self._finished

    def submit_next(self) -> None:
        bundle = self.input_op.output.popleft()
        bs = self._batch_size
        pending_out = self._pending_out
        idx = bundle.index

        def _dispatch(actor, block_ref):
            block_ref_out, meta_ref = actor.apply.remote(block_ref, bs)
            # ActorPool dispatches FIFO, so appending here keeps
            # pending_out aligned with the ordered get_next stream
            pending_out.append((block_ref_out, idx))
            return meta_ref

        self._pool.submit(_dispatch, bundle.block_ref)
        self._submitted += 1
        self.metrics.tasks_submitted += 1

    def poll(self) -> bool:
        progressed = False
        while self._pool is not None and self._pool.has_next():
            try:
                meta = self._pool.get_next(timeout=0)
            except TimeoutError:
                break
            block_ref, idx = self._pending_out.popleft()
            bundle = RefBundle(block_ref, BlockMeta(**meta), idx)
            self.output.append(bundle)
            self._finished += 1
            self.metrics.tasks_finished += 1
            self.metrics.rows_out += meta.get("rows") or 0
            self.metrics.bytes_out += meta.get("nbytes") or 0
            progressed = True
        return progressed

    def watch_refs(self) -> List[Any]:
        if self._pool is None:
            return []
        return list(self._pool._future_to_actor)

    def shutdown(self) -> None:
        import ray_tpu_torch

        actors, self._actors, self._pool = self._actors, [], None
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class OutputSplitter(PhysicalOperator):
    """Round-robin fan-out into n shard queues (ref: output_splitter.py
    — the operator behind streaming_split train ingest). Shard queues
    are exempt from the byte budget: shard i may only fill because its
    consumer lags the others, and throttling upstream then would starve
    the shards that ARE consuming (the reference makes the same
    coordinated-consumers assumption)."""

    def __init__(self, input_op: PhysicalOperator, n: int):
        super().__init__("split", input_op)
        self.n = n
        self.shards: List[OpBuffer] = [OpBuffer() for _ in range(n)]
        self._rr = 0

    def poll(self) -> bool:
        progressed = False
        while self.input_op.output:
            bundle = self.input_op.output.popleft()
            self.shards[self._rr % self.n].append(bundle)
            self._rr += 1
            self.metrics.rows_out += bundle.meta.rows or 0
            self.metrics.bytes_out += bundle.nbytes
            progressed = True
        return progressed

    def queued_output_bytes(self) -> int:
        return 0

    def shard_exhausted(self, i: int) -> bool:
        return self.inputs_done() and not self.shards[i]

    def completed(self) -> bool:
        return self.inputs_done() and not any(self.shards)
