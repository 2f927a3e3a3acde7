"""StreamingExecutor: the cross-operator, budget-aware scheduling loop.

Reference map (python/ray/data/_internal/execution/):
  streaming_executor.py      -> the scheduling loop itself
  streaming_executor_state.py -> per-round state: poll completions, move
                                bundles, pick the next operator

The executor is a cooperative generator driven by the consumer: each
`next()` polls every operator for finished tasks, hands out as many new
tasks as the ResourceManager admits, and yields the sink's next bundle.
Consumer demand IS the outermost backpressure — when the training loop
stops pulling, task issue stops within one budget window.

Every run records a bounded trace of per-round operator states
(in-flight, queued bytes) and publishes a summary via
get_last_execution_stats() for tests and bench.py --bench data.

A copy of ``ray_tpu/data/execution/streaming_executor.py``; its stall
beacon and spans go to the port's ``observability.health`` and
``util.tracing``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch.data.execution.interfaces import PhysicalOperator, RefBundle
from ray_tpu_torch.data.execution.resource_manager import ResourceManager
from ray_tpu_torch.observability import health as _health

# A scheduling round that admits nothing while work is in flight is
# normal backpressure; one that stays that way this long without any
# completion is a stalled pipeline (dead worker, wedged compiled op).
_STALL_DEADLINE_S = 60.0

_TRACE_CAP = 20_000
_LAST_STATS: Optional[Dict[str, Any]] = None


def get_last_execution_stats() -> Optional[Dict[str, Any]]:
    """Summary of the most recently finished executor run in this
    process: per-op metrics, peak queued bytes, round trace."""
    return _LAST_STATS


class StreamingExecutor:
    def __init__(self, operators: List[PhysicalOperator],
                 resource_manager: Optional[ResourceManager] = None):
        if not operators:
            raise ValueError("executor needs at least one operator")
        self._ops = operators
        self._rm = resource_manager or ResourceManager(operators)
        self._started = False
        self._shut = False
        self._beacon = _health.beacon("data:executor", _STALL_DEADLINE_S)
        self.trace: List[Dict[str, Any]] = []
        self.peak_queued_bytes = 0
        self.max_concurrent_ops = 0   # ops with in-flight tasks at once

    # --- lifecycle -----------------------------------------------------------

    def _start(self) -> None:
        if not self._started:
            self._started = True
            self._t_start = time.time()
            for op in self._ops:
                op.start()

    def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        self._beacon.disarm()
        for op in self._ops:
            try:
                op.shutdown()
            except Exception:
                pass
        self._publish_stats()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    def done(self) -> bool:
        return all(op.completed() for op in self._ops)

    # --- the scheduling round ------------------------------------------------

    def _step(self) -> bool:
        """One round: harvest completions, submit while the policy admits,
        then (if idle) block briefly on in-flight work."""
        import ray_tpu_torch

        progressed = False
        for op in self._ops:
            if op.poll():
                progressed = True
        while True:
            op = self._rm.select_operator_to_run(self._ops)
            if op is None:
                break
            op.submit_next()
            progressed = True
        self._record_round()
        if progressed:
            self._beacon.tick()
            self._beacon.disarm()
        elif any(op.num_in_flight() > 0 for op in self._ops) \
                and not self._beacon.busy:
            self._beacon.arm(ops=[op.name for op in self._ops
                                  if op.num_in_flight() > 0])
        if not progressed:
            refs: List[Any] = []
            for op in self._ops:
                refs.extend(op.watch_refs())
            if refs:
                ray_tpu_torch.wait(refs, num_returns=1, timeout=0.1)
            elif any(op.num_in_flight() > 0 for op in self._ops):
                # compiled-graph operators track in-flight work as
                # channel refs, not ObjectRefs — nothing to wait() on
                time.sleep(0.01)
            elif not self.done():
                # structurally unreachable: bundles are always in some
                # queue, making an operator input-ready, and an idle
                # pipeline always admits (ResourceManager liveness rule)
                raise RuntimeError(
                    "streaming executor stalled with no in-flight work: "
                    + ", ".join(repr(op) for op in self._ops))
        return progressed

    def _record_round(self) -> None:
        busy = sum(1 for op in self._ops if op.num_in_flight() > 0)
        self.max_concurrent_ops = max(self.max_concurrent_ops, busy)
        total_queued = sum(op.queued_output_bytes() for op in self._ops)
        self.peak_queued_bytes = max(self.peak_queued_bytes, total_queued)
        if len(self.trace) < _TRACE_CAP:
            self.trace.append({
                "t": time.monotonic(),
                "ops": [{"name": op.name,
                         "in_flight": op.num_in_flight(),
                         "queued_bytes": op.queued_output_bytes()}
                        for op in self._ops],
            })

    def _publish_stats(self) -> None:
        global _LAST_STATS
        _LAST_STATS = {
            "operators": {f"{op.depth}:{op.name}": op.metrics.as_dict()
                          for op in self._ops},
            "peak_queued_bytes": self.peak_queued_bytes,
            "max_concurrent_ops": self.max_concurrent_ops,
            "per_op_budget_bytes": self._rm.per_op_budget,
            "rounds": len(self.trace),
            "trace": self.trace,
        }
        # op-lifetime spans onto the unified timeline (no-op unless
        # tracing is on): one `data::<op>` slice per operator covering
        # the run, with its metrics as span attributes
        from ray_tpu_torch.util import tracing
        t0 = getattr(self, "_t_start", None)
        if t0 is not None and (tracing.is_enabled()
                               or tracing.current_context() is not None):
            dur = time.time() - t0
            for op in self._ops:
                tracing.emit_span(f"data::{op.name}", t0, dur,
                                  {"depth": op.depth,
                                   **op.metrics.as_dict()})

    # --- consumption ---------------------------------------------------------

    def execute(self) -> Iterator[RefBundle]:
        """Yield the sink operator's bundles in source-block order."""
        self._start()
        sink = self._ops[-1]
        try:
            while True:
                while sink.output:
                    yield sink.output.popleft()
                if self.done():
                    break
                self._step()
        finally:
            self.shutdown()

    def execute_to_refs(self) -> List[Any]:
        """Drain fully; the materialize path."""
        return [b.block_ref for b in self.execute()]

    def execute_split(self, n: int) -> List[Iterator[RefBundle]]:
        """n shard iterators over ONE run — the sink must be an
        OutputSplitter(n). Each pull pumps the shared loop until that
        shard has a bundle; other shards' bundles wait in their queues."""
        from ray_tpu_torch.data.execution.operators import OutputSplitter

        sink = self._ops[-1]
        if not isinstance(sink, OutputSplitter) or sink.n != n:
            raise ValueError("execute_split needs an OutputSplitter sink "
                             f"of width {n}")
        self._start()

        def _shard_iter(i: int) -> Iterator[RefBundle]:
            while True:
                if sink.shards[i]:
                    yield sink.shards[i].popleft()
                    continue
                if sink.shard_exhausted(i):
                    if self.done():
                        self.shutdown()
                    return
                self._step()

        return [_shard_iter(i) for i in range(n)]
