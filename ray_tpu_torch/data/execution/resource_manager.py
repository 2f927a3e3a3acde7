"""ResourceManager: budget accounting + the select_operator_to_run policy.

Reference map (python/ray/data/_internal/execution/):
  resource_manager.py        -> per-operator output-queue budgets derived
                                from the object store size
  streaming_executor_state.py:376 select_operator_to_run
                             -> pick the operator whose output queue is
                                under budget, preferring the operator
                                with the least unconsumed output (i.e.
                                the downstream-starved one), so a slow
                                consumer rate-limits its producers and a
                                drained pipeline refills from the top.

Liveness guarantee: an operator with an empty output queue and no task
in flight is ALWAYS budget-eligible (one task may exceed a tiny budget —
it still runs), and when every candidate is budget-blocked but nothing
is in flight anywhere, the most downstream candidate runs anyway.
Together these make "all queues empty => schedulable" unconditional, so
the executor cannot deadlock on budgets alone.

A copy of ``ray_tpu/data/execution/resource_manager.py``.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ray_tpu_torch.data.execution.interfaces import PhysicalOperator, _memattr

#: fallback per-task output estimate before any sizes are known
_DEFAULT_OUTPUT_EST = 1 << 20


def derive_budget_bytes(fraction: Optional[float] = None) -> int:
    """Total unconsumed-output budget from the runtime's object store
    size (Config.data_execution_budget_fraction unless overridden)."""
    from ray_tpu_torch.core import runtime as rt

    r = rt.current_runtime_or_none()
    if r is not None:
        frac = (fraction if fraction is not None
                else r.cfg.data_execution_budget_fraction)
        return max(1, int(r.cfg.object_store_memory * frac))
    return max(1, int((2 << 30) * (fraction if fraction is not None
                                   else 0.25)))


class ResourceManager:
    """Tracks per-operator in-flight slots and queued output bytes
    against a byte budget; owns the scheduling policy."""

    def __init__(self, ops: List[PhysicalOperator],
                 total_budget_bytes: Optional[int] = None,
                 per_op_budget_bytes: Optional[int] = None):
        self._ops = ops
        budgeted = [op for op in ops if op.budgetable]
        if per_op_budget_bytes is not None:
            self.per_op_budget = max(1, int(per_op_budget_bytes))
        else:
            total = (total_budget_bytes if total_budget_bytes is not None
                     else derive_budget_bytes())
            self.per_op_budget = max(1, total // max(1, len(budgeted)))
        self._last_select_t: Optional[float] = None

    # --- accounting ----------------------------------------------------------

    def est_output_bytes(self, op: PhysicalOperator) -> int:
        """Expected bytes ONE more task of `op` will add to its output
        queue: running average of finished outputs, else the size of the
        input bundle it would consume, else a 1 MiB prior."""
        m = op.metrics
        if m.tasks_finished:
            return max(1, m.bytes_out // m.tasks_finished)
        if op.input_op is not None and op.input_op.output:
            q = op.input_op.output
            if q.nbytes:
                return max(1, q.nbytes // len(q))
        return _DEFAULT_OUTPUT_EST

    def outqueue_usage(self, op: PhysicalOperator) -> int:
        """Actual queued output bytes plus the projected output of every
        in-flight task — admission must see bytes BEFORE they land, or a
        burst of submissions overshoots the budget by a whole window."""
        return (op.queued_output_bytes()
                + op.num_in_flight() * self.est_output_bytes(op))

    def under_budget(self, op: PhysicalOperator) -> bool:
        if not op.budgetable:
            return True
        if op.queued_output_bytes() == 0 and op.num_in_flight() == 0:
            return True   # liveness: empty operators always admit one task
        return (self.outqueue_usage(op) + self.est_output_bytes(op)
                <= self.per_op_budget)

    def _track_queued(self, ops: List[PhysicalOperator]) -> None:
        """Mirror the pipeline's total unconsumed output bytes into the
        memory plane (synthetic aggregate; per-block records are retagged
        "data" by OpBuffer.append). Runs once per scheduling decision."""
        total = sum(op.queued_output_bytes() for op in ops)
        mem = _memattr()
        key = "data:outqueues"
        if total > 0:
            mem.attribute(key, "data", total, store=False,
                          budget=self.per_op_budget)
            self._tracked = True
        elif getattr(self, "_tracked", False):
            mem.release(key)
            self._tracked = False

    # --- policy --------------------------------------------------------------

    def select_operator_to_run(
            self, ops: Optional[List[PhysicalOperator]] = None
    ) -> Optional[PhysicalOperator]:
        """One scheduling decision (ref: select_operator_to_run). Returns
        the operator to hand a task, or None when nothing should run."""
        ops = ops if ops is not None else self._ops
        now = time.monotonic()
        dt = (now - self._last_select_t) if self._last_select_t else 0.0
        self._last_select_t = now
        self._track_queued(ops)

        candidates = [op for op in ops if op.can_submit()]
        eligible = []
        for op in candidates:
            if self.under_budget(op):
                eligible.append(op)
            else:
                op.metrics.backpressure_s += dt
        if not eligible:
            if candidates and not any(op.num_in_flight() for op in ops):
                # budget-blocked but the pipeline is idle: force the most
                # downstream candidate so progress is unconditional
                return max(candidates, key=lambda op: op.depth)
            return None
        # least unconsumed output first (drain towards the consumer);
        # among ties prefer the most downstream operator
        return min(eligible,
                   key=lambda op: (self.outqueue_usage(op), -op.depth))
