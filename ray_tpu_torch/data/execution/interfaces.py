"""Physical-operator interfaces for the streaming executor.

Reference map (python/ray/data/_internal/execution/):
  RefBundle                  -> interfaces/ref_bundle.py (block ref + metadata
                                travelling together so the scheduler can do
                                byte accounting without fetching blocks)
  OpBufferQueue              -> OpBuffer (FIFO of bundles with byte totals)
  PhysicalOperator           -> interfaces/physical_operator.py (the
                                submit/poll/completed contract the
                                StreamingExecutor drives)
  OpRuntimeMetrics           -> OpMetrics

Blocks never flow through the executor — only refs + BlockMeta do. The
driver process fetches a block exactly once, when the consumer pulls it
from the sink operator.

A copy of ``ray_tpu/data/execution/interfaces.py``; blocks are
retagged "data" in the port's memory plane
(``ray_tpu_torch.observability.memory``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

_memory_mod = None


def _memattr():
    """Lazy memory-attribution tracker (observability imports core at
    module top, so execution modules must import it on first use)."""
    global _memory_mod
    if _memory_mod is None:
        from ray_tpu_torch.observability import memory
        _memory_mod = memory.tracker()
    return _memory_mod


@dataclass
class BlockMeta:
    """Size/shape facts about a block, carried beside its ref.

    nbytes is None when the producer hasn't reported yet (e.g. a source
    ref whose read task is still running) — the ResourceManager then
    falls back to its running per-operator output estimate."""

    nbytes: Optional[int] = None
    rows: Optional[int] = None


@dataclass
class RefBundle:
    """One block ref + metadata + its position in the original block
    order (map operators are 1:1, so the index survives the whole
    chain and the sink can restore source order bitwise)."""

    block_ref: Any
    meta: BlockMeta
    index: int

    @property
    def nbytes(self) -> int:
        return self.meta.nbytes or 0


class OpBuffer:
    """FIFO queue of RefBundles with byte accounting (ref:
    OpBufferQueue — the unit select_operator_to_run budgets against)."""

    def __init__(self) -> None:
        self._q: Deque[RefBundle] = deque()
        self._nbytes = 0

    def append(self, bundle: RefBundle) -> None:
        self._q.append(bundle)
        self._nbytes += bundle.nbytes
        # Queued blocks belong to the data plane: retag the (possibly
        # worker-produced) block so memory_report() attributes it to
        # "data" instead of the generic "user" bucket.
        oid = getattr(bundle.block_ref, "id", None)
        if oid is not None:
            _memattr().retag(oid, "data")

    def popleft(self) -> RefBundle:
        bundle = self._q.popleft()
        self._nbytes -= bundle.nbytes
        oid = getattr(bundle.block_ref, "id", None)
        if oid is not None:
            _memattr().touch(oid)   # consumption is an access
        return bundle

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


@dataclass
class OpMetrics:
    """Per-operator counters (ref: OpRuntimeMetrics). backpressure_s
    accumulates wall time the operator spent input-ready but blocked by
    the ResourceManager's output-queue budget."""

    tasks_submitted: int = 0
    tasks_finished: int = 0
    rows_out: int = 0
    bytes_out: int = 0
    backpressure_s: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"tasks_submitted": self.tasks_submitted,
                "tasks_finished": self.tasks_finished,
                "rows_out": self.rows_out,
                "bytes_out": self.bytes_out,
                "backpressure_s": round(self.backpressure_s, 4)}


class PhysicalOperator:
    """Base contract the StreamingExecutor schedules against.

    Operators form a linear chain: each pops input bundles directly from
    `input_op.output`, so "queued output bytes" of an operator is exactly
    the bytes it produced that no downstream task has consumed yet."""

    #: operators whose output queues count against the byte budget
    budgetable: bool = False

    def __init__(self, name: str,
                 input_op: Optional["PhysicalOperator"],
                 max_in_flight: int = 4):
        self.name = name
        self.input_op = input_op
        self.output = OpBuffer()
        self.metrics = OpMetrics()
        self.max_in_flight = max_in_flight
        self.depth = 0 if input_op is None else input_op.depth + 1

    # --- scheduling interface ------------------------------------------------

    def start(self) -> None:
        """Acquire resources (actor pools, input metadata)."""

    def has_input(self) -> bool:
        return self.input_op is not None and bool(self.input_op.output)

    def num_in_flight(self) -> int:
        return 0

    def can_submit(self) -> bool:
        """Input available and a task slot free — budget NOT considered
        here; that's the ResourceManager's call."""
        return self.has_input() and self.num_in_flight() < self.max_in_flight

    def submit_next(self) -> None:
        raise NotImplementedError

    def poll(self) -> bool:
        """Harvest finished tasks into `output`; True if anything moved."""
        return False

    def watch_refs(self) -> List[Any]:
        """Refs the executor may block on when nothing else progresses."""
        return []

    def inputs_done(self) -> bool:
        return self.input_op is None or self.input_op.completed()

    def completed(self) -> bool:
        return (self.inputs_done() and self.num_in_flight() == 0
                and not self.output and not self._held_bundles())

    def _held_bundles(self) -> bool:
        """Bundles finished but not yet in `output` (reorder buffers)."""
        return False

    def queued_output_bytes(self) -> int:
        """Unconsumed output bytes this operator is responsible for."""
        return self.output.nbytes

    def shutdown(self) -> None:
        """Release resources; idempotent."""

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name!r}, depth={self.depth}, "
                f"in_flight={self.num_in_flight()}, "
                f"queued={len(self.output)})")
