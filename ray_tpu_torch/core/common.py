"""Shared runtime structures: addresses, task specs, object refs, resources.

Reference: src/ray/common/task/task_spec.h (TaskSpecification),
src/ray/common/scheduling/ (ResourceSet), python/ray/_raylet.pyx ObjectRef.

The resource model: labeled quantities {CPU, GPU, memory, custom} plus
topology labels carried on the node record, so gang placement can reserve
whole connected shapes (SURVEY.md §7; the JAX package's resource is
"TPU" chips, the port's "GPU" cards).
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID

Address = Tuple[str, int]  # (host, port)

# The thread running a cyclic garbage collection, None between them. A
# collection runs the finalizers of the cycles it breaks at whatever
# allocation triggered it: also inside the runtime's own critical sections
# on that thread (Runtime._entry under _dir_lock, the reference counter's
# lock), which a finalizer that takes those locks would deadlock on.
_collecting_thread: Optional[int] = None


def _note_collection(phase: str, info: dict) -> None:
    global _collecting_thread
    _collecting_thread = threading.get_ident() if phase == "start" else None


gc.callbacks.append(_note_collection)


@dataclass(frozen=True)
class RuntimeAddress:
    """Where an owner/worker runtime can be reached (ref: rpc::Address)."""
    host: str
    port: int
    worker_id: bytes = b""

    @property
    def addr(self) -> Address:
        return (self.host, self.port)


class ObjectRef:
    """A first-class future for a task return or put object.

    Carries the owner's runtime address — ownership is embedded in the ref so
    any holder can reach the owner for liveness/location/refcount traffic
    (ref: reference_count.h:59 borrower protocol; ObjectRef in _raylet.pyx).

    Refcounting: ObjectRef registers itself with the in-process runtime on
    construction and deregisters on __del__; remote holders count via the
    borrow protocol in ray_tpu_torch.core.refcount.
    """

    __slots__ = ("id", "owner", "_runtime", "__weakref__")

    def __init__(self, oid: ObjectID, owner: RuntimeAddress, _register: bool = True):
        self.id = oid
        self.owner = owner
        self._runtime = None
        if _register:
            from ray_tpu_torch.core import runtime as rt

            r = rt.current_runtime_or_none()
            if r is not None:
                self._runtime = r
                r.refs.on_ref_created(self.id, self.owner)

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def future(self):
        """concurrent.futures.Future resolving to the value (ref: .future())."""
        from ray_tpu_torch.core import runtime as rt

        return rt.get_runtime().as_future(self)

    def __reduce__(self):
        # Serialization counts as a borrow: the deserializing process
        # registers with the owner via its runtime (refcount.py).
        return (_deserialize_ref, (self.id, self.owner))

    def __del__(self):
        r = self._runtime
        if r is not None:
            try:
                if _collecting_thread == threading.get_ident():
                    # a collection's finalizer, maybe inside a critical
                    # section of this thread that the release's locks
                    # would deadlock on: release on the loop thread
                    r.drop_ref_soon(self.id, self.owner)
                else:
                    r.refs.on_ref_deleted(self.id, self.owner)
            except Exception:
                pass

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"


# num_returns sentinel for generator tasks whose return refs are created
# incrementally as the executor yields (ref: task_manager.h:143-171
# streaming-generator refs / num_returns="dynamic").
STREAMING = -1


class ObjectRefGenerator:
    """Iterator over a streaming task's item refs, in yield order.

    next() blocks until the executor has reported the next item to the
    owner (or the stream ended: StopIteration, or errored: the task's
    exception — after all successfully-yielded items were consumed, like
    the reference's generator semantics). Only meaningful in the owning
    process; pass individual item refs, not the generator, to other tasks.
    """

    def __init__(self, task_id, owner: RuntimeAddress):
        self.task_id = task_id
        self.owner = owner
        self._index = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        from ray_tpu_torch.core import runtime as rt

        # next_stream_ref returns None on clean end-of-stream (StopIteration
        # cannot ride through asyncio futures, so the sentinel keeps the
        # sync and async paths on one runtime call)
        ref = rt.get_runtime().next_stream_ref(self.task_id,
                                               self._index + 1)
        if ref is None:
            raise StopIteration
        self._index += 1
        return ref

    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio

        from ray_tpu_torch.core import runtime as rt

        rt_ = rt.get_runtime()
        ref = await asyncio.get_running_loop().run_in_executor(
            None, rt_.next_stream_ref, self.task_id, self._index + 1)
        if ref is None:
            raise StopAsyncIteration
        self._index += 1
        return ref

    def completed(self) -> int:
        """Items reported so far (non-blocking)."""
        from ray_tpu_torch.core import runtime as rt

        return rt.get_runtime().stream_progress(self.task_id)[0]

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is only meaningful in the owning process; "
            "pass the individual item refs instead")

    def __del__(self):
        # Discarding the generator releases a backpressure-blocked
        # executor (its next report returns ok=False and it stops).
        # MUST be the deferred variant: a finalizer can run mid-allocation
        # inside the runtime's own stream-lock critical section, and
        # taking the lock here would self-deadlock.
        from ray_tpu_torch.core import runtime as rt

        r = rt.current_runtime_or_none()
        if r is not None:
            try:
                r.drop_stream_soon(self.task_id)
            except Exception:
                pass

    def __repr__(self):
        return f"ObjectRefGenerator({self.task_id.hex()}, next={self._index + 1})"


def _deserialize_ref(oid: ObjectID, owner: RuntimeAddress) -> ObjectRef:
    return ObjectRef(oid, owner)


# --- resources --------------------------------------------------------------


@dataclass
class ResourceSet:
    """Labeled resource quantities. GPUs are a first-class resource."""
    quantities: Dict[str, float] = field(default_factory=dict)

    def fits_in(self, avail: "ResourceSet") -> bool:
        return all(avail.quantities.get(k, 0.0) + 1e-9 >= v
                   for k, v in self.quantities.items())

    def subtract(self, other: "ResourceSet") -> None:
        for k, v in other.quantities.items():
            self.quantities[k] = self.quantities.get(k, 0.0) - v

    def add(self, other: "ResourceSet") -> None:
        for k, v in other.quantities.items():
            self.quantities[k] = self.quantities.get(k, 0.0) + v

    def copy(self) -> "ResourceSet":
        return ResourceSet(dict(self.quantities))

    @classmethod
    def from_options(cls, num_cpus: Optional[float], num_gpus: Optional[float],
                     memory: Optional[float], resources: Optional[Dict[str, float]],
                     default_cpus: float = 1.0) -> "ResourceSet":
        q: Dict[str, float] = {}
        q["CPU"] = default_cpus if num_cpus is None else float(num_cpus)
        if num_gpus:
            # num_gpus is sugar for the logical chip resource; fleets
            # that rename it (cfg.chip_resource, RAY_TPU_CHIP_RESOURCE)
            # need task requests and node capacities to agree
            from ray_tpu_torch.core import runtime as _rt
            from ray_tpu_torch.core.config import GLOBAL_CONFIG

            r = _rt.current_runtime_or_none()
            cfg = r.cfg if r is not None else GLOBAL_CONFIG
            q[cfg.chip_resource] = float(num_gpus)
        if memory:
            q["memory"] = float(memory)
        for k, v in (resources or {}).items():
            q[k] = float(v)
        q = {k: v for k, v in q.items() if v != 0.0}
        return cls(q)


@dataclass
class NodeInfo:
    """Cluster-membership record (ref: GcsNodeInfo proto)."""
    node_id: NodeID
    nodelet_addr: Address
    resources_total: ResourceSet
    # TPU topology labels: e.g. {"slice": "v5e-8/0", "ici_coord": (0,0),
    # "hostname": ...}. Used by slice-aware placement (placement_group.py).
    labels: Dict[str, Any] = field(default_factory=dict)
    alive: bool = True
    store_name: str = ""
    start_time: float = field(default_factory=time.time)


# --- scheduling strategies --------------------------------------------------


@dataclass(frozen=True)
class SchedulingStrategy:
    """DEFAULT hybrid policy (ref: hybrid_scheduling_policy.cc:186)."""
    kind: str = "DEFAULT"


@dataclass(frozen=True)
class SpreadStrategy(SchedulingStrategy):
    kind: str = "SPREAD"


@dataclass(frozen=True)
class NodeAffinityStrategy(SchedulingStrategy):
    """ref: util/scheduling_strategies.py:41 NodeAffinitySchedulingStrategy."""
    kind: str = "NODE_AFFINITY"
    node_id: Optional[NodeID] = None
    soft: bool = False


@dataclass(frozen=True)
class PlacementGroupStrategy(SchedulingStrategy):
    """ref: util/scheduling_strategies.py:15 PlacementGroupSchedulingStrategy."""
    kind: str = "PLACEMENT_GROUP"
    pg_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1


# --- task spec --------------------------------------------------------------


@dataclass
class TaskSpec:
    """Everything needed to run a task anywhere (ref: TaskSpecification).

    `args` is a list of either ("v", pickled_bytes) for inline values or
    ("ref", ObjectRef) for object dependencies; the executing worker resolves
    refs through its own runtime (big objects come from the node store).
    """
    task_id: TaskID
    name: str
    func_id: bytes                      # GCS-KV key of the pickled function
    args: List[Tuple[str, Any]]
    num_returns: int
    resources: ResourceSet
    owner: RuntimeAddress
    job_id: JobID
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Optional[dict] = None
    # actor creation
    is_actor_creation: bool = False
    actor_id: Optional[ActorID] = None
    max_restarts: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    namespace: str = "default"
    # actor method call
    is_actor_call: bool = False
    method_name: Optional[str] = None
    seq_no: int = -1                    # per-caller ordering (ref: actor submit queue)
    # tracing context {trace_id, span_id} (ref: tracing_helper.py
    # _function_hydrate_span_args — span context rides the task spec)
    trace_ctx: Optional[dict] = None
    # streaming tasks: executor stays at most this many unconsumed items
    # ahead of the consumer (ref: _generator_backpressure_num_objects);
    # None = unbounded
    generator_backpressure: Optional[int] = None
    # byte-budget variant: ack withheld while unconsumed item BYTES exceed
    # this (the data layer sizes it from the object-store budget, ref:
    # streaming_executor_state.py admission by store memory)
    generator_backpressure_bytes: Optional[int] = None

    def return_ids(self) -> List[ObjectID]:
        if self.num_returns == STREAMING:
            return []   # item ids are created incrementally as they stream
        return [ObjectID.for_return(self.task_id, i + 1) for i in range(self.num_returns)]

    @property
    def is_streaming(self) -> bool:
        return self.num_returns == STREAMING

    def scheduling_class(self) -> Tuple:
        """Tasks with equal class can reuse a lease (ref: SchedulingClass).
        Includes the process-env key: leases pin workers whose process env
        was fixed at spawn, so tasks with different process_env_vars must
        never share one."""
        from ray_tpu_torch.runtime_env import process_env

        pe = tuple(sorted(process_env(self.runtime_env).items()))
        # Placement-TARGETED strategies must key the class by their
        # target: lease reuse would otherwise hand a task affined to
        # node B the parked worker leased on node A (observed: every
        # NodeAffinity broadcast task ran on the driver's node), and a
        # PG task the wrong bundle's worker.
        target = ()
        if self.scheduling.kind == "NODE_AFFINITY":
            nid = self.scheduling.node_id
            target = (nid.hex() if nid is not None else None,
                      self.scheduling.soft)
        elif self.scheduling.kind == "PLACEMENT_GROUP":
            target = (self.scheduling.pg_id.hex(),
                      self.scheduling.bundle_index)
        return (self.func_id, tuple(sorted(self.resources.quantities.items())),
                self.scheduling.kind, target, pe)


@dataclass
class TaskResult:
    """Reply of a task push (ref: PushTaskReply proto)."""
    task_id: TaskID
    # per-return: ("inline", pickled) | ("store", {"addr","size"}) |
    #             ("err", SerializedException)
    returns: List[Tuple[str, Any]]
    worker_id: bytes = b""
