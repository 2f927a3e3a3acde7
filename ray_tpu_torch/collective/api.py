"""Public host-collective API.

Reference: python/ray/util/collective/collective.py (GroupManager:40,
init_collective_group:120, allreduce:258, barrier:298, broadcast:373,
allgather:423, reducescatter:472). Backends are host-topology-aware
algorithms over the object store (registry.py) instead of NCCL/Gloo
process groups; *device* collectives stay inside jitted programs
(ray_tpu_torch.parallel — see ARCHITECTURE.md "Host collectives").

Contracts:

- Every rank must issue the same ops in the same order on a group
  (standard collective semantics; rounds are tied by sequence number).
- SUM is the reduction (same as the legacy coordinator).
- Payloads: numpy arrays, scalars, or pytrees (nested dict/list/tuple)
  of them for allreduce; arbitrary picklable values for
  allgather/broadcast.
- A member death or stall surfaces as ``CollectiveError`` (usually the
  ``CollectiveTimeoutError`` subclass, naming suspect ranks) on every
  surviving rank within roughly the group's ``timeout_s`` — no deadlock.
- ``*_async`` variants return ``concurrent.futures.Future`` and run on a
  per-group thread, overlapping host communication with caller compute;
  per group they execute in submission order.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.collective import cost as _cost
from ray_tpu_torch.collective import pytree as _pt
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.collective.errors import CollectiveError, CollectiveTimeoutError
from ray_tpu_torch.collective.group import GroupContext
from ray_tpu_torch.collective.registry import (available_backends,
                                         get_backend_factory,
                                         register_backend, select_backend)
from ray_tpu_torch.collective.topology import Topology

#: Keyed by (calling actor id, group name), NOT group name alone:
#: lane-packed fractional-CPU actors share a worker process, so
#: per-process state would let rank N's init clobber rank M's (their
#: allreduce then deadlocks waiting for ranks that can never arrive).
_groups: Dict[tuple, "GroupClient"] = {}


def _ctx() -> Optional[str]:
    try:
        return ray_tpu_torch.get_runtime_context().get_actor_id()
    except Exception:
        return None


def _on_actor_teardown(actor_id_hex: str) -> None:
    """Lane actors die without their process dying: drop their group
    clients so a churning fleet cannot grow _groups unboundedly."""
    for key in [k for k in _groups if k[0] == actor_id_hex]:
        g = _groups.pop(key, None)
        if g is not None:
            g.close_local()


from ray_tpu_torch.core.runtime import actor_teardown_hooks as _hooks  # noqa: E402

_hooks.append(_on_actor_teardown)


class GroupClient:
    """One rank's membership in one collective group."""

    #: A cached backend decision is re-priced after this many uses —
    #: frequent enough to track edge-model drift within a workload,
    #: rare enough that the agreement round's coordinator RTT amortizes.
    REFRESH_EVERY = 64

    def __init__(self, name: str, world_size: int, rank: int,
                 backend: str = "auto", timeout_s: float = 60.0,
                 pipeline_chunks: int = 4, transport: str = "auto"):
        if backend != "auto":
            get_backend_factory(backend)     # fail fast on unknown names
        self.ctx = GroupContext(name, world_size, rank, timeout_s=timeout_s,
                                transport=transport)
        self.requested_backend = backend
        self.pipeline_chunks = pipeline_chunks
        self._instances: Dict[str, Any] = {}
        #: (op, payload log2-bucket) → agreed decision dict. Identical on
        #: every rank by construction (rank 0 broadcasts its choice).
        self._decisions: Dict[tuple, dict] = {}
        self._op_lock = threading.Lock()     # serializes sync vs async ops
        self._executor: Optional[ThreadPoolExecutor] = None

    # -- plumbing --------------------------------------------------------

    @property
    def name(self) -> str:
        return self.ctx.name

    @property
    def rank(self) -> int:
        return self.ctx.rank

    @property
    def world(self) -> int:
        return self.ctx.world

    @property
    def topology(self) -> Topology:
        return self.ctx.topology

    def _instance(self, name: str):
        inst = self._instances.get(name)
        if inst is None:
            factory = get_backend_factory(name)
            try:
                inst = factory(self.ctx, pipeline_chunks=self.pipeline_chunks)
            except TypeError:
                inst = factory(self.ctx)
            self._instances[name] = inst
        return inst

    def _choose(self, op: str, payload_bytes: Optional[int] = None):
        """(backend name, decision info) for one op call.

        With backend="auto" the choice comes from the measured cost
        model, agreed across ranks: rank 0 prices the candidates with
        ITS edge-stats snapshot and coordinator EWMA and broadcasts the
        result — per-rank snapshot drift can never split the group
        across backends. Decisions cache per (op, payload bucket) so the
        agreement RTT amortizes; every rank's cache and use counters
        advance in lockstep (same op stream), so refreshes line up too."""
        if self.requested_backend != "auto":
            return self.requested_backend, {
                "backend": self.requested_backend, "source": "requested"}
        key = (op, _cost.payload_bucket(payload_bytes))
        dec = self._decisions.get(key)
        if dec is not None and dec["uses"] < self.REFRESH_EVERY:
            dec["uses"] += 1
            return dec["backend"], dec
        dec = self._agree(op, payload_bytes)
        dec["uses"] = 1
        self._decisions[key] = dec
        return dec["backend"], dec

    def _agree(self, op: str, payload_bytes: Optional[int]) -> dict:
        ctx = self.ctx
        if self.world == 1:
            _, info = _cost.choose_backend(op, 1, ctx.topology, payload_bytes)
            return dict(info)
        chosen = None
        if ctx.rank == 0:
            try:
                from ray_tpu_torch.observability.edges import edge_stats

                edges = edge_stats()
            except Exception:
                edges = {}
            _, info = _cost.choose_backend(
                op, self.world, ctx.topology, payload_bytes, edges=edges,
                coord_lat=ctx.coord_lat_ewma, coord_bw=ctx.coord_bw_ewma)
            chosen = dict(info)
        # one coordinator RTT ties the round; every rank must pass here
        # (same op stream), so this cannot deadlock
        return dict(ctx.coord_exchange("broadcast", chosen))

    def _submit(self, fn, *args) -> Future:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"col-{self.name}-r{self.rank}")
        return self._executor.submit(fn, *args)

    def close_local(self):
        """Release this rank's local resources (not the group actors)."""
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    # -- ops -------------------------------------------------------------

    def _span(self, op: str, decision: Optional[dict] = None):
        """Collective rounds are timeline spans (no-op when tracing is
        off) — they land in the recording worker's lane next to its
        tasks, carrying the auto-selector's decision."""
        args = {"group": self.name, "rank": self.rank, "world": self.world}
        if decision:
            args["backend"] = decision.get("backend")
            args["decision_source"] = decision.get("source")
            costs = decision.get("costs_ms")
            if costs:
                args["predicted_cost_ms"] = costs.get(decision.get("backend"))
        return _tracing.span(f"collective::{op}", args)

    def allreduce(self, tensor):
        with self._op_lock:
            if _pt.is_leaf(tensor):
                arr = np.asarray(tensor)
                name, dec = self._choose("allreduce", arr.nbytes)
                with self._span("allreduce", dec):
                    return self._instance(name).allreduce(arr)
            leaves, treedef = _pt.tree_flatten(tensor)
            buffers, layout = _pt.pack_leaves(leaves)
            name, dec = self._choose(
                "allreduce", buffers[0].nbytes if buffers else None)
            with self._span("allreduce", dec):
                # per-buffer choice (packed buffers differ in size); the
                # duplicate first-buffer _choose is a cache hit and every
                # rank repeats it identically, so counters stay in step
                reduced = [
                    self._instance(self._choose("allreduce", b.nbytes)[0])
                    .allreduce(b) for b in buffers]
                return _pt.tree_unflatten(
                    treedef, _pt.unpack_leaves(reduced, layout))

    def allgather(self, value) -> List[Any]:
        with self._op_lock:
            name, dec = self._choose("allgather")
            with self._span("allgather", dec):
                return self._instance(name).allgather(value)

    def broadcast(self, value, src_rank: int = 0):
        if not (0 <= src_rank < self.world):
            raise ValueError(f"broadcast: src_rank {src_rank} outside "
                             f"world of {self.world}")
        with self._op_lock:
            name, dec = self._choose("broadcast")
            with self._span("broadcast", dec):
                data = value if self.rank == src_rank else None
                return self._instance(name).broadcast(data, src_rank)

    def reducescatter(self, tensor) -> np.ndarray:
        arr = np.asarray(tensor)
        if arr.ndim == 0:
            raise ValueError("reducescatter: payload must have at least "
                             "one dimension to scatter over")
        if arr.shape[0] % self.world:
            # the legacy coordinator silently returned ragged
            # np.array_split chunks here — refuse instead
            raise ValueError(
                f"reducescatter: leading dim {arr.shape[0]} is not "
                f"divisible by world_size {self.world}; pad the payload "
                "or pick a scatterable batch dimension")
        with self._op_lock:
            name, dec = self._choose("reducescatter", arr.nbytes)
            with self._span("reducescatter", dec):
                return self._instance(name).reducescatter(arr)

    def barrier(self) -> None:
        with self._op_lock:
            name, dec = self._choose("barrier")
            with self._span("barrier", dec):
                self._instance(name).barrier()

    def destroy(self):
        self.close_local()
        self.ctx.destroy()


# --------------------------------------------------------------------------
# module-level API (the surface util/collective.py re-exports)
# --------------------------------------------------------------------------


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default", *,
                          backend: str = "auto",
                          timeout_s: float = 60.0,
                          pipeline_chunks: int = 4,
                          transport: str = "auto") -> None:
    """Join `group_name` as `rank` of `world_size` (ref: collective.py:120).

    backend: "auto" | "gather" | "ring" | "hier" | any registered name.
    timeout_s: per-round deadline before surviving ranks raise
        ``CollectiveTimeoutError`` (member-failure detection).
    transport: "auto" (Config-threshold tiering: inline below the eager
        threshold, zero-copy object-store refs above the zero-copy
        threshold) | "mailbox" (force everything inline+chunked — the
        legacy transport) | "zerocopy" (force every ndarray/bytes chunk
        through the store) | "eager" (force single inline messages).
        Every rank of a group must pass the same value.
    """
    _groups[(_ctx(), group_name)] = GroupClient(
        group_name, world_size, rank, backend=backend,
        timeout_s=timeout_s, pipeline_chunks=pipeline_chunks,
        transport=transport)


def destroy_collective_group(group_name: str = "default") -> None:
    """Tear the group down: drops this rank's client AND kills the named
    helper actors (coordinator + mailboxes) so repeated init/destroy
    cycles cannot leak one named actor per group name. Call after the
    fleet is done with the group (any rank may run the reaping)."""
    g = _groups.pop((_ctx(), group_name), None)
    if g is not None:
        g.destroy()
        return
    # No local client (e.g. driver-side cleanup after members died):
    # reap the named actors directly.
    for suffix in [""] + [f"_mbx{r}" for r in range(1024)]:
        name = f"_collective_{group_name}{suffix}"
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
        except ValueError:
            if suffix != "":
                break                    # contiguous ranks: first gap ends it
        except Exception:
            pass


def generation_name(group_name: str, generation: int) -> str:
    """The name incarnation `generation` of a logical group uses for its
    helper actors. Group membership is static — a resize means a NEW
    group — so elastic rebuilds join `name@g<N>` instead of racing the
    previous incarnation's coordinator/mailbox actors on `name`."""
    return group_name if generation <= 0 else f"{group_name}@g{generation}"


def reform_collective_group(group_name: str, generation: int) -> str:
    """Re-form a logical group for a new (possibly shrunken) membership.

    Driver-side half of an elastic rebuild: tear down the PREVIOUS
    incarnation's named helper actors (its members may all be dead, so
    the reap must not require a local client — destroy_collective_group
    handles that) and return the generation-qualified name the new
    members must pass to init_collective_group. Idempotent: reaping a
    name with no actors is a no-op."""
    destroy_collective_group(generation_name(group_name, generation - 1))
    return generation_name(group_name, generation)


def _group(name: str) -> GroupClient:
    key = (_ctx(), name)
    g = _groups.get(key)
    if g is not None:
        return g
    # Helper threads an actor spawns itself start with a fresh context
    # (no actor id). If exactly ONE client for this group name lives in
    # the process, that use is unambiguous — honor it (the per-process
    # reference semantics). Multiple same-name clients (lane-packed
    # ranks) make a context-less call genuinely ambiguous.
    candidates = [g for (a, n), g in _groups.items() if n == name]
    if len(candidates) == 1:
        return candidates[0]
    if candidates:
        raise RuntimeError(
            f"collective group {name!r}: ambiguous caller — "
            f"{len(candidates)} lane-packed actors initialized this "
            "group in one process, and this call carries no actor "
            "context (e.g. a self-spawned thread). Call from an actor "
            "method, or propagate contextvars into the thread")
    raise RuntimeError(f"collective group {name!r} not initialized")


def allreduce(tensor, group_name: str = "default"):
    """SUM allreduce of an array or pytree (ref: collective.py:258)."""
    return _group(group_name).allreduce(tensor)


def allgather(tensor, group_name: str = "default") -> List[Any]:
    return _group(group_name).allgather(tensor)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name).broadcast(tensor, src_rank)


def reducescatter(tensor, group_name: str = "default") -> np.ndarray:
    return _group(group_name).reducescatter(tensor)


def barrier(group_name: str = "default") -> None:
    _group(group_name).barrier()


# -- async variants (compute/comm overlap) ---------------------------------


def allreduce_async(tensor, group_name: str = "default") -> Future:
    g = _group(group_name)
    return g._submit(g.allreduce, tensor)


def allgather_async(tensor, group_name: str = "default") -> Future:
    g = _group(group_name)
    return g._submit(g.allgather, tensor)


def broadcast_async(tensor, src_rank: int = 0,
                    group_name: str = "default") -> Future:
    g = _group(group_name)
    return g._submit(g.broadcast, tensor, src_rank)


def reducescatter_async(tensor, group_name: str = "default") -> Future:
    g = _group(group_name)
    return g._submit(g.reducescatter, tensor)


def barrier_async(group_name: str = "default") -> Future:
    g = _group(group_name)
    return g._submit(g.barrier)


# -- introspection ---------------------------------------------------------


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world


def get_group_topology(group_name: str = "default") -> Topology:
    return _group(group_name).topology


def transfer_stats(group_name: str = "default") -> dict:
    """This rank's byte accounting (the bandwidth-optimality hook)."""
    return _group(group_name).ctx.stats.snapshot()


def reset_transfer_stats(group_name: str = "default") -> None:
    _group(group_name).ctx.stats.reset()


def coordinator_stats(group_name: str = "default") -> dict:
    """The gather coordinator's fan-in accounting (bytes_in)."""
    g = _group(group_name)
    return ray_tpu_torch.get(g.ctx.coord.stats.remote(), timeout=30)


def group_stats(group_name: str = "default") -> dict:
    """This rank's full collective picture: transfer accounting, the
    transport tiering in effect, and every auto-selection decision (the
    chosen backend + the cost model's predictions behind it)."""
    g = _group(group_name)
    ctx = g.ctx
    return {
        "group": g.name,
        "rank": g.rank,
        "world": g.world,
        "requested_backend": g.requested_backend,
        "transfer": ctx.stats.snapshot(),
        "transport": {
            "mode": ctx.transport,
            "eager_threshold_bytes": ctx.eager_threshold,
            "zerocopy_threshold_bytes": ctx.zc_threshold,
            "zc_inflight_chunks": len(ctx._zc_inflight),
            "zc_inflight_bytes": ctx._zc_bytes,
        },
        "coordinator_model": {
            "latency_ewma_s": ctx.coord_lat_ewma,
            "bandwidth_ewma_bps": ctx.coord_bw_ewma,
        },
        "decisions": {f"{op}@{bucket}": dict(d)
                      for (op, bucket), d in g._decisions.items()},
    }
