"""ray_tpu_torch.collective — topology-aware host collectives.

Pluggable algorithms for exchanging CPU-side payloads between actors
(rollout fleets, data-pipeline shuffles, cross-slice host exchanges):

- ``gather`` — legacy single-coordinator funnel (small payloads);
- ``ring``   — chunked, pipelined ring reduce-scatter/all-gather
  (bandwidth-optimal: 2·(N−1)/N of the payload per rank);
- ``hier``   — hierarchical two-level allreduce (intra-node reduce →
  leader ring → intra-node broadcast), topology-aware via GCS node ids;
- ``auto``   — selected per call from world size and payload bytes.

Device collectives (psum/all-gather over ICI) stay inside jitted
programs — see ray_tpu_torch.parallel and ARCHITECTURE.md "Host collectives".

    from ray_tpu_torch import collective as col

    col.init_collective_group(world_size, rank, "fleet", backend="auto")
    total = col.allreduce(grads_pytree, "fleet")        # sync
    fut = col.allreduce_async(next_grads, "fleet")      # overlap compute
    col.destroy_collective_group("fleet")

Failure semantics: per-round timeouts + peer liveness probing — a dead
rank surfaces as ``CollectiveError`` on every survivor instead of a
deadlock.
"""

from ray_tpu_torch.collective.api import (GroupClient, allgather, allgather_async,
                                    allreduce, allreduce_async, barrier,
                                    barrier_async, broadcast, broadcast_async,
                                    coordinator_stats,
                                    destroy_collective_group,
                                    generation_name,
                                    get_collective_group_size,
                                    get_group_topology, get_rank, group_stats,
                                    init_collective_group, reducescatter,
                                    reducescatter_async,
                                    reform_collective_group,
                                    reset_transfer_stats,
                                    transfer_stats)
from ray_tpu_torch.collective.errors import CollectiveError, CollectiveTimeoutError
from ray_tpu_torch.collective.registry import (available_backends,
                                         register_backend, select_backend)
from ray_tpu_torch.collective.topology import Topology

__all__ = [
    "init_collective_group", "destroy_collective_group",
    "reform_collective_group", "generation_name",
    "allreduce", "allgather", "broadcast", "reducescatter", "barrier",
    "allreduce_async", "allgather_async", "broadcast_async",
    "reducescatter_async", "barrier_async",
    "get_rank", "get_collective_group_size", "get_group_topology",
    "transfer_stats", "reset_transfer_stats", "coordinator_stats",
    "group_stats",
    "available_backends", "register_backend", "select_backend",
    "CollectiveError", "CollectiveTimeoutError", "Topology", "GroupClient",
]
