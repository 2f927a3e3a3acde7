"""Host-level collective ops among actors/tasks — compatibility shim.

The implementation moved to the ``ray_tpu_torch.collective`` package
(topology-aware backends: legacy ``gather`` coordinator, bandwidth-
optimal ``ring``, hierarchical ``hier``; async variants; member-failure
detection). This module re-exports the same surface the reference's
``python/ray/util/collective/collective.py`` offered so existing
callers keep working unchanged; new code should import
``ray_tpu_torch.collective`` directly.

TPU-native position (SURVEY.md §5.8): *device* collectives live inside
jitted programs (psum/all_gather over ICI emitted by XLA — see
ray_tpu_torch.parallel), so this surface only covers the HOST-side use case:
exchanging CPU arrays between actors (rollout fleets, data pipelines).
"""

from __future__ import annotations

from ray_tpu_torch.collective import (CollectiveError, CollectiveTimeoutError,
                                allgather, allgather_async, allreduce,
                                allreduce_async, barrier, barrier_async,
                                broadcast, broadcast_async,
                                destroy_collective_group,
                                get_collective_group_size, get_rank,
                                init_collective_group, reducescatter,
                                reducescatter_async, transfer_stats)

__all__ = [
    "init_collective_group", "destroy_collective_group",
    "allreduce", "allgather", "broadcast", "reducescatter", "barrier",
    "allreduce_async", "allgather_async", "broadcast_async",
    "reducescatter_async", "barrier_async",
    "get_rank", "get_collective_group_size", "transfer_stats",
    "CollectiveError", "CollectiveTimeoutError",
]
