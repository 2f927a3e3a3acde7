"""ray_tpu_torch.util — user-facing utilities.

Reference: python/ray/util/ (ActorPool, queue, placement groups, scheduling
strategies, metrics, collective).
"""

from ray_tpu_torch.util.placement_group import (PlacementGroup, placement_group,
                                          remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (NodeAffinitySchedulingStrategy,
                                                PlacementGroupSchedulingStrategy)
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Queue

__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
    "ActorPool", "Queue",
]
