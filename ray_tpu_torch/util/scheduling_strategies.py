"""Scheduling strategies accepted by @remote(scheduling_strategy=...).

Reference: python/ray/util/scheduling_strategies.py:15,41.
"""

from __future__ import annotations

from typing import Optional, Union

from ray_tpu_torch.core.common import (NodeAffinityStrategy, PlacementGroupStrategy,
                                 SpreadStrategy)
from ray_tpu_torch.core.ids import NodeID


def PlacementGroupSchedulingStrategy(placement_group,
                                     placement_group_bundle_index: int = -1):
    return PlacementGroupStrategy(pg_id=placement_group.id,
                                  bundle_index=placement_group_bundle_index)


def NodeAffinitySchedulingStrategy(node_id: Union[str, NodeID], soft: bool = False):
    if isinstance(node_id, str):
        node_id = NodeID.from_hex(node_id)
    return NodeAffinityStrategy(node_id=node_id, soft=soft)


SPREAD = SpreadStrategy()
