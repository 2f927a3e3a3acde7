"""The legacy coordinator-funnel backend (``"gather"``).

Every rank ships its full payload to one coordinator actor which
combines and re-broadcasts — O(world × bytes) through a single Python
process. Still the right tool for small payloads (one RTT, no
per-round peer bookkeeping) and the compatibility baseline the
equivalence suite measures ring/hier against; the coordinator actor
additionally serves as the group's bootstrap rendezvous (group.py).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ray_tpu_torch.collective.group import GroupContext


class GatherBackend:
    name = "gather"

    def __init__(self, ctx: GroupContext):
        self.ctx = ctx

    def allreduce(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(self.ctx.coord_exchange("allreduce_sum", arr))

    def allgather(self, value) -> List[Any]:
        return self.ctx.coord_exchange("allgather", value)

    def broadcast(self, value, src_rank: int):
        data = value if self.ctx.rank == src_rank else None
        return self.ctx.coord_exchange("broadcast", data)

    def reducescatter(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(self.ctx.coord_exchange("reducescatter", arr))

    def barrier(self) -> None:
        self.ctx.coord_exchange("barrier", None)
