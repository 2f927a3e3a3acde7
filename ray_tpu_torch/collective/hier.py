"""Hierarchical backend: two-level topology-aware allreduce (``"hier"``).

The standard host-collective scaling fix (Horovod's hierarchical
allreduce, Sergeev & Del Balso 2018) mapped onto this framework's
bandwidth domains (topology.py): ranks that share a node exchange over
the shm object store (cheap), and only one **leader per node** speaks on
the inter-node ring (expensive). Allreduce:

    1. intra-node reduce   — members push payloads to their node leader,
                             which accumulates in ascending-rank order;
    2. inter-node ring     — leaders ring-allreduce the node sums
                             (bandwidth-optimal across the slow domain);
    3. intra-node broadcast — leaders fan the result back out.

Inter-node traffic per node is 2·(L−1)/L of the payload (L = number of
nodes) regardless of how many ranks each node packs — the win over flat
ring grows with ranks-per-node. On a single node this degenerates to a
leader-funnel, which the equivalence suite still exercises as a distinct
code path.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from ray_tpu_torch.collective.group import GroupContext
from ray_tpu_torch.collective.ring import (ring_allreduce_flat, ring_allgather_obj,
                                     tree_barrier, tree_broadcast)


class HierBackend:
    name = "hier"

    def __init__(self, ctx: GroupContext, pipeline_chunks: int = 4):
        self.ctx = ctx
        self.pipeline_chunks = pipeline_chunks
        self.topo = ctx.topology
        self._all = list(range(ctx.world))

    def _intra_reduce(self, buf: np.ndarray, tag: str) -> np.ndarray:
        """Members → leader; leader returns the node-local sum."""
        ctx = self.ctx
        leader = self.topo.leader_of(ctx.rank)
        if ctx.rank != leader:
            ctx.send(leader, f"{tag}:ir:{ctx.rank}", buf)
            return buf
        # ascending-rank accumulation keeps the reduction order
        # deterministic and identical to the gather backend's
        total = None
        for r in self.topo.peers_on_node(ctx.rank):
            part = buf if r == ctx.rank else np.asarray(
                ctx.recv(r, f"{tag}:ir:{r}", op="allreduce"))
            total = part if total is None else total + part
        return total

    def _intra_broadcast(self, value, tag: str):
        ctx = self.ctx
        leader = self.topo.leader_of(ctx.rank)
        if ctx.rank == leader:
            for r in self.topo.peers_on_node(ctx.rank):
                if r != ctx.rank:
                    ctx.send(r, f"{tag}:ib:{r}", value)
            return value
        return ctx.recv(leader, f"{tag}:ib:{ctx.rank}", op="allreduce")

    def allreduce(self, arr: np.ndarray) -> np.ndarray:
        ctx = self.ctx
        arr = np.asarray(arr)
        seq = ctx.next_seq()
        tag = f"{seq}:h"
        buf = np.ascontiguousarray(arr).ravel().copy()
        total = self._intra_reduce(buf, tag)
        if self.topo.is_leader(ctx.rank):
            leaders = list(self.topo.leader_ranks())
            ring_allreduce_flat(ctx, total, leaders, f"{tag}:lr",
                                self.pipeline_chunks)
        out = np.asarray(self._intra_broadcast(
            total if self.topo.is_leader(ctx.rank) else None, tag))
        return out.reshape(arr.shape)

    def allgather(self, value) -> List[Any]:
        ctx = self.ctx
        seq = ctx.next_seq()
        tag = f"{seq}:hg"
        leader = self.topo.leader_of(ctx.rank)
        if ctx.rank != leader:
            ctx.send(leader, f"{tag}:ir:{ctx.rank}", value)
        else:
            node_vals = {}
            for r in self.topo.peers_on_node(ctx.rank):
                node_vals[r] = value if r == ctx.rank else ctx.recv(
                    r, f"{tag}:ir:{r}", op="allgather")
            leaders = list(self.topo.leader_ranks())
            merged: dict = {}
            for vals in ring_allgather_obj(ctx, node_vals, leaders,
                                           f"{tag}:lg").values():
                merged.update(vals)
        full = self._intra_broadcast(
            merged if ctx.rank == leader else None, tag)
        return [full[r] for r in range(ctx.world)]

    def broadcast(self, value, src_rank: int):
        seq = self.ctx.next_seq()
        return tree_broadcast(self.ctx, value, src_rank, self._all,
                              f"{seq}:hb")

    def reducescatter(self, arr: np.ndarray) -> np.ndarray:
        # full hierarchical reduce, then keep this rank's axis-0 block —
        # trades some intra-node broadcast bytes for reusing the
        # leader-ring path (inter-node volume is what hier optimizes)
        arr = np.ascontiguousarray(arr)
        world = self.ctx.world
        total = self.allreduce(arr)
        per = arr.shape[0] // world
        return total[self.ctx.rank * per:(self.ctx.rank + 1) * per]

    def barrier(self) -> None:
        seq = self.ctx.next_seq()
        tree_barrier(self.ctx, self._all, f"{seq}:hbar")
