"""Ring backend: bandwidth-optimal chunked collectives (``"ring"``).

Allreduce = reduce-scatter + all-gather around a logical ring
(Patarasuk & Yuan 2009): each rank sends 2·(N−1)/N of the payload total
— independent of N — instead of the gather backend's N× fan-in through
one coordinator. A per-step block in the inline-mailbox band is further
split into ``pipeline_chunks`` sub-chunks whose sends are all issued
before the first receive is drained, so transport overlaps with the
local accumulate (chunked pipelining); blocks in the zero-copy band go
as one store object per step, and in the all-gather phase the SAME
ObjectRef is forwarded hop-to-hop instead of re-staged (see
``ring_allreduce_flat`` phase 2).

Broadcast and barrier use a binary tree (log N rounds) rather than the
ring — latency-bound ops don't benefit from ring bandwidth.

The module-level helpers take an explicit ``ring_ranks`` subgroup and a
caller-supplied ``tag`` (which must embed the op's seq) so the
hierarchical backend can reuse them for its leader-only ring without
desynchronizing sequence numbers across ranks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ray_tpu_torch.collective.group import GroupContext


def _bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """np.array_split boundary arithmetic over a flat length."""
    q, r = divmod(n, parts)
    out, acc = [], 0
    for i in range(parts):
        size = q + (1 if i < r else 0)
        out.append((acc, acc + size))
        acc += size
    return out


def _sub_bounds(lo: int, hi: int, parts: int) -> List[Tuple[int, int]]:
    n = hi - lo
    if n <= 0:
        return [(lo, lo)]
    parts = max(1, min(parts, n))
    return [(lo + a, lo + b) for a, b in _bounds(n, parts)]


def _wire_subchunks(ctx: GroupContext, lo: int, hi: int, itemsize: int,
                    pipeline_chunks: int) -> List[Tuple[int, int]]:
    """Sub-chunk bounds for one per-step block, honoring the transport
    tiers: a block below ``collective_eager_threshold_bytes`` goes as ONE
    inline message — at small sizes the per-chunk fixed costs (actor RPC
    + pickle) dominate and pipelining only multiplies them — and a block
    big enough for the zero-copy tier ALSO goes as one piece, because the
    object store already decouples transfer from the mailbox rendezvous
    (sub-chunking a ref-mailed block would just multiply put/take/ack
    round-trips). Pipelining earns its keep only in the middle (inline
    mailbox) band. Sender and receiver compute this from identical
    sizes, so keys agree across ranks."""
    block = (hi - lo) * itemsize
    if block < ctx.eager_threshold:
        return [(lo, hi if hi > lo else lo)]
    if ctx.zc_threshold is not None and block >= ctx.zc_threshold:
        return [(lo, hi)]
    return _sub_bounds(lo, hi, pipeline_chunks)


def ring_allreduce_flat(ctx: GroupContext, buf: np.ndarray,
                        ring_ranks: Sequence[int], tag: str,
                        pipeline_chunks: int = 4) -> np.ndarray:
    """In-place SUM allreduce of a flat 1-D buffer over `ring_ranks`.

    Only the listed ranks may call; all of them must. Returns `buf`.
    """
    ranks = list(ring_ranks)
    n = len(ranks)
    if n == 1:
        return buf
    pos = ranks.index(ctx.rank)
    right = ranks[(pos + 1) % n]
    left = ranks[(pos - 1) % n]
    chunks = _bounds(buf.size, n)

    # phase 1 — reduce-scatter: after n-1 steps rank at `pos` holds
    # chunk `pos` fully reduced
    for step in range(n - 1):
        send_c = (pos - 1 - step) % n
        recv_c = (pos - 2 - step) % n
        send_subs = _wire_subchunks(ctx, *chunks[send_c], buf.itemsize,
                                    pipeline_chunks)
        recv_subs = _wire_subchunks(ctx, *chunks[recv_c], buf.itemsize,
                                    pipeline_chunks)
        ctx.send_many(right, [(f"{tag}:rs:{step}:{i}", buf[a:b])
                              for i, (a, b) in enumerate(send_subs)])
        for i, (a, b) in enumerate(recv_subs):
            part = ctx.recv(left, f"{tag}:rs:{step}:{i}", op="allreduce")
            if b > a:
                buf[a:b] += part

    # phase 2 — all-gather: circulate the reduced chunks. A zero-copy
    # chunk is put() into the store ONCE by its owner (hops=n-1) and the
    # same ObjectRef is forward()ed around the ring — the n-1 re-puts
    # (and their memcpys + pin RPCs) the naive loop would pay collapse
    # into envelope relays; only the final hop acks the owner.
    held: Dict[int, dict] = {}
    for step in range(n - 1):
        send_c = (pos - step) % n
        recv_c = (pos - step - 1) % n
        send_subs = _wire_subchunks(ctx, *chunks[send_c], buf.itemsize,
                                    pipeline_chunks)
        recv_subs = _wire_subchunks(ctx, *chunks[recv_c], buf.itemsize,
                                    pipeline_chunks)
        if step == 0:
            ctx.send_many(right, [(f"{tag}:ag:{step}:{i}", buf[a:b])
                                  for i, (a, b) in enumerate(send_subs)],
                          hops=n - 1)
        else:
            inline = []
            for i, (a, b) in enumerate(send_subs):
                env = held.get(i)
                if env is not None:
                    ctx.forward(right, f"{tag}:ag:{step}:{i}", env)
                else:
                    inline.append((f"{tag}:ag:{step}:{i}", buf[a:b]))
            if inline:
                ctx.send_many(right, inline)
        held = {}
        for i, (a, b) in enumerate(recv_subs):
            part, env = ctx.recv_fwd(left, f"{tag}:ag:{step}:{i}",
                                     op="allreduce")
            if b > a:
                buf[a:b] = part
            if env is not None and int(env.get("hops", 1)) > 1:
                held[i] = env
    return buf


def ring_reducescatter_flat(ctx: GroupContext, buf: np.ndarray,
                            ring_ranks: Sequence[int], tag: str,
                            pipeline_chunks: int = 4) -> np.ndarray:
    """Reduce-scatter half of the ring; returns this rank's reduced chunk."""
    ranks = list(ring_ranks)
    n = len(ranks)
    pos = ranks.index(ctx.rank)
    chunks = _bounds(buf.size, n)
    if n == 1:
        return buf
    right = ranks[(pos + 1) % n]
    left = ranks[(pos - 1) % n]
    for step in range(n - 1):
        send_c = (pos - 1 - step) % n
        recv_c = (pos - 2 - step) % n
        send_subs = _wire_subchunks(ctx, *chunks[send_c], buf.itemsize,
                                    pipeline_chunks)
        recv_subs = _wire_subchunks(ctx, *chunks[recv_c], buf.itemsize,
                                    pipeline_chunks)
        ctx.send_many(right, [(f"{tag}:rs:{step}:{i}", buf[a:b])
                              for i, (a, b) in enumerate(send_subs)])
        for i, (a, b) in enumerate(recv_subs):
            part = ctx.recv(left, f"{tag}:rs:{step}:{i}", op="reducescatter")
            if b > a:
                buf[a:b] += part
    lo, hi = chunks[pos]
    return buf[lo:hi]


def ring_allgather_obj(ctx: GroupContext, value,
                       ring_ranks: Sequence[int], tag: str) -> Dict[int, Any]:
    """Circulate arbitrary per-rank payloads; returns {rank: value}."""
    ranks = list(ring_ranks)
    n = len(ranks)
    pos = ranks.index(ctx.rank)
    out = {ctx.rank: value}
    if n == 1:
        return out
    right = ranks[(pos + 1) % n]
    left = ranks[(pos - 1) % n]
    cur = (ctx.rank, value)
    for step in range(n - 1):
        ctx.send(right, f"{tag}:agx:{step}", cur)
        cur = tuple(ctx.recv(left, f"{tag}:agx:{step}", op="allgather"))
        out[cur[0]] = cur[1]
    return out


def _tree_links(ranks: Sequence[int], root_rank: int, me: int):
    """Binary-tree parent/children of `me` in a tree rooted at root_rank."""
    ranks = list(ranks)
    n = len(ranks)
    root_idx = ranks.index(root_rank)
    v = (ranks.index(me) - root_idx) % n          # virtual index, root=0
    parent = ranks[((v - 1) // 2 + root_idx) % n] if v > 0 else None
    kids = [ranks[(c + root_idx) % n]
            for c in (2 * v + 1, 2 * v + 2) if c < n]
    return v, parent, kids


def tree_broadcast(ctx: GroupContext, value, src_rank: int,
                   ring_ranks: Sequence[int], tag: str):
    """log(N)-depth broadcast from src_rank down a binary tree."""
    v, parent, kids = _tree_links(ring_ranks, src_rank, ctx.rank)
    if parent is not None:
        value = ctx.recv(parent, f"{tag}:bc:{v}", op="broadcast")
    for kid in kids:
        kv, _, _ = _tree_links(ring_ranks, src_rank, kid)
        ctx.send(kid, f"{tag}:bc:{kv}", value)
    return value


def tree_barrier(ctx: GroupContext, ring_ranks: Sequence[int],
                 tag: str) -> None:
    """Tree reduce of arrival tokens + tree broadcast of the release."""
    ranks = list(ring_ranks)
    root = ranks[0]
    v, parent, kids = _tree_links(ranks, root, ctx.rank)
    for kid in kids:
        kv, _, _ = _tree_links(ranks, root, kid)
        ctx.recv(kid, f"{tag}:up:{kv}", op="barrier")
    if parent is not None:
        ctx.send(parent, f"{tag}:up:{v}", True)
    tree_broadcast(ctx, True, root, ranks, tag)


class RingBackend:
    name = "ring"

    def __init__(self, ctx: GroupContext, pipeline_chunks: int = 4):
        self.ctx = ctx
        self.pipeline_chunks = pipeline_chunks
        self._all = list(range(ctx.world))

    def allreduce(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        seq = self.ctx.next_seq()
        buf = np.ascontiguousarray(arr).ravel().copy()
        ring_allreduce_flat(self.ctx, buf, self._all, f"{seq}:ar",
                            self.pipeline_chunks)
        return buf.reshape(arr.shape)

    def allgather(self, value) -> List[Any]:
        seq = self.ctx.next_seq()
        by_rank = ring_allgather_obj(self.ctx, value, self._all, f"{seq}:ag")
        return [by_rank[r] for r in range(self.ctx.world)]

    def broadcast(self, value, src_rank: int):
        seq = self.ctx.next_seq()
        return tree_broadcast(self.ctx, value, src_rank, self._all,
                              f"{seq}:bc")

    def reducescatter(self, arr: np.ndarray) -> np.ndarray:
        # API layer guarantees arr.shape[0] % world == 0, so the equal
        # flat split below coincides with axis-0 blocks (C-contiguous).
        arr = np.ascontiguousarray(arr)
        seq = self.ctx.next_seq()
        world = self.ctx.world
        buf = arr.ravel().copy()
        chunk = ring_reducescatter_flat(self.ctx, buf, self._all,
                                        f"{seq}:rsc", self.pipeline_chunks)
        out_shape = (arr.shape[0] // world,) + arr.shape[1:]
        return chunk.reshape(out_shape)

    def barrier(self) -> None:
        seq = self.ctx.next_seq()
        tree_barrier(self.ctx, self._all, f"{seq}:bar")
