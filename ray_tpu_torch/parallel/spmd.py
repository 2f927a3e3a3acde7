"""Collectives over one named mesh axis, differentiable, for SPMD bodies.

The port's counterpart of what a ``jax.shard_map`` body uses over one mesh
axis: ``jax.lax.axis_index``/``axis_size`` (an ``Axis``' ``index`` and
``size``), ``ppermute`` and ``all_to_all`` (``tiled=True``). (The reference's ``parallel/_compat.py`` is
a shim of JAX's own API and has no counterpart.) Where JAX traces one
program for every device, each rank here runs the same Python, so every
rank of an axis must make the same calls in the same order; autograd keeps
that order in the backward as long as each rank builds the same graph.

- ``Axis``: one named dim of a DeviceMesh, its process group, this rank's
  coordinate on it (``index``) and its size. ``Axis.local()`` is a size-1
  axis with no group, what a 1-device mesh gives (no process group needed).
- ``ppermute(x, perm, axis)``: each pair (src, dst) sends src's x to dst;
  a rank that receives nothing gets zeros, as in JAX. Its backward is the
  inverse permutation (JAX's transpose of ppermute).
- ``all_to_all(x, split_dim, concat_dim, axis)``: JAX's tiled all-to-all:
  x split into ``axis.size`` blocks along split_dim, block j sent to rank
  j, the received blocks concatenated along concat_dim in rank order. Its
  backward is the inverse exchange.
- ``all_gather(x, dim, axis)``: JAX's tiled all_gather: every rank's x
  concatenated along dim in axis order. Its backward is the reduce-scatter:
  the cotangent summed over the axis, this rank's block kept.
- ``sendrecv``/``shift``, ``broadcast`` and ``all_reduce``: the plain
  (no autograd) exchanges the pipeline schedules make in their own
  forward and backward. A sum whose gradient passes unchanged is
  ``parallel.sharding.sum_in_forward``.

A pair (i, i) and a size-1 axis are local copies: nothing is sent to self,
so a 1-rank NCCL mesh runs without a collective. Tensors go through the
axis' own process group as they are: a CUDA tensor through NCCL, a CPU one
through gloo; nothing is staged on another device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Axis:
    """One named mesh dim: ``name``, ``size``, this rank's ``index`` and the
    global ranks of its group in axis order (``ranks``)."""

    def __init__(self, name: str, size: int, index: int, group=None,
                 ranks: Tuple[int, ...] = (0,)):
        self.name, self.size, self.index = name, int(size), int(index)
        self.group, self.ranks = group, tuple(ranks)

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        """The axis `name` of a DeviceMesh (``mesh=None``: a local axis)."""
        if mesh is None:
            return cls.local(name)
        dim = list(mesh.mesh_dim_names).index(name)
        size = int(mesh.size(dim))
        if size == 1:
            return cls.local(name)
        group = mesh.get_group(name)
        return cls(name, size, mesh.get_local_rank(name), group,
                   tuple(dist.get_process_group_ranks(group)))

    @classmethod
    def local(cls, name: str = "sp") -> "Axis":
        return cls(name, 1, 0)

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


def sendrecv(sends, recvs, axis: Axis):
    """Point to point over `axis`, no autograd: ``sends`` is [(tensor, dst
    index)], ``recvs`` [(like, src index)]; every send and receive is
    posted at once, then waited on. Returns the received tensors (each
    shaped and typed like its `like`)."""
    out = [torch.empty_like(like, memory_format=torch.contiguous_format)
           for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, x.contiguous(), axis.ranks[d], axis.group)
           for x, d in sends]
    ops += [dist.P2POp(dist.irecv, buf, axis.ranks[s], axis.group)
            for buf, (_, s) in zip(out, recvs)]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def shift(x, dst: int, like, src: int, axis: Axis):
    """Send x (None: nothing) to rank `dst` of the axis and receive a
    tensor like `like` (None: nothing) from rank `src`; the received
    tensor or None."""
    got = sendrecv([(x, dst)] if x is not None else [],
                   [(like, src)] if like is not None else [], axis)
    return got[0] if got else None


def _exchange(x, perm, axis: Axis):
    """One ppermute, no autograd."""
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if src and src[0] == me:            # (i, i): a local copy
        return x.clone(memory_format=torch.contiguous_format)
    got = sendrecv([(x, d) for d in dst], [(x, s) for s in src], axis)
    return got[0] if got else torch.zeros_like(
        x, memory_format=torch.contiguous_format)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, axis):
        ctx.perm, ctx.axis = perm, axis
        return _exchange(x, perm, axis)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _exchange(g, inverse, ctx.axis), None, None


def ppermute(x, perm: Sequence[Tuple[int, int]], axis: Axis):
    """``jax.lax.ppermute(x, axis_name, perm)`` over `axis`."""
    perm = [(int(s), int(d)) for s, d in perm]
    if axis.size == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, perm, axis)


def _blocks_to_ranks(x, split_dim: int, concat_dim: int, axis: Axis):
    n = axis.size
    send = torch.stack(torch.chunk(x, n, dim=split_dim))      # [n, ...]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, axis):
        ctx.dims, ctx.axis = (split_dim, concat_dim), axis
        return _blocks_to_ranks(x, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_blocks_to_ranks(g, concat_dim, split_dim, ctx.axis), None,
                None, None)


def all_to_all(x, split_dim: int, concat_dim: int, axis: Axis):
    """``jax.lax.all_to_all(x, axis_name, split_dim, concat_dim,
    tiled=True)`` over `axis`."""
    n = axis.size
    split_dim %= x.ndim
    concat_dim %= x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of shape "
                         f"{tuple(x.shape)} does not split into {n} blocks")
    if n == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, axis)


def _gather(x, dim: int, axis: Axis):
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.clone(memory_format=torch.contiguous_format),
                       ctx.axis)
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None,
                None)


def all_gather(x, dim: int, axis: Axis):
    """``jax.lax.all_gather(x, axis_name, axis=dim, tiled=True)`` over
    `axis`: the ranks' blocks concatenated along dim, rank (coordinate)
    order, which is the order DTensor lays out a ``Shard(dim)``."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, dim % x.ndim, axis)


def broadcast(x, src: int, axis: Optional[Axis]):
    """x as held by the rank at `src` on `axis`, on every rank of it (no
    autograd: the schedules' own backward calls it)."""
    if axis is None or axis.size == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, axis.ranks[src], group=axis.group)
    return x


def all_reduce(x, axis: Optional[Axis]):
    """x summed over `axis` in place (no autograd)."""
    if axis is not None and axis.size > 1:
        dist.all_reduce(x, group=axis.group)
    return x
