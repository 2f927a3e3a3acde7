"""Logical-axis sharding rules: parallelism strategies as presets, on DTensor.

Port of ``ray_tpu/parallel/sharding.py``. Models annotate every parameter
and activation with logical axis names ('batch', 'seq', 'embed', 'heads',
'mlp', 'vocab', ...); a ``ShardingRules`` preset maps them to mesh axes:

    dp()       replicated params, batch over (dp, fsdp)      (DDP)
    fsdp()     + params and optimizer state over fsdp        (ZeRO-3)
    fsdp_tp()  + Megatron tensor axes over tp                (TP)
    full()     + sequence over sp                            (SP)
    ep()       experts over (dp, fsdp)                       (EP)

``logical_to_mesh`` gives JAX's ``PartitionSpec`` (here a tuple of the same
entries); ``spec_placements`` turns it into one DTensor ``Placement`` per
mesh dim (``Shard(d)`` or ``Replicate()``), and ``shard_params`` places a
param tree as DTensors holding only this rank's shards. Shards are even:
a dim that the mesh axes sharding it do not divide raises.

Also here, the two autograd-aware all-reduces of the port's sharded
forward (Megatron's f and g): ``sum_in_backward`` before a column-parallel
matmul and ``sum_in_forward`` after a row-parallel one (and over the data
axes for the loss).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

AxisVal = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per tensor dim, None (replicated),
    a mesh axis name, or a tuple of names (the dim split over several axes,
    the first outermost). Trailing Nones are dropped."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, AxisVal], ...]

    def as_dict(self) -> Dict[str, AxisVal]:
        return dict(self.rules)

    def with_(self, **updates) -> "ShardingRules":
        d = self.as_dict()
        d.update(updates)
        return ShardingRules(tuple(d.items()))

    # ---- presets -----------------------------------------------------------

    @classmethod
    def dp(cls) -> "ShardingRules":
        """Pure data parallel: replicated params (DDP-equivalent)."""
        return cls((
            ("batch", ("dp", "fsdp")),
            ("seq", None), ("embed", None), ("mlp", None), ("heads", None),
            ("kv_heads", None), ("head_dim", None), ("vocab", None),
            ("layers", None), ("stages", "pp"), ("experts", None),
            ("expert_mlp", None),
        ))

    @classmethod
    def fsdp(cls) -> "ShardingRules":
        """ZeRO-3-equivalent: params, grads and optimizer state sharded on
        fsdp, batch on (dp, fsdp); each layer's weights gathered at use."""
        return cls.dp().with_(embed="fsdp")

    @classmethod
    def fsdp_tp(cls) -> "ShardingRules":
        """+ Megatron tensor parallelism: head/mlp/vocab dims on tp."""
        return cls.fsdp().with_(mlp="tp", heads="tp", vocab="tp")

    @classmethod
    def full(cls) -> "ShardingRules":
        """+ sequence parallelism: the activation seq dim on sp."""
        return cls.fsdp_tp().with_(seq="sp")

    @classmethod
    def ep(cls) -> "ShardingRules":
        """Expert parallel MoE: experts over the data axes, dense dims as in
        fsdp_tp."""
        return cls.fsdp_tp().with_(experts=("dp", "fsdp"), expert_mlp="tp",
                                   embed=None)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a MeshSpec (resolved
    sizes), so specs can be computed without a process group."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(AXIS_ORDER, mesh.sizes()))
    return {n: int(mesh.size(i)) for i, n in enumerate(mesh.mesh_dim_names)}


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh dims' names, outer to inner (a MeshSpec's: AXIS_ORDER)."""
    if isinstance(mesh, MeshSpec):
        return AXIS_ORDER
    return tuple(mesh.mesh_dim_names)


def logical_to_mesh(logical_spec: Tuple[Optional[str], ...],
                    rules: ShardingRules, mesh=None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec. Mesh axes of
    size 1 are dropped (a size-1 axis shards nothing), and so are trailing
    Nones, as in JAX."""
    table = rules.as_dict()
    sizes = axis_sizes(mesh) if mesh is not None else None
    out = []
    for name in logical_spec:
        axes = table.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        if sizes is not None:
            axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def spec_placements(spec: Sequence[AxisVal], mesh) -> tuple:
    """One DTensor Placement per mesh dim: ``Shard(d)`` on every mesh axis
    that spec entry d names, ``Replicate()`` elsewhere. An entry of several
    axes (("dp", "fsdp") on batch) shards dim d on each of their mesh dims;
    DTensor splits in mesh-dim order, so the axes must come in AXIS_ORDER
    (JAX's major-to-minor)."""
    names = list(axis_names(mesh))
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in mesh axis order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a mesh and a PartitionSpec, read as DTensor
    placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def named_sharding(mesh, logical_spec, rules: ShardingRules) -> NamedSharding:
    return NamedSharding(mesh, logical_to_mesh(tuple(logical_spec), rules,
                                               mesh))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def tree_shardings(mesh, logical_tree: Any, rules: ShardingRules):
    """Map a tree (nested dicts) of logical-axis tuples to the same tree of
    NamedShardings."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, rules)
                for k, v in logical_tree.items()}
    if not _is_spec(logical_tree):
        raise TypeError(f"not a logical spec: {logical_tree!r}")
    return named_sharding(mesh, logical_tree, rules)


def check_divisible(shape, spec, mesh, what: str = "tensor") -> None:
    """Shards are even: raise unless the mesh axes that spec entry d names
    divide dim d, for every d."""
    sizes = axis_sizes(mesh)
    for d, axes in enumerate(spec):
        axes = () if axes is None else (axes,) if isinstance(axes, str) \
            else axes
        k = 1
        for a in axes:
            k *= sizes[a]
        if shape[d] % k:
            raise ValueError(
                f"{what}: dim {d} of shape {tuple(shape)} is {shape[d]}, "
                f"which mesh axes {tuple(axes)} (size {k}) do not divide")


def local_shard(t, mesh, placements, what: str = "tensor"):
    """This rank's block of the whole tensor `t` under `placements` (a
    view): each Shard(d) on mesh dim i narrows dim d to the rank's
    coordinate on i, in mesh-dim order, as DTensor lays shards out."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n, r = divmod(t.shape[p.dim], int(mesh.size(i)))
            if r:
                raise ValueError(
                    f"{what}: dim {p.dim} of shape {tuple(t.shape)} does not "
                    f"split evenly over mesh axis "
                    f"{mesh.mesh_dim_names[i]!r} of size {mesh.size(i)}")
            t = t.narrow(p.dim, coord[i] * n, n)
    return t


def shard_tensor(t, sharding: NamedSharding, device=None,
                 what: str = "tensor"):
    """A DTensor of the whole tensor `t` that holds only this rank's shard:
    the block is copied (onto `device` when given), so `t` may be freed."""
    check_divisible(t.shape, sharding.spec, sharding.mesh, what)
    pl = sharding.placements
    local = local_shard(t, sharding.mesh, pl, what)
    local = local.detach().to(device=device or local.device, copy=True,
                              memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=t.shape, stride=contiguous_stride(t.shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of `shape`."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def leaf_placer(mesh, logical_tree, rules: ShardingRules, device=None):
    """``place(path, t)``: the whole tensor t of the param at `path` (a
    tuple of keys) as a DTensor placed by its logical spec, holding only
    this rank's shard. The hook ``llama.init_params`` takes as ``leaf``,
    so each leaf is sharded as soon as it is drawn."""
    shardings = tree_shardings(mesh, logical_tree, rules)

    def place(path, t):
        sh = shardings
        for k in path:
            sh = sh[k]
        return shard_tensor(t, sh, device, "/".join(path))

    return place


def shard_params(mesh, params, logical_tree, rules: ShardingRules,
                 device=None):
    """Place a param tree (nested dicts of whole tensors) as DTensors by
    its logical annotations; each leaf keeps only this rank's shard."""
    place = leaf_placer(mesh, logical_tree, rules, device)

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        return place(path, node)

    return rec(params, ())


def gathered(x):
    """A DTensor as the whole tensor on this rank (an all-gather; a
    replicated DTensor's local tensor as it is); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    if all(isinstance(p, Replicate) for p in x.placements):
        return x.to_local()
    return x.full_tensor()


# --- Megatron's f and g -----------------------------------------------------


def mesh_groups(mesh, names: Sequence[str]) -> list:
    """The process groups of the named mesh axes of size > 1."""
    sizes = axis_sizes(mesh)
    return [mesh.get_group(n) for n in names if sizes[n] > 1]


def _all_reduce(x, groups):
    x = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _SumInForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


def sum_in_forward(x, groups):
    """Sum x over the groups' ranks; the gradient passes unchanged
    (Megatron's g: after a row-parallel matmul, or a loss summed over the
    data ranks, whose every rank then back-propagates its own part)."""
    return _SumInForward.apply(x, groups) if groups else x


def sum_in_backward(x, groups):
    """x unchanged; its gradient summed over the groups' ranks (Megatron's
    f: before column-parallel matmuls, each rank holding part of the
    input's gradient)."""
    return _SumInBackward.apply(x, groups) if groups else x
