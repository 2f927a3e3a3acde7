"""Device mesh construction, on ``torch.distributed``'s DeviceMesh.

Port of ``ray_tpu/parallel/mesh.py``. One mesh abstraction every
parallelism strategy rides on, with the same five named axes, outer
(slowest) to inner (most bandwidth-hungry):

    dp    pure data parallel (one gradient all-reduce a step)
    pp    pipeline stages (point to point)
    fsdp  sharded data parallel (per-layer all-gather / reduce-scatter)
    sp    sequence / context parallel
    tp    tensor parallel (an activation all-reduce every block)

Where JAX lays devices on a mesh, the port lays RANKS of the default
process group on a ``DeviceMesh`` with ``mesh_dim_names=AXIS_ORDER``: one
process per card, rank r on the mesh position JAX gives device r. Size-1
axes are kept, as JAX keeps them, so every preset names the same axes on
one card or many.

``MeshSpec`` and ``DCNSpec`` are copies (pure Python). A mesh is built over
the default group, which the caller starts (``torch.distributed.
init_process_group`` with its own address, rank and world size);
``local_mesh`` starts a one-rank group when none exists. ``device=None``
means CUDA (an NCCL group and a "cuda" mesh); only an explicit "cpu" gives
a "cpu" mesh, which needs a gloo group. Nothing falls back on its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "sp", "tp")


def has_physical_topology(devices: Sequence) -> bool:
    """JAX asks whether TPU devices carry torus coordinates. A CUDA rank
    carries no topology the port reads (NVLink within a host is all to
    all), so the answer is always False: every mesh is laid out
    positionally, rank by rank."""
    return False


@dataclass(frozen=True)
class MeshSpec:
    """Sizes per axis; -1 on at most one axis means "absorb the rest"."""
    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.sp, self.tp)

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = list(self.sizes())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = int(np.prod([s for s in sizes if s != -1]))
        if wild:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[wild[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh spec {tuple(sizes)} needs {known} devices, have {n_devices}")
        return MeshSpec(*sizes)

    @classmethod
    def data_parallel(cls, n: int = -1) -> "MeshSpec":
        return cls(dp=n)

    @classmethod
    def fsdp_only(cls, n: int = -1) -> "MeshSpec":
        return cls(fsdp=n)


@dataclass(frozen=True)
class DCNSpec:
    """Cross-slice factors of a multi-slice mesh: only dp and pp may cross
    slices (on GPUs: hosts), the per-layer fsdp/sp/tp collectives stay
    inside one."""

    dp: int = 1
    pp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        # rank-aligned with AXIS_ORDER: (dp, pp, fsdp, sp, tp)
        return (self.dp, self.pp, 1, 1, 1)

    def num_slices(self) -> int:
        return self.dp * self.pp


def _mesh_device(device) -> str:
    """"cuda" unless the caller asked for "cpu"; CUDA must be there."""
    from ray_tpu_torch import resolve_device

    return resolve_device(device).type


def _group_ranks(ranks: Optional[Sequence[int]]):
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call torch.distributed."
            "init_process_group (nccl for a cuda mesh, gloo for cpu) with "
            "its init_method, rank and world_size first, or use local_mesh")
    return list(range(dist.get_world_size())) if ranks is None \
        else [int(r) for r in ranks]


def _device_mesh(device_type: str, layout: np.ndarray):
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda":
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, layout, mesh_dim_names=AXIS_ORDER)


def build_mesh(spec: MeshSpec, ranks: Optional[Sequence[int]] = None,
               device=None):
    """A ``DeviceMesh`` with the canonical axis names over `ranks` (default:
    every rank of the default process group, in order), shaped by `spec`
    resolved against their number. Every rank of the group calls it."""
    ranks = _group_ranks(ranks)
    spec = spec.resolve(len(ranks))
    layout = np.asarray(ranks, dtype=np.int64).reshape(spec.sizes())
    return _device_mesh(_mesh_device(device), layout)


def _start_local_group(device_type: str) -> None:
    """A one-rank default group in an in-memory store: no address, no
    port, no file."""
    import torch.distributed as dist

    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def local_mesh(spec: Optional[MeshSpec] = None, device=None):
    """The mesh over this process's group. The port runs one process per
    card, so with no default group this starts a one-rank group (NCCL on
    the card, gloo for "cpu") and the mesh is this process's one card."""
    import torch.distributed as dist

    dev = _mesh_device(device)
    if not dist.is_initialized():
        _start_local_group(dev)
    return build_mesh(spec or MeshSpec(dp=-1), device=dev)


def hybrid_layout(spec: MeshSpec, dcn: DCNSpec, n: int) -> np.ndarray:
    """The rank array of ``build_hybrid_mesh`` over ranks 0..n-1: JAX's
    emulated multi-slice layout (ray_tpu/parallel/mesh.py, the branch for
    devices without slice_index). Slice s holds ranks s*per_slice ..; the
    slice id becomes the outer factor of each DCN axis, so total dp =
    dcn.dp * spec.dp with the DCN factor outermost."""
    n_slices = dcn.num_slices()
    if n % n_slices:
        raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    ici_shape = spec.resolve(n // n_slices).sizes()
    dcn_shape = dcn.sizes()
    combined = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    arr = np.arange(n).reshape((n_slices,) + ici_shape)
    arr = arr.reshape(dcn_shape + ici_shape)    # split slice -> dcn axes
    # interleave (dcn_dp, dcn_pp, ..., ici_dp, ici_pp, ...) into
    # (dcn_dp, ici_dp, dcn_pp, ici_pp, ...), then merge the pairs
    rank = len(ici_shape)
    order = []
    for i in range(rank):
        order.extend([i, rank + i])
    return arr.transpose(order).reshape(combined)


def build_hybrid_mesh(spec: MeshSpec, dcn: DCNSpec,
                      ranks: Optional[Sequence[int]] = None, device=None):
    """Multi-host mesh: `spec` shapes each slice (host), `dcn` spreads dp/pp
    across slices, with the same canonical axis names (total dp = dcn.dp *
    spec.dp), so every ShardingRules preset works unchanged. Ranks carry
    no slice metadata, so the layout is JAX's emulated one
    (``hybrid_layout``): slice s is ranks s*per_slice .. (s+1)*per_slice-1
    of `ranks`, which a launcher numbering hosts contiguously gives."""
    ranks = np.asarray(_group_ranks(ranks), dtype=np.int64)
    layout = ranks[hybrid_layout(spec, dcn, len(ranks))]
    return _device_mesh(_mesh_device(device), layout)


def mesh_axis_size(mesh, name: str) -> int:
    return int(mesh.size(AXIS_ORDER.index(name)))
