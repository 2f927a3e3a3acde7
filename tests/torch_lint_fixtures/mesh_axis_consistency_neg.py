"""Negative: every literal axis name is declared by a mesh.

Uses span all the contexts the extract records — PartitionSpec
literals, axis_name kwargs, spmd Axes, an axis-name default —
and each one names an axis from AXIS_ORDER or the MeshSpec kwargs.
Dynamic axis names (variables) are never checked.
"""

from torch.distributed.device_mesh import init_device_mesh
from ray_tpu_torch.parallel import sharding, spmd
from ray_tpu_torch.parallel.sharding import PartitionSpec as P

from ray_tpu_torch.parallel.mesh import MeshSpec

AXIS_ORDER = ("dp", "fsdp", "tp")


def build():
    spec = MeshSpec(dp=2, tp=4)
    return init_device_mesh("cuda", (2, 4), mesh_dim_names=("dp", "tp")), spec


def shard_params(w, mesh):
    return w, sharding.NamedSharding(mesh, P(None, "fsdp"))


def grad_sync(g, mesh, axis_name="dp"):
    return spmd.all_reduce(g, spmd.Axis.of(mesh, axis_name))


def attention(q, k, v, mesh):
    return spmd.all_to_all(k, 1, 2, spmd.Axis.of(mesh, "tp")), mesh["dp"]


def dynamic(x, mesh, axis):
    return spmd.all_reduce(x, spmd.Axis.of(mesh, axis))  # variable axis


# --- the port's other axis-use forms, each naming a declared axis ---

def queries(mesh, x, rules):
    from ray_tpu_torch.parallel.mesh import mesh_axis_size
    from ray_tpu_torch.parallel.sharding import mesh_groups

    n = mesh_axis_size(mesh, "tp")
    g = mesh.get_group("fsdp")
    r = mesh.get_local_rank("dp")
    groups = mesh_groups(mesh, ["dp", "tp"])
    local = spmd.Axis.local("dp")
    rules = rules.with_(seq="tp")
    return n, g, r, groups, local, rules
