"""Positive: axis names nothing in the project declares.

The mesh declares ("dp", "tp") — via the module constant and a literal
DeviceMesh construction — but the PartitionSpec says "fdsp" (a classic
transposition of "fsdp") and the all_reduce's Axis names "model", which
no mesh axis matches. Both raise only once a real mesh is attached.
"""

from torch.distributed.device_mesh import DeviceMesh
from ray_tpu_torch.parallel import sharding, spmd
from ray_tpu_torch.parallel.sharding import PartitionSpec as P

AXIS_ORDER = ("dp", "tp")


def build(layout):
    return DeviceMesh("cuda", layout, mesh_dim_names=("dp", "tp"))


def shard_params(w, mesh):
    return sharding.shard_tensor(w, sharding.NamedSharding(mesh, P("fdsp")))


def grad_sync(g, mesh):
    return spmd.all_reduce(g, spmd.Axis.of(mesh, "model"))  # undeclared


# --- the port's other axis-use forms, each naming an undeclared axis ---

def queries(mesh, x, rules):
    from ray_tpu_torch.parallel.mesh import mesh_axis_size
    from ray_tpu_torch.parallel.sharding import mesh_groups

    n = mesh_axis_size(mesh, "tpp")                 # axis query
    g = mesh.get_group("fdsp")                      # DeviceMesh group
    r = mesh.get_local_rank("pd")                   # DeviceMesh coordinate
    sub = mesh["sq"]                                # DeviceMesh slice
    groups = mesh_groups(mesh, ["dp", "tpx"])       # one of two undeclared
    local = spmd.Axis.local("spx")                  # local axis
    rules = rules.with_(seq="ssp")                  # ShardingRules value
    return n, g, r, sub, groups, local, rules
