"""mesh-axis-consistency: literal axis names must be declared somewhere.

An axis name that no mesh in the project declares is almost always a
typo, and the port does not make it loud everywhere. ``logical_to_mesh``
drops axes whose mesh size is 1 (``sizes.get(axis, 1)``), so a
``ShardingRules`` value ``embed="fdsp"`` silently *replicates* every
parameter instead of sharding it: no error, no speedup, 8x the memory.
A literal ``P("fdsp")`` or ``Axis.of(mesh, "spp")`` raises only once a
mesh is attached, and a size-1 ``Axis`` never looks the name up at all
(``Axis.of(None, ...)`` is a local axis) — so one-card runs pass.

Uses are the port's literal axis names: ``PartitionSpec``/``P``
entries, ``ShardingRules`` values (and ``.with_(seq="sp")``),
``Axis.of(mesh, "x")``/``Axis.local("x")``, ``mesh_axis_size(mesh,
"x")``, ``mesh.get_group("x")``/``mesh.get_local_rank("x")``,
``mesh["x"]``, ``mesh_groups(mesh, [...])``, ``axis_name=`` kwargs and
defaults. The declared-axes universe is the union over the whole
project — module constants like ``AXIS_ORDER = ("dp", "pp", ...)``,
literal ``DeviceMesh(..., mesh_dim_names=...)``/``init_device_mesh(...,
mesh_dim_names=...)`` tuples, and ``MeshSpec``/``DCNSpec`` keyword
names. The rule stays silent when that universe is empty (a tree that
never declares a mesh has nothing to check against), which also keeps
single-file fixtures self-contained.
"""

from __future__ import annotations

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

_CTX_WORDS = {
    "partition-spec": "PartitionSpec",
    "axis-kwarg": "axis_name= kwarg",
    "axis-default": "axis_name default",
    "axis-of": "spmd Axis",
    "axis-query": "mesh axis query",
    "mesh-groups": "mesh_groups list",
    "rules-value": "ShardingRules value",
}


@register
class MeshAxisConsistency(Rule):
    id = "mesh-axis-consistency"
    doc = ("literal axis name not declared by any mesh/preset in the "
           "project — unknown axes silently replicate instead of "
           "sharding (size-1 mesh axes are dropped from placements)")
    hint = ("fix the axis-name typo, or declare the axis on a mesh "
            "(AXIS_ORDER / DeviceMesh(..., mesh_dim_names=...) / "
            "MeshSpec kwarg)")
    scope = "graph"

    def check_graph(self, graph):
        declared = graph.declared_axes()
        if not declared:
            return
        universe = sorted(declared)
        for nid, s in sorted(graph.functions.items()):
            path = graph.fn_path.get(nid, "?")
            seen = set()
            for ax, line, col, ctx in (s.spmd or {}).get("axis_uses", []):
                if ax in declared or (ax, line, col) in seen:
                    continue
                seen.add((ax, line, col))
                where = _CTX_WORDS.get(ctx, ctx)
                yield Finding(
                    rule=self.id, path=path, line=line, col=col,
                    message=(f"axis {ax!r} in a {where} is not declared "
                             f"by any mesh in the project (declared: "
                             f"{', '.join(universe)}) — an unknown axis "
                             "silently replicates instead of sharding"),
                    hint=self.hint,
                    spmd={"axis": ax, "context": ctx,
                          "declared_axes": universe})
