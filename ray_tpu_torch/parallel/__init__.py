"""ray_tpu_torch.parallel: one mesh abstraction, parallelism as sharding
presets, on ``torch.distributed``'s DeviceMesh and DTensor.

Port of ``ray_tpu/parallel``: ``mesh.py`` (MeshSpec, build_mesh over the
ranks of the default process group), ``sharding.py`` (ShardingRules and
their DTensor placements), ``presets.py`` (the default-mesh registry and
``sharded_jit``), ``train_step.py`` (the training step, unsharded or
sharded: params and AdamW state as DTensors), ``spmd.py`` (ppermute,
all_to_all and P2P exchanges over one mesh axis: what a
``shard_map`` body uses) and ``pipeline.py`` (GPipe and 1F1B over pp).

    from ray_tpu_torch.parallel import MeshSpec, build_mesh, ShardingRules

    mesh = build_mesh(MeshSpec(fsdp=2, tp=2))   # default group of 4 ranks
    rules = ShardingRules.fsdp_tp()

Import-light: importing the package imports none of its modules and
starts no process group; each name below loads its module on first use.
"""

import importlib

_EXPORTS = {
    "mesh": ("MeshSpec", "DCNSpec", "AXIS_ORDER", "build_mesh",
             "build_hybrid_mesh", "local_mesh", "mesh_axis_size"),
    "sharding": ("ShardingRules", "PartitionSpec", "NamedSharding",
                 "logical_to_mesh", "spec_placements", "named_sharding",
                 "tree_shardings", "shard_params"),
    "presets": ("ParallelPreset", "PRESETS", "get_preset", "sharded_jit",
                "set_default_mesh", "default_mesh", "default_rules",
                "rebind_default_mesh"),
    "pipeline": ("pipeline_trunk", "pipeline_train_1f1b", "stack_stages",
                 "unstack_stages"),
}
_MODULES = ("mesh", "sharding", "presets", "train_step", "spmd", "pipeline")
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
