"""Parallelism presets: mesh + partition specs bound at ONE site.

Port of ``ray_tpu/parallel/presets.py``. A function decorated with
``sharded_jit(in_specs=..., out_specs=...)`` names only its partition
specs; the mesh it runs on is resolved at CALL time from a process-wide
default binding, so a re-mesh (``rebind_default_mesh``) reaches every
decorated function at once.

* **default-mesh registry**: ``set_default_mesh`` / ``default_mesh`` /
  ``default_rules`` / ``rebind_default_mesh``, with a generation counter
  that every re-binding bumps.
* **ParallelPreset**: a named (MeshSpec, ShardingRules) pair; ``bind()``
  builds the mesh over the default process group and installs it.
* **sharded_jit**: with in/out specs the function runs under
  ``torch.distributed.tensor.experimental.local_map`` over the resolved
  mesh (JAX's ``shard_map``): it sees each argument's local shard and its
  results are wrapped back as DTensors. Without specs it is a plain
  late-bound call: the port runs eagerly, so there is no ``jax.jit`` to
  stand in for (no ``torch.compile`` either). The wrapper built for a
  binding is cached and dropped when the binding's generation changes.
  JAX's ``axis_names`` (partial-manual shard_map), ``static_argnums`` and
  ``donate_argnums`` have no eager counterpart and are not taken.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from functools import wraps
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch import is_dtensor
from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch.parallel.sharding import (NamedSharding, PartitionSpec,
                                             ShardingRules, shard_tensor,
                                             spec_placements)

# --------------------------------------------------------------------------
# process-default mesh binding
# --------------------------------------------------------------------------

_lock = threading.Lock()
_binding: Dict[str, Any] = {"mesh": None, "rules": None, "spec": None,
                            "generation": 0}


def set_default_mesh(mesh, rules: Optional[ShardingRules] = None,
                     spec: Optional[MeshSpec] = None) -> None:
    """Install `mesh` as the process default that ``sharded_jit`` (and
    ``default_rules``) resolve at call time. Re-installing bumps the
    binding generation, invalidating every decorated function's cache."""
    with _lock:
        _binding["mesh"] = mesh
        if rules is not None:
            _binding["rules"] = rules
        if spec is not None:
            _binding["spec"] = spec
        _binding["generation"] += 1


def default_mesh():
    """The current process-default mesh (None if never bound)."""
    with _lock:
        return _binding["mesh"]


def default_rules() -> Optional[ShardingRules]:
    with _lock:
        return _binding["rules"]


def rebind_default_mesh(spec: Optional[MeshSpec] = None,
                        ranks: Optional[Sequence[int]] = None,
                        rules: Optional[ShardingRules] = None, device=None):
    """Rebuild the default mesh over the default group's CURRENT ranks (or
    `ranks`) with `spec` (or the spec the binding was installed with, or
    dp=-1): the one-call re-mesh after a resize. Every ``sharded_jit``
    function rebuilds its wrapper on its next call."""
    with _lock:
        spec = spec or _binding["spec"] or MeshSpec(dp=-1)
    mesh = build_mesh(spec, ranks, device=device)
    set_default_mesh(mesh, rules=rules, spec=spec)
    return mesh


def _binding_snapshot() -> Tuple[int, Any]:
    with _lock:
        return _binding["generation"], _binding["mesh"]


# --------------------------------------------------------------------------
# named presets
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelPreset:
    """A named parallelism recipe: mesh shape + sharding rules, bound in
    one call."""

    name: str
    mesh_spec: MeshSpec
    rules_name: str = "fsdp"

    def rules(self) -> ShardingRules:
        return getattr(ShardingRules, self.rules_name)()

    def build(self, ranks: Optional[Sequence[int]] = None, device=None):
        return build_mesh(self.mesh_spec, ranks, device=device)

    def bind(self, ranks: Optional[Sequence[int]] = None, device=None):
        """Build over the default group's ranks (or `ranks`) and install
        as the process default; returns the mesh."""
        mesh = self.build(ranks, device=device)
        set_default_mesh(mesh, rules=self.rules(), spec=self.mesh_spec)
        return mesh


PRESETS: Dict[str, ParallelPreset] = {
    "dp": ParallelPreset("dp", MeshSpec(dp=-1), "dp"),
    "fsdp": ParallelPreset("fsdp", MeshSpec(fsdp=-1), "fsdp"),
    "fsdp_tp": ParallelPreset("fsdp_tp", MeshSpec(fsdp=-1, tp=1), "fsdp_tp"),
    "full": ParallelPreset("full", MeshSpec(fsdp=-1, tp=1), "full"),
    "ep": ParallelPreset("ep", MeshSpec(dp=-1, fsdp=1), "ep"),
}


def get_preset(name: str) -> ParallelPreset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown parallel preset {name!r}; have {sorted(PRESETS)}")


# --------------------------------------------------------------------------
# the unified late-bound decorator
# --------------------------------------------------------------------------

def _placements(specs, mesh):
    """A spec (as a list: local_map reads a tuple as one entry per
    result), or a tuple of specs / Nones, as DTensor placements."""
    if isinstance(specs, PartitionSpec):
        return list(spec_placements(specs, mesh))
    return tuple(None if s is None else list(spec_placements(s, mesh))
                 for s in specs)


def _shard_map(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """JAX's shard_map on DTensors: whole tensors given as plain tensors
    are first placed by their spec (each rank keeps its block), then
    ``local_map`` redistributes DTensor arguments to their spec and runs
    `f` on the local shards."""
    in_pl = _placements(in_specs, mesh)
    body = local_map(f, out_placements=_placements(out_specs, mesh),
                     in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"sharded_jit: {len(args)} arguments for "
                            f"{len(in_specs)} in_specs")
        args = [shard_tensor(a, NamedSharding(mesh, s))
                if s is not None and hasattr(a, "shape") and
                not is_dtensor(a) else a
                for a, s in zip(args, in_specs)]
        return body(*args)

    return run


def sharded_jit(fn: Optional[Callable] = None, *,
                in_specs: Any = None,
                out_specs: Any = None,
                mesh=None) -> Callable:
    """Late-bound sharded call.

    in_specs/out_specs: a tuple of PartitionSpecs (None for a non-tensor
        argument), one per positional argument, and a PartitionSpec (or a
        tuple of them) for the result; both given => the body runs on local
        shards under ``local_map`` over the resolved mesh. Neither => a
        plain call, still gated on a bound mesh.
    mesh: a fixed mesh, or None to resolve the process default at every
        CALL: decorate once, rebind per resize.
    """
    if (in_specs is None) != (out_specs is None):
        raise ValueError("sharded_jit needs both in_specs and out_specs "
                         "(or neither, for a late-bound plain call)")

    def deco(f: Callable) -> Callable:
        cache: Dict[Any, Callable] = {}

        @wraps(f)
        def wrapped(*args):
            if mesh is not None:
                key, m = ("fixed", id(mesh)), mesh
            else:
                gen, m = _binding_snapshot()
                if m is None:
                    raise RuntimeError(
                        "sharded_jit: no default mesh bound; call "
                        "ray_tpu_torch.parallel.presets.set_default_mesh / "
                        "a preset's bind() first, or pass mesh= explicitly")
                key = ("default", gen)
            g = cache.get(key)
            if g is None:
                g = f if in_specs is None else _shard_map(f, m, in_specs,
                                                          out_specs)
                # one live binding per function: a rebind obsoletes the
                # old mesh's wrapper (its ranks may be gone)
                cache.clear()
                cache[key] = g
            return g(*args)

        wrapped.cache_info = lambda: dict(entries=len(cache))  # type: ignore
        return wrapped

    return deco(fn) if fn is not None else deco
