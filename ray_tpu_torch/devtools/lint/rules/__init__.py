"""Rule modules. Importing this package registers every rule."""

from ray_tpu_torch.devtools.lint.rules import (actor_get_cycle,  # noqa: F401
                                               blocking_async,
                                               channel_protocol,
                                               closure_capture, config_drift,
                                               divergent_collective,
                                               group_names, host_effect_jit,
                                               leaked_ref,
                                               locks, mesh_axes, pep479,
                                               schedule_divergence, spec_arity,
                                               unbounded_rpc,
                                               useless_suppression)
