"""Negative: rank arms agree on the device collective order.

One arm routes through a helper and the other inlines the same
sequence — the linearized schedules are identical, so every rank
walks the rendezvous points in the same order. Rank-dependent
*non-collective* work stays free, and device collectives outside any
rank branch are straight-line SPMD code.
"""

import torch.distributed as dist

from ray_tpu_torch.parallel import spmd


def _sync_then_fence(grads, axis):
    spmd.all_reduce(grads, axis)
    dist.barrier()


def finish_step(rank, grads, metrics, axis):
    if rank == 0:
        metrics["steps"] = metrics.get("steps", 0) + 1   # rank-only work
        _sync_then_fence(grads, axis)
    else:
        spmd.all_reduce(grads, axis)
        dist.barrier()


def device_side(x, mesh):
    y = spmd.all_reduce(x, spmd.Axis.of(mesh, "dp"))
    return spmd.all_to_all(y, 0, 1, spmd.Axis.of(mesh, "dp"))
