"""Positive: rank arms reach the same device collectives in a different order.

Both arms issue {all_reduce, broadcast} over the "dp" axis — so the
set-based divergent-collective rule sees convergence and stays quiet —
but rank 0 all-reduces first (through a helper, exercising the
interprocedural linearization) while everyone else broadcasts first.
Rank 0 blocks in the all-reduce rendezvous, the rest block in the
broadcast, and the whole gang wedges until the NCCL timeout.
"""

from ray_tpu_torch.parallel import spmd


def _sync_grads(grads, mesh):
    spmd.all_reduce(grads, spmd.Axis.of(mesh, "dp"))


def finish_step(rank, grads, mesh):
    if rank == 0:
        _sync_grads(grads, mesh)           # all_reduce, then broadcast
        spmd.broadcast(grads, 0, spmd.Axis.of(mesh, "dp"))
    else:
        spmd.broadcast(grads, 0, spmd.Axis.of(mesh, "dp"))  # reversed
        spmd.all_reduce(grads, spmd.Axis.of(mesh, "dp"))
