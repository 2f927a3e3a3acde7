"""Negative: convergent device collectives and rank-local branching."""
import torch.distributed as dist


def sync_params(grads):
    dist.all_reduce(grads)              # unconditional: every rank calls
    dist.barrier()
    return grads


def share_seed(rank, seed):
    # convergent: both arms make the broadcast call, so every rank
    # reaches the rendezvous (src sends its tensor, the rest receive)
    value = dist.broadcast(seed, 0) if rank == 0 else dist.broadcast(seed, 0)
    return value


def log_on_leader(rank, stats, sink):
    dist.barrier()                      # all ranks sync first
    if rank == 0:
        sink.write(stats)               # rank-local work is fine to branch


# --- the port's spmd exchanges: every rank of the axis calls them ---

def ring_step(x, perm, axis, rank):
    from ray_tpu_torch.parallel import spmd

    x = spmd.ppermute(x, perm, axis)
    if rank == 0:
        x = x * 2                           # rank-local work after it
    return x


def stage_io(x, axis, rank):
    from ray_tpu_torch.parallel import spmd

    if rank == 0:
        got = spmd.shift(x, 1, None, 0, axis)
    else:
        got = spmd.shift(None, 0, x, 0, axis)
    return got
