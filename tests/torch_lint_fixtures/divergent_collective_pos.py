"""Positive: device collectives only some ranks reach."""
import torch.distributed as dist


def sync_params(grads, rank):
    if rank == 0:
        total = dist.all_reduce(grads)  # ranks 1..n never enter -> deadlock
    else:
        total = None
    return total


def checkpoint(state, world):
    if dist.get_rank() == 0:
        dist.barrier()                  # only rank 0 hits the rendezvous
        return state


def leader_gate(self, data):
    if self.is_leader:
        dist.broadcast(data, src=0)     # leader-only broadcast hangs the rest
    return data


# --- the port's spmd exchanges, directly and through a helper ---

def ring_step(x, perm, axis, rank):
    from ray_tpu_torch.parallel import spmd

    if rank == 0:
        x = spmd.ppermute(x, perm, axis)    # the other ranks never send
    return x


def _exchange(x, axis):
    from ray_tpu_torch.parallel import spmd

    return spmd.all_to_all(x, 1, 2, axis)


def head_exchange(x, axis, rank):
    if rank != 0:
        x = _exchange(x, axis)              # rank 0 never exchanges
    return x
