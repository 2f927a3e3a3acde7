"""Pluggable collective backends for the WorkerGroup.

Port of ``ray_tpu/train/backend.py`` (reference: python/ray/train/_internal/
backend_executor.py, Backend's on_start/on_training_start hooks run per
framework, and the per-framework configs: torch (train/torch/config.py:29,
69 — init_process_group with a rank-0 TCP rendezvous), tensorflow
(TF_CONFIG), horovod (Gloo rendezvous)).

The primary backend is ``ProcessGroupBackend``, the counterpart of the JAX
package's ``JaxBackend``: where that one starts ``jax.distributed`` for a
gang of more than one worker, this one starts the default
``torch.distributed`` process group, gloo over CPU workers (a gang of GPU
workers waits for a card pinned to each); the collectives then run inside
the step (DTensor redistributes, DDP all-reduces). ``TorchBackend`` (gloo by
default, a group even for one worker) and ``TensorflowBackend`` are copies.
"""

from __future__ import annotations

from typing import Optional

#: how long a rank waits at the group's rendezvous for the others
_GROUP_TIMEOUT_S = 120.0


class Backend:
    """Worker-side collective bootstrap hooks. Instances are pickled to
    workers, so keep them stateless/config-only."""

    #: backends that need a rendezvous address even for world_size == 1
    needs_coordinator: bool = False
    #: set by the worker before on_worker_setup: whether it holds a unit
    #: of the GPU resource (ScalingConfig.holds_gpu)
    holds_gpu: bool = False

    def on_worker_setup(self, rank: int, world_size: int,
                        coordinator: Optional[str]) -> None:
        """Runs inside every worker before the train loop."""

    def on_worker_shutdown(self) -> None:
        """Runs inside every worker after the loop (best-effort)."""


class ProcessGroupBackend(Backend):
    """Bring up the default ``torch.distributed`` process group so that
    every worker of the gang is one rank of it (the counterpart of the JAX
    package's ``JaxBackend``, which starts ``jax.distributed`` instead;
    upstream's ``_setup_torch_process_group``, train/torch/config.py:69).
    Only a gang of more than one worker gets a group, as ``JaxBackend``
    starts ``jax.distributed`` only then; a single worker that needs one
    (a mesh) starts a one-rank group itself (``session.get_mesh``).
    The group is gloo, over workers that compute on the CPU
    (``session.get_device`` holds a loop to that). Workers that hold a
    GPU unit would need NCCL and a card pinned to each; nothing pins one
    yet (ROADMAP.md queue 1 item 14), so such a gang is refused."""

    def on_worker_setup(self, rank, world_size, coordinator):
        if not (coordinator and world_size > 1):
            return
        if self.holds_gpu:
            raise RuntimeError(
                f"a gang of {world_size} workers that each hold a GPU unit "
                "needs one card pinned to each worker, which the port does "
                "not do yet (ROADMAP.md queue 1 item 14): run one GPU "
                "worker, or CPU workers (no gpus_per_worker) whose loops "
                "ask for \"cpu\"")
        import datetime

        import torch.distributed as dist

        if dist.is_initialized():
            return
        dist.init_process_group(
            backend="gloo", init_method=f"tcp://{coordinator}",
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S))

    def on_worker_shutdown(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


class TensorflowBackend(Backend):
    """TF_CONFIG rendezvous for tf.distribute.MultiWorkerMirroredStrategy
    (ref: train/tensorflow/config.py:21,40 _setup_tensorflow_environment):
    the trainer collects EVERY worker's host:port (TF needs the full
    cluster spec, not just a coordinator) and each worker exports
    TF_CONFIG before tensorflow builds its cluster resolver. The user
    loop constructs MultiWorkerMirroredStrategy itself, exactly like the
    reference's TensorflowTrainer loops."""

    needs_coordinator = True
    #: trainer fills worker_addresses (one host:port per rank) before
    #: pickling this backend out to the workers
    needs_worker_addresses = True

    def __init__(self):
        self.worker_addresses = None

    def on_worker_setup(self, rank, world_size, coordinator):
        import json
        import os

        addrs = self.worker_addresses
        if addrs is None:
            if world_size > 1:
                # a one-entry cluster spec with task index >= 1 would
                # make MWMS hang/raise cryptically — fail loudly instead
                raise RuntimeError(
                    "TensorflowBackend.worker_addresses not populated; "
                    "the trainer must gather one host:port per rank "
                    "before worker setup")
            addrs = [coordinator] if coordinator else []
        os.environ["TF_CONFIG"] = json.dumps({
            "cluster": {"worker": addrs},
            "task": {"type": "worker", "index": rank}})

    def on_worker_shutdown(self):
        import os

        os.environ.pop("TF_CONFIG", None)


class TorchBackend(Backend):
    """torch.distributed gloo process group (ref: train/torch/config.py:69
    _setup_torch_process_group), for every gang size: the reference's
    default, kept, so DDP loops migrating from upstream run unchanged;
    pass backend="nccl" for their GPU form."""

    needs_coordinator = True

    def __init__(self, backend: str = "gloo", timeout_s: float = 120.0):
        self.backend = backend
        self.timeout_s = timeout_s

    def on_worker_setup(self, rank, world_size, coordinator):
        import datetime

        import torch.distributed as dist

        if dist.is_initialized():
            return
        dist.init_process_group(
            backend=self.backend,
            init_method=f"tcp://{coordinator}",
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=self.timeout_s))

    def on_worker_shutdown(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def prepare_model(model):
    """Wrap an nn.Module in DDP when a >1-rank group is live
    (ref: ray.train.torch.prepare_model)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across ranks via DistributedSampler, preserving
    the original loader's shuffle semantics and worker/memory options
    (ref: ray.train.torch.prepare_data_loader, which inspects the existing
    sampler to decide shuffling)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return loader
    if loader.batch_size is None:
        raise ValueError(
            "prepare_data_loader supports batch_size-based DataLoaders; "
            "pass your custom batch_sampler a DistributedSampler yourself")
    from torch.utils.data import DataLoader, SequentialSampler
    from torch.utils.data.distributed import DistributedSampler

    shuffle = not isinstance(loader.sampler, SequentialSampler)
    return DataLoader(loader.dataset, batch_size=loader.batch_size,
                      sampler=DistributedSampler(loader.dataset,
                                                 shuffle=shuffle),
                      num_workers=loader.num_workers,
                      pin_memory=loader.pin_memory,
                      collate_fn=loader.collate_fn,
                      drop_last=loader.drop_last,
                      timeout=loader.timeout,
                      worker_init_fn=loader.worker_init_fn)
