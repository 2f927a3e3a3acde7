"""HuggingFace integration trainers: Transformers + Accelerate.

Reference: python/ray/train/huggingface/ —
TransformersTrainer (transformers_trainer.py: a DataParallelTrainer whose
`trainer_init_per_worker` builds a transformers.Trainer on every rank;
torch.distributed is already up, so HF's own DDP engages) and
AccelerateTrainer (accelerate/accelerate_trainer.py:89: the user loop
constructs `accelerate.Accelerator()` which adopts the live process
group — DeepSpeed/FSDP configs pass through the same way).

A copy of ``ray_tpu/train/huggingface.py`` over the port's trainer: like
TorchTrainer these run on a gloo process group (the CPU), so reference
users' HF loops run unchanged. transformers and accelerate are imported
only where a loop uses them, so ``import ray_tpu_torch.train`` works
where they are absent.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.backend import TorchBackend
from ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer


def shard_to_list(iterator) -> list:
    """Materialize a DataIterator shard into a list of dict rows — a
    valid torch-style dataset (len + indexing) for transformers.Trainer
    (ref: transformers_trainer.py converts ray.data shards to HF
    datasets; list-of-dicts is the minimal equivalent)."""
    rows = []
    for batch in iterator.iter_batches(batch_size=256):
        if isinstance(batch, dict):
            keys = list(batch.keys())
            n = len(batch[keys[0]])
            rows.extend({k: batch[k][i] for k in keys} for i in range(n))
        else:
            rows.extend(batch)
    return rows


class _ReportCallback:
    """transformers.TrainerCallback reporting HF logs through the train
    session (ref: transformers_trainer.py RayTrainReportCallback).
    Duck-typed: Trainer only calls the hooks it finds."""

    def on_log(self, args, state, control, logs=None, **kwargs):
        from ray_tpu_torch.train import session

        if state.is_world_process_zero and logs:
            session.report({"step": state.global_step,
                            **{k: v for k, v in logs.items()
                               if isinstance(v, (int, float))}})


class TransformersTrainer(TorchTrainer):
    """ref: train/huggingface/transformers_trainer.py —
    `trainer_init_per_worker(train_shard, eval_shard, **config)` returns
    a transformers.Trainer; every rank builds one and .train()s inside
    the live gloo group, so HF's accelerate-backed engine does the DDP."""

    def __init__(self, trainer_init_per_worker: Callable,
                 *, trainer_init_config: Optional[dict] = None,
                 **kwargs):
        init_fn = trainer_init_per_worker

        def loop(config):
            import transformers  # noqa: F401  (fail fast if absent)

            from ray_tpu_torch.train import session

            train_shard = eval_shard = None
            try:
                train_shard = session.get_dataset_shard("train")
            except Exception:
                pass
            try:
                eval_shard = session.get_dataset_shard("evaluation")
            except Exception:
                pass
            trainer = init_fn(train_shard, eval_shard, **config)
            cb = _ReportCallback()
            try:
                from transformers import TrainerCallback

                # real subclass keeps newer transformers' isinstance
                # checks happy
                cb = type("_RayReport", (TrainerCallback,),
                          {"on_log": _ReportCallback.on_log})()
            except Exception:
                pass
            trainer.add_callback(cb)
            result = trainer.train()
            if result is not None and getattr(result, "metrics", None):
                session.report({k: v for k, v in result.metrics.items()
                                if isinstance(v, (int, float))})

        super().__init__(loop, train_loop_config=trainer_init_config or {},
                         **kwargs)


class AccelerateBackend(TorchBackend):
    """TorchBackend + the env contract `accelerate.Accelerator()` reads
    (RANK/WORLD_SIZE/MASTER_*, CPU mode) so the user loop's Accelerator
    adopts the group instead of believing it is single-process
    (ref: accelerate_trainer.py's env plumbing)."""

    def on_worker_setup(self, rank, world_size, coordinator):
        host, port = coordinator.rsplit(":", 1)
        os.environ.update({
            "RANK": str(rank), "WORLD_SIZE": str(world_size),
            "LOCAL_RANK": "0", "MASTER_ADDR": host, "MASTER_PORT": port,
            "ACCELERATE_USE_CPU": "true",
        })
        super().on_worker_setup(rank, world_size, coordinator)


class AccelerateTrainer(DataParallelTrainer):
    """ref: train/huggingface/accelerate/accelerate_trainer.py:89 — the
    user's train_loop_per_worker builds `accelerate.Accelerator()` and
    prepares model/optimizer/dataloaders; the backend guarantees the
    distributed env is visible before the loop starts."""

    backend_cls = AccelerateBackend
