"""ray_tpu_torch.train: distributed training on NVIDIA GPUs.

Port of ``ray_tpu/train`` over the port's runtime (reference:
python/ray/train/ — BaseTrainer.fit (base_trainer.py:570),
DataParallelTrainer (data_parallel_trainer.py:58), BackendExecutor
(backend_executor.py:45), WorkerGroup (worker_group.py:100), _TrainSession
(session.py:84)). The architecture carries over — trainer → placement
group → worker-group of actors → per-worker session. The default backend
(``ProcessGroupBackend``) makes a gang of CPU workers one gloo group (a
gang of GPU workers waits for a card pinned to each, ROADMAP.md queue 1
item 14); checkpoints go through ``torch.distributed.checkpoint``;
DP/FSDP/TP arrive via ``ray_tpu_torch.parallel`` sharding presets, not
separate trainer classes.

Three of the JAX package's names said JAX and are renamed:
``JaxTrainer`` is ``DataParallelTrainer`` (upstream's name),
``JaxBackend`` is ``ProcessGroupBackend`` and ``JaxPredictor`` is
``FunctionPredictor``; ``ScalingConfig``'s ``use_tpu``/``chips_per_worker``
are ``use_gpu``/``gpus_per_worker``.

    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig, session)

    def train_loop(config):
        device = session.get_device()          # cuda unless asked for cpu
        ...
        session.report({"loss": ...}, state=...)

    result = DataParallelTrainer(
        train_loop, scaling_config=ScalingConfig(
            num_workers=1, use_gpu=True, gpus_per_worker=1)).fit()
"""

from ray_tpu_torch.train.backend import (Backend, ProcessGroupBackend,
                                         TensorflowBackend, TorchBackend,
                                         prepare_data_loader, prepare_model)
from ray_tpu_torch.train.config import (CheckpointConfig, ElasticConfig,
                                        FailureConfig, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.trainer import (DataParallelTrainer, Result,
                                         TensorflowTrainer, TorchTrainer)
from ray_tpu_torch.train.predictor import (BatchPredictor, FunctionPredictor,
                                           Predictor, TorchPredictor,
                                           TransformersPredictor)
from ray_tpu_torch.train.huggingface import (AccelerateBackend,
                                             AccelerateTrainer,
                                             TransformersTrainer,
                                             shard_to_list)
from ray_tpu_torch.train.sklearn import (LightGBMTrainer, SklearnTrainer,
                                         XGBoostTrainer)
from ray_tpu_torch.train import session

__all__ = [
    "DataParallelTrainer", "TorchTrainer", "TensorflowTrainer", "Result",
    "ScalingConfig", "RunConfig", "ElasticConfig",
    "FailureConfig", "CheckpointConfig", "Checkpoint", "session",
    "Predictor", "FunctionPredictor", "BatchPredictor", "TorchPredictor",
    "TransformersPredictor",
    "Backend", "ProcessGroupBackend", "TensorflowBackend", "TorchBackend",
    "prepare_model", "prepare_data_loader",
    "SklearnTrainer", "XGBoostTrainer", "LightGBMTrainer",
    "TransformersTrainer", "AccelerateTrainer", "AccelerateBackend",
    "shard_to_list",
]
