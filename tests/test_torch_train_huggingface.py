"""TransformersTrainer + AccelerateTrainer over the gloo WorkerGroup
(ref: python/ray/train/huggingface/ transformers_trainer.py,
accelerate/accelerate_trainer.py; reference tests
train/tests/test_transformers_trainer.py pattern — tiny model, few
steps, metrics surface through the session).

Port of tests/test_train_huggingface.py, aimed at ray_tpu_torch."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.train import RunConfig, ScalingConfig
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _tiny_rows(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 50, 12).tolist(),
             "attention_mask": [1] * 12,
             "labels": int(rng.integers(0, 2))} for _ in range(n)]


def _init_hf_trainer(train_shard, eval_shard, **config):
    import tempfile

    import torch
    from transformers import (BertConfig, BertForSequenceClassification,
                              Trainer, TrainingArguments)

    model = BertForSequenceClassification(BertConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=16, num_labels=2))

    rows = _tiny_rows()

    def collate(batch):
        return {k: torch.as_tensor([r[k] for r in batch])
                for k in batch[0]}

    args = TrainingArguments(
        output_dir=tempfile.mkdtemp(), max_steps=config["max_steps"],
        per_device_train_batch_size=8, logging_steps=2, report_to=[],
        use_cpu=True, save_strategy="no", disable_tqdm=True)
    return Trainer(model=model, args=args, train_dataset=rows,
                   data_collator=collate)


@pytest.mark.slow
def test_transformers_trainer_single_worker(cluster):
    from ray_tpu_torch.train import TransformersTrainer

    t = TransformersTrainer(
        _init_hf_trainer, trainer_init_config={"max_steps": 6},
        scaling_config=ScalingConfig(num_workers=1,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="hf_single"))
    res = t.fit()
    assert res.ok, res.error
    # HF logs flowed through the session: loss and train summary present
    assert any("loss" in m for m in res.metrics_history), \
        res.metrics_history
    assert any("train_runtime" in m for m in res.metrics_history)


@pytest.mark.slow
def test_transformers_trainer_ddp_two_workers(cluster):
    from ray_tpu_torch.train import TransformersTrainer

    t = TransformersTrainer(
        _init_hf_trainer, trainer_init_config={"max_steps": 4},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="hf_ddp"))
    res = t.fit()
    assert res.ok, res.error
    assert any("loss" in m for m in res.metrics_history)


def _accelerate_loop(config):
    import torch
    from accelerate import Accelerator
    from torch.utils.data import DataLoader, TensorDataset

    from ray_tpu_torch.train import session

    acc = Accelerator()
    torch.manual_seed(0)
    x = torch.randn(64, 4)
    y = (x.sum(-1) > 0).long()
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loader = DataLoader(TensorDataset(x, y), batch_size=8)
    model, opt, loader = acc.prepare(model, opt, loader)
    for step, (xb, yb) in enumerate(loader):
        loss = torch.nn.functional.cross_entropy(model(xb), yb)
        acc.backward(loss)
        opt.step()
        opt.zero_grad()
    session.report({"loss": float(loss.detach()),
                    "world": acc.num_processes,
                    "rank": acc.process_index})


@pytest.mark.slow
def test_accelerate_trainer_two_workers(cluster):
    from ray_tpu_torch.train import AccelerateTrainer

    t = AccelerateTrainer(
        _accelerate_loop,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="accel"))
    res = t.fit()
    assert res.ok, res.error
    # the Accelerator adopted the 2-rank gloo group (not single-process)
    assert res.metrics["world"] == 2
    assert np.isfinite(res.metrics["loss"])
