"""TorchTrainer: reference-parity torch backend over the WorkerGroup.

Reference test model: python/ray/train/tests/test_torch_trainer.py — a
small DDP loop trains, ranks see a live process group, reports flow back,
and prepare_model syncs replicas.

Port of tests/test_train_torch.py, aimed at ray_tpu_torch. Added: the
port's FunctionPredictor (the JAX package's JaxPredictor) from a DCP
checkpoint of a GPT-2 param tree, and BatchPredictor over a
``ray_tpu_torch.data`` Dataset.
"""

import numpy as np
import pytest

import ray_tpu_torch
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _torch_loop(config):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import prepare_model, session

    assert dist.is_initialized()
    rank = session.world_rank()
    ws = session.world_size()
    assert dist.get_rank() == rank and dist.get_world_size() == ws

    torch.manual_seed(0)  # same init on every rank
    model = prepare_model(torch.nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    g = torch.Generator().manual_seed(1234 + rank)  # per-rank data shard
    x = torch.randn(64, 4, generator=g)
    w_true = torch.tensor([[1.0], [-2.0], [0.5], [0.0]])
    y = x @ w_true

    for step in range(config["steps"]):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()  # DDP allreduces grads here
        opt.step()
        session.report({"loss": float(loss), "step": step, "rank": rank})

    # replicas must agree bit-for-bit after DDP steps
    w = [p.detach().clone() for p in model.parameters()]
    gathered = [[torch.zeros_like(t) for _ in range(ws)] for t in w]
    for t, out in zip(w, gathered):
        dist.all_gather(out, t)
    for out in gathered:
        for other in out[1:]:
            assert torch.equal(out[0], other)
    return float(loss)


@pytest.mark.slow
def test_torch_trainer_ddp(cluster, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    res = TorchTrainer(
        _torch_loop, train_loop_config={"steps": 20},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(storage_path=str(tmp_path), name="torch_ddp"),
    ).fit()
    assert res.ok, res.error
    assert res.metrics["step"] == 19
    losses = [m["loss"] for m in res.metrics_history if m["rank"] == 0]
    assert losses[-1] < 0.1 * losses[0]


def test_torch_trainer_single_worker(cluster, tmp_path):
    """world_size=1 still gets a process group (uniform user code)."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    res = TorchTrainer(
        _torch_loop, train_loop_config={"steps": 4},
        scaling_config=ScalingConfig(num_workers=1,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(storage_path=str(tmp_path), name="torch_1w"),
    ).fit()
    assert res.ok, res.error


def test_prepare_data_loader_shards(cluster, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        import torch
        from torch.utils.data import DataLoader, TensorDataset

        from ray_tpu_torch.train import prepare_data_loader, session

        ds = TensorDataset(torch.arange(32).float()[:, None])
        dl = prepare_data_loader(DataLoader(ds, batch_size=4))
        seen = sum(b[0].numel() for b in dl)
        # asserted on EVERY rank (reports only surface from rank 0):
        # DistributedSampler gives each of the 2 ranks half the 32 rows
        assert seen == 16, seen
        # an unshuffled loader must stay in order within the rank's shard
        first = next(iter(prepare_data_loader(
            DataLoader(ds, batch_size=4))))[0][:, 0]
        assert torch.equal(first, torch.sort(first).values)
        session.report({"seen": seen, "rank": session.world_rank()})

    res = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2,
                                           resources_per_worker={"CPU": 1}),
        run_config=RunConfig(storage_path=str(tmp_path), name="torch_dl"),
    ).fit()
    assert res.ok, res.error
    # DistributedSampler gives each of the 2 ranks half the 32 rows
    assert all(m["seen"] == 16 for m in res.metrics_history)


def test_torch_predictor_roundtrip(tmp_path):
    """TorchPredictor.from_checkpoint restores a state_dict and predicts
    (ref: train/torch/torch_predictor.py)."""
    import numpy as np
    import torch

    from ray_tpu_torch.train import Checkpoint, TorchPredictor

    model = torch.nn.Linear(3, 2)
    ckpt_dir = str(tmp_path / "ck")
    Checkpoint.from_state(
        {"model": {k: v.numpy() for k, v in model.state_dict().items()}},
        ckpt_dir)
    pred = TorchPredictor.from_checkpoint(
        Checkpoint(ckpt_dir), model=torch.nn.Linear(3, 2))
    x = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    out = pred.predict({"features": x})
    assert out["predictions"].shape == (8, 2)
    ref = model(torch.as_tensor(x)).detach().numpy()
    assert np.allclose(out["predictions"], ref, atol=1e-6)


def test_function_predictor_from_checkpoint(tmp_path):
    """FunctionPredictor.from_checkpoint restores a param tree saved with
    DCP (under "params") onto the device asked for (the CPU here; None
    means CUDA) and predicts apply_fn(params, features) without
    gradients, on the params' device: the tiny GPT-2's logits equal a
    direct forward."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import Checkpoint, FunctionPredictor

    cfg = gpt2.PRESETS["tiny"].replace(dtype=torch.float32)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg)
    ck = Checkpoint.from_state({"params": params, "step": 3},
                               str(tmp_path / "ck"))
    pred = FunctionPredictor.from_checkpoint(
        ck, apply_fn=lambda p, x: gpt2.forward(p, x, cfg), device="cpu")
    assert pred.device == torch.device("cpu")
    x = np.random.default_rng(0).integers(0, 256, size=(2, 9))
    out = pred.predict({"features": x})
    assert out["predictions"].shape == (2, 9, 256)
    ref = gpt2.forward(params, torch.as_tensor(x), cfg).numpy()
    np.testing.assert_array_equal(out["predictions"], ref)
    np.testing.assert_array_equal(out["features"], x)


def test_batch_predictor_waits_for_the_data_layer(cluster, tmp_path):
    """The data layer has come: predict maps the predictor over the
    Dataset's blocks in two actors and keeps their order."""
    import torch

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import (BatchPredictor, Checkpoint,
                                     FunctionPredictor)

    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ckpt = Checkpoint.from_state({"w": w}, str(tmp_path / "ck"))
    x = np.random.default_rng(3).standard_normal((10, 3)).astype(np.float32)
    ds = rd.from_numpy({"features": x}, num_blocks=4)
    out = BatchPredictor(ckpt, FunctionPredictor, device="cpu",
                         apply_fn=lambda p, f: f @ p["w"]).predict(
        ds, num_replicas=2)
    assert out.num_blocks() == 4
    got = np.concatenate([b["predictions"] for b in out.iter_batches(
        batch_size=3)])
    np.testing.assert_array_equal(got, (torch.as_tensor(x) @ w).numpy())
