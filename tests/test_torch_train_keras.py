"""Keras ReportCheckpointCallback inside a DataParallelTrainer worker
group (ref: air/integrations/keras.py + its test pattern: tiny model, logs
flow to the session).

Port of tests/test_train_keras.py, aimed at ray_tpu_torch (JaxTrainer is
DataParallelTrainer)."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.train import RunConfig, ScalingConfig
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def _keras_loop(config):
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import numpy as np
    from tensorflow import keras

    from ray_tpu_torch.train.keras import ReportCheckpointCallback

    x = np.random.default_rng(0).normal(size=(64, 4)).astype("float32")
    y = (x.sum(-1) > 0).astype("int32")
    model = keras.Sequential([keras.layers.Dense(8, activation="relu"),
                              keras.layers.Dense(2)])
    model.compile(optimizer="adam",
                  loss=keras.losses.SparseCategoricalCrossentropy(
                      from_logits=True),
                  metrics=["accuracy"])
    model.fit(x, y, epochs=config["epochs"], batch_size=16, verbose=0,
              callbacks=[ReportCheckpointCallback()])


@pytest.mark.slow
def test_keras_callback_reports(cluster):
    from ray_tpu_torch.train import DataParallelTrainer

    t = DataParallelTrainer(_keras_loop, train_loop_config={"epochs": 3},
                   scaling_config=ScalingConfig(
                       num_workers=1, resources_per_worker={"CPU": 1}),
                   run_config=RunConfig(name="keras_cb"))
    res = t.fit()
    assert res.ok, res.error
    epochs = [m for m in res.metrics_history if "epoch" in m]
    assert len(epochs) == 3
    assert all("loss" in m and np.isfinite(m["loss"]) for m in epochs)
    assert epochs[-1]["epoch"] == 2
