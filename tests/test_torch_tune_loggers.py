"""Tune logger callbacks on the port (ray_tpu_torch/tune/loggers.py): CSV
/ JSON / TensorBoard artifacts land per trial; gated integrations raise
actionable ImportErrors (ref: python/ray/tune/logger/ +
air/integrations/) — tests/test_tune_loggers.py's cases re-aimed; the
TensorBoard events come from ``torch.utils.tensorboard``."""

import csv
import json
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import RunConfig
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _trainable(config):
    for i in range(3):
        tune.report({"score": config["x"] * (i + 1),
                     "training_iteration": i + 1})


def test_csv_and_json_loggers(cluster, tmp_path):
    grid = tune.Tuner(
        _trainable,
        param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(
            name="logged", storage_path=str(tmp_path),
            callbacks=[tune.CSVLoggerCallback(),
                       tune.JsonLoggerCallback()]),
    ).fit()
    assert len(grid) == 2
    run_dir = tmp_path / "logged"
    trials = sorted(d for d in os.listdir(run_dir)
                    if d.startswith("trial_"))
    assert len(trials) == 2
    # CSV: header + 3 rows, score column numeric
    with open(run_dir / trials[0] / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and "score" in rows[0]
    # JSON: params + 3 result lines
    params = json.loads((run_dir / trials[0] / "params.json").read_text())
    assert params["x"] in (1.0, 2.0)
    lines = (run_dir / trials[0] / "result.json").read_text().splitlines()
    assert len(lines) == 3
    assert json.loads(lines[-1])["training_iteration"] == 3


def test_tensorboard_logger(cluster, tmp_path):
    grid = tune.Tuner(
        _trainable,
        param_space={"x": tune.grid_search([3.0])},
        run_config=RunConfig(
            name="tb", storage_path=str(tmp_path),
            callbacks=[tune.TBXLoggerCallback()]),
    ).fit()
    assert len(grid) == 1
    trial_dir = tmp_path / "tb" / "trial_00000"
    events = [f for f in os.listdir(trial_dir)
              if "tfevents" in f]
    assert events, os.listdir(trial_dir)
    assert os.path.getsize(trial_dir / events[0]) > 0


def test_gated_integrations_raise():
    with pytest.raises(ImportError, match="mlflow"):
        tune.MLflowLoggerCallback()
    with pytest.raises(ImportError, match="wandb"):
        tune.WandbLoggerCallback()
