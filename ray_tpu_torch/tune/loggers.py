"""Tune logger callbacks: CSV, JSON-lines, TensorBoard + gated
integrations.

Port of ``ray_tpu/tune/loggers.py`` (reference: python/ray/tune/logger/ (logger.py LoggerCallback base,
csv.py CSVLoggerCallback, json.py JsonLoggerCallback, tensorboardx.py
TBXLoggerCallback) and python/ray/air/integrations/{mlflow,wandb}.py.
Callbacks ride RunConfig.callbacks and receive every trial report from
the Tuner controller loop (tuner.py), writing per-trial artifacts under
<run_dir>/<trial_id>/ exactly where the experiment state lives. The
TensorBoard callback writes through ``torch.utils.tensorboard`` (the
reference's through ``tf.summary``: the same event-file format); it and
the MLflow/W&B integrations import their packages only when made.)
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


def _scalars(result: Dict[str, Any]) -> Dict[str, float]:
    return {k: v for k, v in result.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


class LoggerCallback:
    """Hook surface (ref: tune/logger/logger.py LoggerCallback +
    tune/callback.py Callback — merged; the split there is historical)."""

    def setup(self, run_dir: str) -> None:
        pass

    def on_trial_start(self, trial_id: str, config: Dict[str, Any]) -> None:
        pass

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: Any) -> None:
        pass

    def on_experiment_end(self, results: List[Any]) -> None:
        pass


class _PerTrialDirCallback(LoggerCallback):
    def setup(self, run_dir: str) -> None:
        self.run_dir = run_dir

    def _trial_dir(self, trial_id: str) -> str:
        d = os.path.join(self.run_dir, trial_id)
        os.makedirs(d, exist_ok=True)
        return d


class CSVLoggerCallback(_PerTrialDirCallback):
    """progress.csv per trial (ref: tune/logger/csv.py). The header is
    fixed by the FIRST result's scalar keys; later extra keys are
    dropped, missing ones left blank — same behavior as the reference."""

    def setup(self, run_dir: str) -> None:
        super().setup(run_dir)
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        row = _scalars(result)
        if trial_id not in self._writers:
            f = open(os.path.join(self._trial_dir(trial_id),
                                  "progress.csv"), "w", newline="")
            w = csv.DictWriter(f, fieldnames=list(row.keys()),
                               extrasaction="ignore")
            w.writeheader()
            self._files[trial_id], self._writers[trial_id] = f, w
        self._writers[trial_id].writerow(row)
        self._files[trial_id].flush()

    def on_trial_complete(self, trial_id: str, result: Any):
        f = self._files.pop(trial_id, None)
        if f:
            f.close()
        self._writers.pop(trial_id, None)

    def on_experiment_end(self, results: List[Any]):
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._writers.clear()


class JsonLoggerCallback(_PerTrialDirCallback):
    """result.json (one JSON per line) + params.json per trial
    (ref: tune/logger/json.py)."""

    def on_trial_start(self, trial_id: str, config: Dict[str, Any]):
        with open(os.path.join(self._trial_dir(trial_id),
                               "params.json"), "w") as f:
            json.dump(config, f, default=str)

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        with open(os.path.join(self._trial_dir(trial_id),
                               "result.json"), "a") as f:
            f.write(json.dumps(result, default=str) + "\n")


class TBXLoggerCallback(_PerTrialDirCallback):
    """TensorBoard scalars per trial through
    ``torch.utils.tensorboard.SummaryWriter`` (ref:
    tune/logger/tensorboardx.py — tensorboardX there; the event-file
    format is the same). Needs the ``tensorboard`` package."""

    def setup(self, run_dir: str) -> None:
        super().setup(run_dir)
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "TBXLoggerCallback needs the tensorboard package (for "
                "torch.utils.tensorboard); install it in your driver "
                "environment") from e
        self._writers: Dict[str, Any] = {}

    def _writer(self, trial_id: str):
        from torch.utils.tensorboard import SummaryWriter

        if trial_id not in self._writers:
            self._writers[trial_id] = SummaryWriter(
                log_dir=self._trial_dir(trial_id))
        return self._writers[trial_id]

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        step = int(result.get("training_iteration",
                              result.get("step", 0)) or 0)
        w = self._writer(trial_id)
        for k, v in _scalars(result).items():
            w.add_scalar(f"ray/tune/{k}", v, global_step=step)
        w.flush()

    def on_trial_complete(self, trial_id: str, result: Any):
        w = self._writers.pop(trial_id, None)
        if w is not None:
            w.close()

    def on_experiment_end(self, results: List[Any]):
        for w in self._writers.values():
            w.close()
        self._writers.clear()


class MLflowLoggerCallback(LoggerCallback):
    """ref: air/integrations/mlflow.py — one MLflow run per trial.
    Gated: mlflow is an optional package."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: str = "ray_tpu_torch"):
        try:
            import mlflow  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "MLflowLoggerCallback needs the mlflow package; install "
                "it in your driver environment (it is not installed)") from e
        self.tracking_uri = tracking_uri
        self.experiment_name = experiment_name
        self._runs: Dict[str, Any] = {}

    def setup(self, run_dir: str) -> None:
        import mlflow

        if self.tracking_uri:
            mlflow.set_tracking_uri(self.tracking_uri)
        mlflow.set_experiment(self.experiment_name)

    def on_trial_start(self, trial_id: str, config: Dict[str, Any]):
        import mlflow

        run = mlflow.start_run(run_name=trial_id, nested=True)
        self._runs[trial_id] = run
        mlflow.log_params({k: str(v) for k, v in config.items()},
                          run_id=run.info.run_id)

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        import mlflow

        run = self._runs.get(trial_id)
        if run:
            mlflow.log_metrics(_scalars(result),
                               step=int(result.get("training_iteration",
                                                   0) or 0),
                               run_id=run.info.run_id)

    def on_trial_complete(self, trial_id: str, result: Any):
        import mlflow

        run = self._runs.pop(trial_id, None)
        if run:
            mlflow.end_run()


class WandbLoggerCallback(LoggerCallback):
    """ref: air/integrations/wandb.py — one W&B run per trial.
    Gated: wandb is an optional package."""

    def __init__(self, project: str = "ray_tpu_torch", **init_kwargs):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbLoggerCallback needs the wandb package; install it "
                "in your driver environment (it is not installed)") from e
        self.project = project
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def on_trial_start(self, trial_id: str, config: Dict[str, Any]):
        import wandb

        self._runs[trial_id] = wandb.init(
            project=self.project, name=trial_id, config=config,
            reinit=True, **self.init_kwargs)

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        run = self._runs.get(trial_id)
        if run:
            run.log(_scalars(result))

    def on_trial_complete(self, trial_id: str, result: Any):
        run = self._runs.pop(trial_id, None)
        if run:
            run.finish()


__all__ = ["LoggerCallback", "CSVLoggerCallback", "JsonLoggerCallback",
           "TBXLoggerCallback", "MLflowLoggerCallback",
           "WandbLoggerCallback"]
