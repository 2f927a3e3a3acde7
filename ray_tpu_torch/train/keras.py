"""Keras session callback.

Reference: python/ray/air/integrations/keras.py — ReportCheckpointCallback:
a tf.keras Callback that forwards epoch/batch logs (and optionally a
checkpoint) through the train session so Keras loops running inside a
WorkerGroup report like any other trainer.

A copy of ``ray_tpu/train/keras.py`` over the port's trainer; tensorflow is
imported only when the callback is built, so ``import ray_tpu_torch.train``
works where it is absent.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


def ReportCheckpointCallback(*, metrics: Optional[List[str]] = None,
                             report_on: str = "epoch_end",
                             checkpoint_dir: Optional[str] = None):
    """Build the callback (factory, so importing this module never pulls
    tensorflow; ref: keras.py ReportCheckpointCallback).

    metrics: subset of Keras logs to report (None = all scalars).
    report_on: "epoch_end" (default) or "batch_end".
    checkpoint_dir: when set, saves model weights per epoch and reports
    the path alongside the metrics (the session persists it)."""
    from tensorflow import keras

    class _Report(keras.callbacks.Callback):
        def _report(self, logs: Optional[Dict]):
            from ray_tpu_torch.train import session

            logs = logs or {}
            picked = {k: float(v) for k, v in logs.items()
                      if (metrics is None or k in metrics)
                      and isinstance(v, (int, float))}
            if not picked:
                return
            ckpt = None
            if checkpoint_dir and report_on == "epoch_end":
                os.makedirs(checkpoint_dir, exist_ok=True)
                path = os.path.join(checkpoint_dir, "model.weights.h5")
                try:
                    self.model.save_weights(path)
                    ckpt = path
                except Exception:
                    pass
            if ckpt:
                picked["_keras_weights"] = ckpt
            session.report(picked)

        def on_epoch_end(self, epoch, logs=None):
            if report_on == "epoch_end":
                self._report({"epoch": epoch, **(logs or {})})

        def on_train_batch_end(self, batch, logs=None):
            if report_on == "batch_end":
                self._report({"batch": batch, **(logs or {})})

    return _Report()


__all__ = ["ReportCheckpointCallback"]
