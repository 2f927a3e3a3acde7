"""SklearnTrainer + gated GBDT trainers.

Reference: python/ray/train/sklearn/sklearn_trainer.py (fit an estimator
in a remote actor with optional cross-validation, parallelized via
joblib) and gbdt_trainer.py (XGBoostTrainer/LightGBMTrainer over
xgboost_ray/lightgbm_ray). CPU-estimator training is a single remote
actor here — the card adds nothing to sklearn fits, but the orchestration
surface (fit off-driver, CV fan-out over the cluster, checkpoint to the
run dir) matches the reference. Where xgboost/lightgbm are not installed,
their trainers keep the reference API and raise an actionable ImportError
at construction.

A copy of ``ray_tpu/train/sklearn.py`` over the port's trainer and
``ray_tpu_torch.data``; sklearn is imported only in the fitting actor, so
``import ray_tpu_torch.train`` works where it is absent.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.trainer import Result

MODEL_FILE = "model.pkl"


@ray_tpu_torch.remote
def _fit_estimator(est_blob: bytes, X, y, fit_params: dict):
    import cloudpickle

    est = cloudpickle.loads(est_blob)
    t0 = time.time()
    est.fit(X, y, **(fit_params or {}))
    out: Dict[str, Any] = {"fit_time": time.time() - t0}
    if hasattr(est, "score"):
        out["train_score"] = float(est.score(X, y))
    return pickle.dumps(est), out


@ray_tpu_torch.remote
def _cv_fold(est_blob: bytes, X, y, train_idx, test_idx, fit_params: dict):
    import cloudpickle

    est = cloudpickle.loads(est_blob)
    est.fit(X[train_idx], y[train_idx], **(fit_params or {}))
    return float(est.score(X[test_idx], y[test_idx]))


class SklearnTrainer:
    """ref: sklearn_trainer.py — estimator + datasets in, fitted model +
    metrics + checkpoint out; cv folds fan out as remote tasks (the
    reference parallelizes CV through joblib-on-ray; here each fold IS a
    task)."""

    def __init__(self, *, estimator: Any,
                 datasets: Dict[str, Any],
                 label_column: str = None,
                 cv: Optional[int] = None,
                 fit_params: Optional[dict] = None,
                 run_config: Optional[RunConfig] = None):
        self.estimator = estimator
        self.datasets = datasets
        self.label_column = label_column
        self.cv = cv
        self.fit_params = fit_params or {}
        self.run_config = run_config or RunConfig()

    def _xy(self, ds):
        """Accept a ray_tpu_torch.data.Dataset, a pandas frame, or (X, y)."""
        from ray_tpu_torch.data.dataset import Dataset

        if isinstance(ds, tuple):
            return np.asarray(ds[0]), np.asarray(ds[1])
        if isinstance(ds, Dataset):
            ds = ds.to_pandas()
        if self.label_column is None:
            raise ValueError("label_column is required for tabular input")
        y = ds[self.label_column].to_numpy()
        X = ds.drop(columns=[self.label_column]).to_numpy()
        return X, y

    def fit(self) -> Result:
        import cloudpickle

        X, y = self._xy(self.datasets["train"])
        blob = cloudpickle.dumps(self.estimator)

        model_blob, metrics = ray_tpu_torch.get(
            _fit_estimator.remote(blob, X, y, self.fit_params))

        if self.cv:
            from sklearn.model_selection import KFold

            folds = KFold(n_splits=self.cv, shuffle=True, random_state=0)
            refs = [_cv_fold.remote(blob, X, y, tr, te, self.fit_params)
                    for tr, te in folds.split(X)]
            scores = ray_tpu_torch.get(refs)
            metrics["cv_scores"] = scores
            metrics["cv_score_mean"] = float(np.mean(scores))
            metrics["cv_score_std"] = float(np.std(scores))

        if "valid" in self.datasets:
            est = pickle.loads(model_blob)
            Xv, yv = self._xy(self.datasets["valid"])
            metrics["valid_score"] = float(est.score(Xv, yv))

        base = self.run_config.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
        run_dir = os.path.join(
            base, self.run_config.name or f"sklearn_{int(time.time())}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, MODEL_FILE), "wb") as f:
            f.write(model_blob)
        ckpt = Checkpoint.from_directory(run_dir)
        return Result(metrics=metrics, metrics_history=[metrics],
                      checkpoint=ckpt)

    @staticmethod
    def get_model(checkpoint: Checkpoint):
        """Unpickle the fitted estimator from a fit() checkpoint
        (ref: sklearn_trainer.py get_model)."""
        with open(os.path.join(checkpoint.to_directory(), MODEL_FILE),
                  "rb") as f:
            return pickle.load(f)


class _MissingGBDTTrainer:
    _pkg = ""

    def __init__(self, *a, **kw):
        raise ImportError(
            f"{type(self).__name__} needs the '{self._pkg}' package, which "
            "is not installed (do not pip install; bake it into the image). "
            "The reference equivalent is train/gbdt_trainer.py.")


class XGBoostTrainer(_MissingGBDTTrainer):
    """ref: train/xgboost/xgboost_trainer.py — surface kept, gated on the
    xgboost package."""
    _pkg = "xgboost"


class LightGBMTrainer(_MissingGBDTTrainer):
    """ref: train/lightgbm/lightgbm_trainer.py — surface kept, gated on
    the lightgbm package."""
    _pkg = "lightgbm"


try:  # pragma: no cover - image has no xgboost today
    import xgboost as _xgb  # noqa: F401

    class XGBoostTrainer(SklearnTrainer):  # type: ignore[no-redef]
        """xgboost.XGBModel is sklearn-compatible; the SklearnTrainer
        orchestration (remote fit, CV fan-out, checkpoint) applies."""
except ImportError:
    pass

try:  # pragma: no cover
    import lightgbm as _lgb  # noqa: F401

    class LightGBMTrainer(SklearnTrainer):  # type: ignore[no-redef]
        pass
except ImportError:
    pass
