"""SklearnTrainer: remote fit, CV fan-out, checkpoint round-trip.

Reference test model: train/tests/test_sklearn_trainer.py.

Port of tests/test_train_sklearn.py, aimed at ray_tpu_torch. Added: a
``ray_tpu_torch.data`` Dataset trains, read through its ``to_pandas``.
"""

import numpy as np
import pytest

from ray_tpu_torch.train import SklearnTrainer
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def _toy(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    return X, y


def test_sklearn_fit_and_checkpoint(ray_start_regular, tmp_path):
    from sklearn.linear_model import LogisticRegression

    from ray_tpu_torch.train import RunConfig

    X, y = _toy()
    t = SklearnTrainer(
        estimator=LogisticRegression(),
        datasets={"train": (X, y), "valid": _toy(seed=1)},
        run_config=RunConfig(storage_path=str(tmp_path), name="sk"))
    res = t.fit()
    assert res.ok
    assert res.metrics["train_score"] > 0.9
    assert res.metrics["valid_score"] > 0.85
    model = SklearnTrainer.get_model(res.checkpoint)
    assert (model.predict(X[:10]) == y[:10]).mean() > 0.7


@pytest.mark.slow
def test_sklearn_cv_parallel(ray_start_regular, tmp_path):
    from sklearn.tree import DecisionTreeClassifier

    from ray_tpu_torch.train import RunConfig

    X, y = _toy(300)
    t = SklearnTrainer(
        estimator=DecisionTreeClassifier(max_depth=3),
        datasets={"train": (X, y)}, cv=4,
        run_config=RunConfig(storage_path=str(tmp_path), name="skcv"))
    res = t.fit()
    assert len(res.metrics["cv_scores"]) == 4
    assert 0.5 < res.metrics["cv_score_mean"] <= 1.0


def test_sklearn_pandas_label_column(ray_start_regular, tmp_path):
    import pandas as pd
    from sklearn.linear_model import LogisticRegression

    from ray_tpu_torch.train import RunConfig

    X, y = _toy()
    df = pd.DataFrame(X, columns=list("abcd"))
    df["label"] = y
    t = SklearnTrainer(
        estimator=LogisticRegression(), datasets={"train": df},
        label_column="label",
        run_config=RunConfig(storage_path=str(tmp_path), name="skpd"))
    res = t.fit()
    assert res.metrics["train_score"] > 0.9


def test_gbdt_trainers_gated():
    from ray_tpu_torch.train import LightGBMTrainer, XGBoostTrainer

    for cls, pkg in [(XGBoostTrainer, "xgboost"),
                     (LightGBMTrainer, "lightgbm")]:
        try:
            __import__(pkg)
        except ImportError:
            with pytest.raises(ImportError, match=pkg):
                cls(estimator=None, datasets={})


def test_sklearn_reads_a_dataset_through_to_pandas(ray_start_regular,
                                                   tmp_path):
    import pandas as pd
    from sklearn.linear_model import LogisticRegression

    from ray_tpu_torch.train import RunConfig

    from ray_tpu_torch import data as rd

    X, y = _toy()
    df = pd.DataFrame(X, columns=list("abcd"))
    df["label"] = y
    ds = rd.from_pandas(df, num_blocks=4)
    assert ds.num_blocks() == 4

    t = SklearnTrainer(
        estimator=LogisticRegression(), datasets={"train": ds},
        label_column="label",
        run_config=RunConfig(storage_path=str(tmp_path), name="skds"))
    res = t.fit()
    assert res.metrics["train_score"] > 0.9
