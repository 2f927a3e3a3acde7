"""Round-2b preprocessor additions (ref: python/ray/data/preprocessors/
batch_mapper, normalizer, scaler (MaxAbs/Robust), transformer,
discretizer, encoder (Ordinal/MultiHot), hasher, tokenizer,
vectorizer).

Port of tests/test_data_preprocessors2.py, aimed at ray_tpu_torch."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data
from ray_tpu_torch.data.preprocessors import (BatchMapper, CountVectorizer,
                                              CustomKBinsDiscretizer,
                                              FeatureHasher, MaxAbsScaler,
                                              MultiHotEncoder, Normalizer,
                                              OrdinalEncoder, PowerTransformer,
                                              RobustScaler, Tokenizer,
                                              UniformKBinsDiscretizer)
from torch_runtime_support import (  # noqa: F401
    reap_orphans)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def _num_ds(vals, col="x"):
    return data.from_items([{col: float(v)} for v in vals], num_blocks=2)


def test_batch_mapper(cluster):
    ds = _num_ds(range(10))
    out = BatchMapper(lambda b: {"x": np.asarray(b["x"]) * 2}) \
        .transform(ds).take_all()
    assert out[3]["x"] == 6.0


def test_normalizer_l2(cluster):
    ds = data.from_items([{"a": 3.0, "b": 4.0}] * 4)
    out = Normalizer(["a", "b"]).transform(ds).take_all()
    assert np.isclose(out[0]["a"], 0.6) and np.isclose(out[0]["b"], 0.8)
    with pytest.raises(ValueError):
        Normalizer(["a"], norm="l3")


def test_maxabs_and_robust_scalers(cluster):
    ds = _num_ds([-4, -2, 0, 2, 8])
    out = MaxAbsScaler(["x"]).fit_transform(ds).take_all()
    assert np.isclose(max(abs(r["x"]) for r in out), 1.0)

    # median([-4,-2,0,2,8]) = 0, IQR = 2 - (-2) = 4 -> exact outputs
    out2 = RobustScaler(["x"]).fit_transform(ds).take_all()
    assert np.allclose(sorted(r["x"] for r in out2),
                       [-1.0, -0.5, 0.0, 0.5, 2.0])


def test_power_transformer(cluster):
    ds = _num_ds([0.0, 1.0, 3.0])
    out = PowerTransformer(["x"], power=0.0).fit_transform(ds).take_all()
    got = sorted(r["x"] for r in out)
    assert np.allclose(got, np.log1p([0.0, 1.0, 3.0]))
    # box-cox lambda=1 is identity-shift
    out2 = PowerTransformer(["x"], power=1.0, method="box-cox") \
        .transform(_num_ds([1.0, 2.0])).take_all()
    assert sorted(r["x"] for r in out2) == [0.0, 1.0]


def test_discretizers(cluster):
    ds = _num_ds([0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
    out = UniformKBinsDiscretizer(["x"], bins=3).fit_transform(ds) \
        .take_all()
    bins = sorted(set(r["x"] for r in out))
    assert bins == [0, 1, 2]
    out2 = CustomKBinsDiscretizer(["x"], bins=[0, 5, 10]) \
        .transform(ds).take_all()
    assert set(r["x"] for r in out2) == {0, 1}


def test_ordinal_and_multihot_encoders(cluster):
    ds = data.from_items([{"c": v} for v in ("b", "a", "c", "a")])
    out = OrdinalEncoder(["c"]).fit_transform(ds).take_all()
    assert [r["c"] for r in out] == [1, 0, 2, 0]

    ds2 = data.from_items([{"tags": ["x", "y"]}, {"tags": ["y"]},
                           {"tags": []}])
    enc = MultiHotEncoder(["tags"]).fit(ds2)
    rows = enc.transform(ds2).take_all()
    assert rows[0]["tags"].tolist() == [1, 1]
    assert rows[1]["tags"].tolist() == [0, 1]
    assert rows[2]["tags"].tolist() == [0, 0]


def test_feature_hasher(cluster):
    ds = data.from_items([{"t": "a"}, {"t": "b"}])
    out = FeatureHasher(["t"], num_features=8).transform(ds).take_all()
    assert out[0]["hashed_features"].shape == (8,)
    assert out[0]["hashed_features"].sum() == 1.0
    assert "t" not in out[0]


@pytest.mark.slow
def test_tokenizer_and_count_vectorizer(cluster):
    ds = data.from_items([{"s": "the cat sat"}, {"s": "the hat"}])
    toks = Tokenizer(["s"]).transform(ds).take_all()
    assert list(toks[0]["s"]) == ["the", "cat", "sat"]

    cv = CountVectorizer(["s"]).fit(ds)
    vocab = cv.stats_["s"]
    rows = cv.transform(ds).take_all()
    assert rows[0]["s"][vocab["the"]] == 1
    assert rows[1]["s"][vocab["hat"]] == 1
    assert rows[0]["s"].sum() == 3 and rows[1]["s"].sum() == 2


def test_power_transformer_boxcox_rejects_nonpositive(cluster):
    with pytest.raises(Exception, match="positive"):
        PowerTransformer(["x"], power=0.5, method="box-cox") \
            .transform(_num_ds([1.0, 0.0])).take_all()


def test_batch_mapper_format_in_chain(cluster):
    from ray_tpu_torch.data.preprocessors import Chain

    ds = data.from_items([{"v": float(i)} for i in range(6)])
    bm = BatchMapper(lambda df: df.assign(w=df["v"] + 1),
                     batch_format="pandas")
    out = Chain(bm).fit_transform(ds).take_all()
    assert out[2]["w"] == 3.0
