"""Preprocessors: fit on a Dataset, transform Datasets/batches.

Reference: python/ray/data/preprocessors/ — Preprocessor base
(fit/transform/transform_batch), scalers (scaler.py), encoders
(encoder.py), imputer, concatenator, chain. Stats are computed with the
dataset's distributed aggregates; transform is a map_batches.

A copy of ``ray_tpu/data/preprocessors.py``: all twenty classes (the
base and nineteen preprocessors), numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return ds.map_batches(self.transform_batch)

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds):
        pass

    def transform_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (ref: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str], ddof: int = 0):
        self.columns = columns
        self.ddof = ddof
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            mean = ds.mean(c)
            std = ds.std(c, ddof=self.ddof) or 0.0
            self.stats_[c] = (mean, std if std > 0 else 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = (np.asarray(batch[c], dtype=np.float64) - mean) / std
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            lo, hi = ds.min(c), ds.max(c)
            self.stats_[c] = (lo, (hi - lo) or 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            lo, span = self.stats_[c]
            out[c] = (np.asarray(batch[c], dtype=np.float64) - lo) / span
        return out


def _distributed_unique(ds, column: str) -> np.ndarray:
    """Per-block np.unique in remote tasks; only the (small) unique sets
    reach the driver."""
    uniq: set = set()
    per_block = ds.select_columns([column]).map_batches(
        lambda b: {column: np.unique(np.asarray(b[column]))})
    for block in per_block._iter_blocks():
        uniq.update(np.asarray(block[column]).tolist())
    return np.asarray(sorted(uniq))


class LabelEncoder(Preprocessor):
    """Categorical → ordinal int (ref: preprocessors/encoder.py)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Optional[np.ndarray] = None

    def _fit(self, ds):
        self.classes_ = _distributed_unique(ds, self.label_column)

    def transform_batch(self, batch):
        out = dict(batch)
        lut = {v: i for i, v in enumerate(self.classes_.tolist())}
        out[self.label_column] = np.asarray(
            [lut[v] for v in np.asarray(batch[self.label_column]).tolist()])
        return out


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.classes_: Dict[str, np.ndarray] = {}

    def _fit(self, ds):
        for c in self.columns:
            self.classes_[c] = _distributed_unique(ds, c)

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            vals = np.asarray(batch[c])
            for cls in self.classes_[c].tolist():
                out[f"{c}_{cls}"] = (vals == cls).astype(np.int64)
        return out


class SimpleImputer(Preprocessor):
    """Fill NaNs with mean ('mean') or a constant ('constant')."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Any = 0.0):
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: Dict[str, float] = {}

    def _needs_fit(self):
        return self.strategy == "mean"

    def _fit(self, ds):
        if self.strategy != "mean":
            return
        for c in self.columns:
            # NaN-aware mean over blocks
            def _clean(b, c=c):
                col = np.asarray(b[c], dtype=np.float64)
                return {c: col[~np.isnan(col)]}

            self.stats_[c] = ds.select_columns([c]).map_batches(_clean).mean(c)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            col = np.asarray(batch[c], dtype=np.float64)
            fill = self.stats_.get(c, self.fill_value)
            out[c] = np.where(np.isnan(col), fill, col)
        return out


class Concatenator(Preprocessor):
    """Merge feature columns into one float matrix column (ref:
    preprocessors/concatenator.py) — the standard last step before
    feeding a torch model."""

    def __init__(self, columns: List[str], output_column_name: str = "features",
                 dtype=np.float32):
        self.columns = columns
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _needs_fit(self):
        return False

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        mats = [np.asarray(batch[c], dtype=self.dtype).reshape(
            len(np.asarray(batch[c])), -1) for c in self.columns]
        out[self.output_column_name] = np.concatenate(mats, axis=1)
        return out


class Chain(Preprocessor):
    def __init__(self, *steps: Preprocessor):
        self.steps = steps

    def fit(self, ds):
        for i, step in enumerate(self.steps):
            step.fit(ds)
            if i < len(self.steps) - 1:
                ds = step.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        for step in self.steps:
            ds = step.transform(ds)
        return ds

    def transform_batch(self, batch):
        for step in self.steps:
            batch = step.transform_batch(batch)
        return batch


class BatchMapper(Preprocessor):
    """Apply a user batch function, no fitting (ref:
    preprocessors/batch_mapper.py)."""

    def __init__(self, fn, batch_format: Optional[str] = None):
        self.fn = fn
        self.batch_format = batch_format

    def _needs_fit(self) -> bool:
        return False

    def transform(self, ds):
        return ds.map_batches(self.fn, batch_format=self.batch_format)

    def transform_batch(self, batch):
        # honor batch_format on the direct-batch path too (Chain calls
        # transform_batch; the fn may be written against a DataFrame)
        from ray_tpu_torch.data.dataset import _coerce_block, _to_batch_format

        return _coerce_block(self.fn(_to_batch_format(batch,
                                                      self.batch_format)))


class Normalizer(Preprocessor):
    """Row-wise norm scaling across columns (ref:
    preprocessors/normalizer.py; norms l1/l2/max)."""

    def __init__(self, columns: List[str], norm: str = "l2"):
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unsupported norm {norm!r}")
        self.columns = columns
        self.norm = norm

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch):
        cols = [np.asarray(batch[c], np.float64) for c in self.columns]
        mat = np.stack(cols, axis=1)
        if self.norm == "l1":
            denom = np.abs(mat).sum(axis=1)
        elif self.norm == "l2":
            denom = np.sqrt((mat * mat).sum(axis=1))
        else:
            denom = np.abs(mat).max(axis=1)
        denom = np.where(denom == 0, 1.0, denom)
        out = dict(batch)
        for i, c in enumerate(self.columns):
            out[c] = mat[:, i] / denom
        return out


class MaxAbsScaler(Preprocessor):
    """x / max|x| per column (ref: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, float] = {}

    def _fit(self, ds):
        for c in self.columns:
            m = max(abs(ds.min(c)), abs(ds.max(c)))
            self.stats_[c] = m or 1.0

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.asarray(batch[c], np.float64) / self.stats_[c]
        return out


class RobustScaler(Preprocessor):
    """(x - median) / IQR per column (ref: preprocessors/scaler.py).

    Exact quantiles need the whole column: blocks stream to the driver
    one at a time (only the selected column), so the driver holds one
    column, not the dataset — fine for numeric columns, the same
    trade-off the reference's exact-quantile path makes."""

    def __init__(self, columns: List[str],
                 quantile_range: tuple = (0.25, 0.75)):
        self.columns = columns
        self.quantile_range = quantile_range
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        lo_q, hi_q = self.quantile_range
        for c in self.columns:
            parts = [np.asarray(b[c], np.float64)
                     for b in ds.select_columns([c])._iter_blocks()
                     if len(b[c])]
            if not parts:
                self.stats_[c] = (0.0, 1.0)
                continue
            vals = np.concatenate(parts)
            med = float(np.quantile(vals, 0.5))
            iqr = float(np.quantile(vals, hi_q) - np.quantile(vals, lo_q))
            self.stats_[c] = (med, iqr or 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            med, iqr = self.stats_[c]
            out[c] = (np.asarray(batch[c], np.float64) - med) / iqr
        return out


class PowerTransformer(Preprocessor):
    """Box-Cox / Yeo-Johnson with a CALLER-CHOSEN lambda (ref:
    preprocessors/transformer.py — the reference likewise takes `power`
    as a parameter rather than estimating it)."""

    def __init__(self, columns: List[str], power: float,
                 method: str = "yeo-johnson"):
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError(f"unsupported method {method!r}")
        self.columns = columns
        self.power = power
        self.method = method

    def _needs_fit(self) -> bool:
        return False

    def _apply(self, x: np.ndarray) -> np.ndarray:
        lam = self.power
        if self.method == "box-cox":
            if np.any(x <= 0):
                # silent NaN/-inf would flow into training; sklearn's
                # box-cox raises on non-positive data for the same reason
                raise ValueError(
                    "box-cox requires strictly positive values; use "
                    "method='yeo-johnson' for zero/negative data")
            return np.log(x) if lam == 0 else (x ** lam - 1) / lam
        pos = x >= 0
        out = np.empty_like(x, dtype=np.float64)
        if lam == 0:
            out[pos] = np.log1p(x[pos])
        else:
            out[pos] = ((x[pos] + 1) ** lam - 1) / lam
        if lam == 2:
            out[~pos] = -np.log1p(-x[~pos])
        else:
            out[~pos] = -((-x[~pos] + 1) ** (2 - lam) - 1) / (2 - lam)
        return out

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = self._apply(np.asarray(batch[c], np.float64))
        return out


class UniformKBinsDiscretizer(Preprocessor):
    """Equal-width binning into int bin ids (ref:
    preprocessors/discretizer.py)."""

    def __init__(self, columns: List[str], bins: int):
        self.columns = columns
        self.bins = bins
        self.stats_: Dict[str, np.ndarray] = {}

    def _fit(self, ds):
        for c in self.columns:
            lo, hi = ds.min(c), ds.max(c)
            self.stats_[c] = np.linspace(lo, hi, self.bins + 1)[1:-1]

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.digitize(np.asarray(batch[c], np.float64),
                                 self.stats_[c]).astype(np.int64)
        return out


class CustomKBinsDiscretizer(Preprocessor):
    """Binning on caller-provided edges (ref: discretizer.py)."""

    def __init__(self, columns: List[str], bins: List[float]):
        self.columns = columns
        self.bins = np.asarray(bins, np.float64)

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = (np.digitize(np.asarray(batch[c], np.float64),
                                  self.bins) - 1).astype(np.int64)
        return out


class OrdinalEncoder(Preprocessor):
    """Categorical -> ordinal ints per column, like LabelEncoder over
    many columns (ref: preprocessors/encoder.py OrdinalEncoder)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Dict[Any, int]] = {}

    def _fit(self, ds):
        for c in self.columns:
            cats = _distributed_unique(ds, c)
            self.stats_[c] = {v: i for i, v in enumerate(cats.tolist())}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            m = self.stats_[c]
            out[c] = np.asarray([m.get(v, -1)
                                 for v in np.asarray(batch[c]).tolist()],
                                np.int64)
        return out


class MultiHotEncoder(Preprocessor):
    """List-valued categorical column -> multi-hot vector (ref:
    preprocessors/encoder.py MultiHotEncoder)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Dict[Any, int]] = {}

    def _fit(self, ds):
        for c in self.columns:
            # per-block unique in remote tasks; only small unique sets
            # reach the driver (same pattern as _distributed_unique)
            uniq: set = set()
            reduced = ds.select_columns([c]).map_batches(
                lambda b, col=c: {col: np.asarray(
                    sorted({v for row in np.asarray(b[col], dtype=object)
                            for v in list(row)}), dtype=object)})
            for block in reduced._iter_blocks():
                uniq.update(np.asarray(block[c]).tolist())
            self.stats_[c] = {v: i for i, v in enumerate(sorted(uniq))}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            m = self.stats_[c]
            rows = np.asarray(batch[c], dtype=object)
            enc = np.zeros((len(rows), len(m)), np.int64)
            for i, row in enumerate(rows):
                for v in list(row):
                    j = m.get(v)
                    if j is not None:
                        enc[i, j] = 1
            out[c] = enc
        return out


class FeatureHasher(Preprocessor):
    """Token-count dict -> fixed-width hashed feature vector (ref:
    preprocessors/hasher.py)."""

    def __init__(self, columns: List[str], num_features: int,
                 output_column: str = "hashed_features"):
        self.columns = columns
        self.num_features = num_features
        self.output_column = output_column

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch):
        import zlib

        n = len(next(iter(batch.values())))
        mat = np.zeros((n, self.num_features), np.float64)
        for c in self.columns:
            col = np.asarray(batch[c], dtype=object)
            for i in range(n):
                # stable across processes (builtin hash() is salted)
                j = zlib.crc32(f"{c}={col[i]}".encode()) \
                    % self.num_features
                mat[i, j] += 1.0
        out = {k: v for k, v in batch.items() if k not in self.columns}
        out[self.output_column] = mat
        return out


class Tokenizer(Preprocessor):
    """String column -> list of tokens (ref: preprocessors/tokenizer.py;
    default splits on whitespace)."""

    def __init__(self, columns: List[str], tokenization_fn=None):
        self.columns = columns
        self.fn = tokenization_fn or (lambda s: s.split())

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.asarray(
                [self.fn(str(v)) for v in np.asarray(batch[c])],
                dtype=object)
        return out


class CountVectorizer(Preprocessor):
    """Token counts over a fitted vocabulary (ref:
    preprocessors/vectorizer.py)."""

    def __init__(self, columns: List[str], max_features: Optional[int] = None,
                 tokenization_fn=None):
        self.columns = columns
        self.max_features = max_features
        self.fn = tokenization_fn or (lambda s: s.split())
        self.stats_: Dict[str, Dict[str, int]] = {}

    def _fit(self, ds):
        from collections import Counter

        fn = self.fn
        for c in self.columns:
            # tokenize + count per block remotely; only the (small)
            # token->count dicts travel to the driver for the merge
            def _count(b, col=c):
                cnt: Counter = Counter()
                for v in np.asarray(b[col]):
                    cnt.update(fn(str(v)))
                return {"counts": np.asarray([dict(cnt)], dtype=object)}

            counts: Counter = Counter()
            for block in ds.select_columns([c]).map_batches(
                    _count)._iter_blocks():
                for d in np.asarray(block["counts"], dtype=object):
                    counts.update(d)
            vocab = [t for t, _ in counts.most_common(self.max_features)]
            self.stats_[c] = {t: i for i, t in enumerate(sorted(vocab))}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            vocab = self.stats_[c]
            rows = np.asarray(batch[c])
            mat = np.zeros((len(rows), len(vocab)), np.int64)
            for i, v in enumerate(rows):
                for t in self.fn(str(v)):
                    j = vocab.get(t)
                    if j is not None:
                        mat[i, j] += 1
            out[c] = mat
        return out
