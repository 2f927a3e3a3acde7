"""Arrow interop plane: zero-copy column views, batch_format presentation
in map_batches / iter_batches (ref: python/ray/data batch_format= API and
_internal/arrow_block.py zero-copy accessor).

Port of tests/test_data_arrow.py, aimed at ray_tpu_torch."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data
from torch_runtime_support import (  # noqa: F401
    reap_orphans)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_arrow_to_block_zero_copy():
    import pyarrow as pa

    from ray_tpu_torch.data.dataset import _arrow_to_block

    t = pa.table({"x": np.arange(1000, dtype=np.int64),
                  "y": np.linspace(0, 1, 1000)})
    block = _arrow_to_block(t)
    # numeric, no-null columns are VIEWS over the arrow buffers
    buf_addr = t["x"].chunk(0).buffers()[1].address
    assert block["x"].ctypes.data == buf_addr
    assert not block["x"].flags["OWNDATA"]
    # string columns can't be viewed; they must still convert correctly
    t2 = pa.table({"s": ["a", "b"], "v": [1.0, 2.0]})
    b2 = _arrow_to_block(t2)
    assert list(b2["s"]) == ["a", "b"]


def test_from_arrow_roundtrip(cluster):
    import pyarrow as pa

    t = pa.table({"a": np.arange(100), "b": np.arange(100) * 2.0})
    ds = data.from_arrow(t, num_blocks=4)
    assert ds.count() == 100
    out = ds.to_arrow()
    assert out.column_names == ["a", "b"]
    assert np.array_equal(out["a"].to_numpy(), np.arange(100))


def test_map_batches_pyarrow_format(cluster):
    import pyarrow as pa

    ds = data.from_items([{"v": float(i)} for i in range(40)],
                         num_blocks=4)

    def udf(table):
        assert isinstance(table, pa.Table)
        return table.append_column(
            "doubled", pa.array(table["v"].to_numpy(
                zero_copy_only=False) * 2))

    out = ds.map_batches(udf, batch_format="pyarrow").take_all()
    assert out[3]["doubled"] == 6.0


def test_map_batches_pandas_format(cluster):
    import pandas as pd

    ds = data.from_items([{"v": i} for i in range(20)], num_blocks=2)

    def udf(df):
        assert isinstance(df, pd.DataFrame)
        df["sq"] = df["v"] ** 2
        return df

    out = ds.map_batches(udf, batch_format="pandas").take_all()
    assert out[4]["sq"] == 16


def test_map_batches_bad_format_rejected(cluster):
    ds = data.from_items([{"v": 1}])
    with pytest.raises(ValueError, match="batch_format"):
        ds.map_batches(lambda b: b, batch_format="polars").take_all()


def test_iter_batches_formats(cluster):
    import pandas as pd
    import pyarrow as pa

    ds = data.from_items([{"v": i} for i in range(30)], num_blocks=3)
    pa_batches = list(ds.iter_batches(batch_size=10,
                                      batch_format="pyarrow"))
    assert all(isinstance(b, pa.Table) for b in pa_batches)
    assert sum(b.num_rows for b in pa_batches) == 30
    pd_batches = list(ds.iter_batches(batch_size=16,
                                      batch_format="pandas"))
    assert all(isinstance(b, pd.DataFrame) for b in pd_batches)
    assert sum(len(b) for b in pd_batches) == 30


def test_actor_pool_map_batches_with_format(cluster):
    import pyarrow as pa

    class AddCol:
        def __init__(self, k):
            self.k = k

        def __call__(self, table):
            assert isinstance(table, pa.Table)
            return table.append_column(
                "plus", pa.array(table["v"].to_numpy(
                    zero_copy_only=False) + self.k))

    ds = data.from_items([{"v": float(i)} for i in range(24)],
                         num_blocks=3)
    out = ds.map_batches(AddCol, batch_format="pyarrow",
                         compute=data.ActorPoolStrategy(size=2),
                         fn_constructor_args=(10.0,)).take_all()
    assert sorted(r["plus"] for r in out)[0] == 10.0


def test_parquet_read_zero_copy_path(cluster, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": np.arange(50, dtype=np.float64)}), p)
    ds = data.read_parquet([p])
    assert ds.count() == 50
    assert np.isclose(sum(r["x"] for r in ds.take_all()), np.arange(50).sum())


def test_columns_and_take_batch(cluster):
    ds = data.from_items([{"a": i, "b": i * 2} for i in range(10)],
                         num_blocks=2)
    assert ds.columns() == ["a", "b"]
    batch = ds.take_batch(4)
    assert len(batch["a"]) == 4
    import pyarrow as pa

    tb = ds.take_batch(3, batch_format="pyarrow")
    assert isinstance(tb, pa.Table) and tb.num_rows == 3


def test_pandas_format_preserves_2d_columns(cluster):
    """A (n,k) column must survive the pandas round-trip (pandas holds
    it as array-of-arrays; _coerce_block restacks it)."""
    ds = data.from_numpy({"x": np.arange(32, dtype=np.float32)
                          .reshape(8, 4)}, num_blocks=2)
    out = ds.map_batches(lambda df: df, batch_format="pandas")
    got = out.take_batch(8)["x"]
    assert got.shape == (8, 4) and got.dtype == np.float32
