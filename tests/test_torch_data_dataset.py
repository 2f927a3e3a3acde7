"""ray_tpu_torch.data: transforms, streaming iteration, split, file IO.

Reference test model: python/ray/data/tests/.

Port of tests/test_data_dataset.py, aimed at ray_tpu_torch. The train
cases take the port's names: ``DataParallelTrainer`` with
``use_gpu=False`` for ``JaxTrainer``, ``FunctionPredictor`` (asked for the
CPU) for ``JaxPredictor``, whose checkpointed weight is a tensor (DCP
keeps tensors; a numpy leaf would ride aux.pkl).
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def test_range_count_take(ray_start_regular):
    ds = rd.range(1000, num_blocks=4)
    assert ds.count() == 1000
    rows = ds.take(5)
    assert [int(r["id"]) for r in rows] == [0, 1, 2, 3, 4]


def test_map_batches_and_filter(ray_start_regular):
    ds = (rd.range(100, num_blocks=4)
          .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2})
          .filter(lambda r: r["id"] % 2 == 0))
    rows = ds.take_all()
    assert len(rows) == 50
    assert all(int(r["sq"]) == int(r["id"]) ** 2 for r in rows)


def test_from_items_map(ray_start_regular):
    ds = rd.from_items([1, 2, 3, 4, 5], num_blocks=2).map(lambda x: x * 10)
    assert sorted(ds.take_all()) == [10, 20, 30, 40, 50]


def test_iter_batches_sizes(ray_start_regular):
    ds = rd.range(250, num_blocks=5)
    batches = list(ds.iter_batches(batch_size=64))
    sizes = [len(b["id"]) for b in batches]
    assert sum(sizes) == 250
    assert all(s == 64 for s in sizes[:-1])


def test_streaming_split_disjoint(ray_start_regular):
    ds = rd.range(96, num_blocks=6)
    its = ds.streaming_split(3)
    seen = []
    for it in its:
        for b in it.iter_batches(batch_size=16):
            seen.extend(int(x) for x in b["id"])
    assert sorted(seen) == list(range(96))


def test_random_shuffle_and_repartition(ray_start_regular):
    ds = rd.range(100, num_blocks=4).random_shuffle(seed=7)
    rows = [int(r["id"]) for r in ds.take_all()]
    assert sorted(rows) == list(range(100))
    assert rows != list(range(100))
    ds2 = ds.repartition(10)
    assert ds2.num_blocks() == 10
    assert ds2.count() == 100


def test_read_csv(ray_start_regular, tmp_path):
    import pandas as pd

    for i in range(3):
        pd.DataFrame({"x": np.arange(10) + i * 10,
                      "y": np.arange(10) * 2}).to_csv(
            tmp_path / f"part{i}.csv", index=False)
    ds = rd.read_csv(str(tmp_path))
    assert ds.count() == 30
    assert set(ds.schema()) == {"x", "y"}


def test_trainer_dataset_ingest(ray_start_regular, tmp_path):
    """Train ingest: get_dataset_shard inside the train loop."""
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    ds = rd.range(64, num_blocks=4)

    def loop(config):
        from ray_tpu_torch.train import session

        it = session.get_dataset_shard("train")
        total = 0
        for b in it.iter_batches(batch_size=16):
            total += int(b["id"].sum())
        session.report({"total": total})
        return total

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": ds}).fit()
    assert result.ok, result.error
    assert result.metrics["total"] == sum(range(64))


def test_groupby_aggregate(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.data.aggregate import Count, Max, Mean, Sum

    ds = data.from_numpy({
        "k": np.array(["a", "b", "a", "c", "b", "a"]),
        "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
    }, num_blocks=3)
    out = ds.groupby("k").aggregate(Count(), Sum("v"), Mean("v"), Max("v"))
    rows = {r["k"]: r for r in out.take_all()}
    assert rows["a"]["count()"] == 3 and rows["a"]["sum(v)"] == 10.0
    assert rows["b"]["mean(v)"] == 3.5
    assert rows["c"]["max(v)"] == 4.0


def test_groupby_map_groups(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data

    ds = data.from_numpy({
        "k": np.array([0, 1, 0, 1, 0]),
        "v": np.array([1.0, 10.0, 2.0, 20.0, 3.0]),
    }, num_blocks=2)
    out = ds.groupby("k").map_groups(
        lambda g: {"k": int(g["k"][0]), "total": float(g["v"].sum())},
        num_partitions=3)
    rows = {r["k"]: r["total"] for r in out.take_all()}
    assert rows == {0: 6.0, 1: 30.0}


def test_sort_distributed(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data

    rng = np.random.default_rng(0)
    vals = rng.permutation(200).astype(np.int64)
    ds = data.from_numpy({"x": vals}, num_blocks=5)
    out = ds.sort("x").take_all()
    assert [r["x"] for r in out] == sorted(vals.tolist())
    out_desc = ds.sort("x", descending=True).take_all()
    assert [r["x"] for r in out_desc] == sorted(vals.tolist(), reverse=True)


def test_global_aggregates_and_columns(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data

    ds = data.range(100, num_blocks=4)
    assert ds.sum("id") == sum(range(100))
    assert ds.min("id") == 0 and ds.max("id") == 99
    assert abs(ds.mean("id") - 49.5) < 1e-9
    ds2 = ds.add_column("sq", lambda b: b["id"] ** 2)
    row = ds2.sort("id").take(1)[0]
    assert row["sq"] == 0
    assert ds2.select_columns(["sq"]).schema() == ["sq"]
    assert ds2.drop_columns(["sq"]).schema() == ["id"]


def test_preprocessors_scalers_and_chain(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.data.preprocessors import (Chain, Concatenator,
                                                  LabelEncoder, MinMaxScaler,
                                                  StandardScaler)

    ds = data.from_numpy({
        "a": np.array([1.0, 2.0, 3.0, 4.0]),
        "b": np.array([10.0, 20.0, 30.0, 40.0]),
        "label": np.array(["cat", "dog", "cat", "bird"]),
    }, num_blocks=2)

    scaler = StandardScaler(["a"])
    out = scaler.fit_transform(ds).take_all()
    col = np.array([r["a"] for r in out])
    assert abs(col.mean()) < 1e-9

    chain = Chain(MinMaxScaler(["a", "b"]), LabelEncoder("label"),
                  Concatenator(["a", "b"]))
    out2 = chain.fit_transform(ds).take_all()
    assert out2[0]["features"].shape == (2,)
    labels = sorted(r["label"] for r in out2)
    assert labels == [0, 1, 1, 2]


def test_batch_predictor(ray_start_regular, tmp_path):
    import numpy as np

    from ray_tpu_torch import data
    import torch

    from ray_tpu_torch.train import (BatchPredictor, Checkpoint,
                                     FunctionPredictor)

    # a "model": y = x @ w with w=2*I
    w = torch.eye(3, dtype=torch.float32) * 2
    ckpt = Checkpoint.from_state({"params": {"w": w}}, str(tmp_path / "ck"))

    def apply_fn(params, x):
        return x @ params["w"]

    ds = data.from_numpy(
        {"features": np.arange(30, dtype=np.float32).reshape(10, 3)},
        num_blocks=2)
    bp = BatchPredictor(ckpt, FunctionPredictor, apply_fn=apply_fn,
                        device="cpu")
    out = bp.predict(ds, num_replicas=2)
    rows = out.take_all()
    assert len(rows) == 10
    np.testing.assert_allclose(
        np.stack([r["predictions"] for r in rows]),
        np.arange(30, dtype=np.float32).reshape(10, 3) * 2)


def test_zip_unaligned_blocks(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data

    a = data.from_numpy({"x": np.arange(10)}, num_blocks=3)
    b = data.from_numpy({"y": np.arange(10) * 10}, num_blocks=4)
    rows = a.zip(b).take_all()
    assert len(rows) == 10
    for r in rows:
        assert r["y"] == r["x"] * 10


def test_std_large_mean_stability(ray_start_regular):
    import numpy as np

    from ray_tpu_torch import data

    rng = np.random.default_rng(0)
    vals = 1e8 + rng.normal(0, 0.5, size=1000)
    ds = data.from_numpy({"v": vals}, num_blocks=4)
    got = ds.std("v")
    want = float(np.std(vals, ddof=1))
    assert abs(got - want) / want < 1e-6, (got, want)


def test_sort_all_empty(ray_start_regular):
    from ray_tpu_torch import data

    ds = data.range(10, num_blocks=2).filter(lambda r: False)
    assert ds.sort("id").take_all() == []


def test_join_inner_left_outer(ray_start_regular):
    left = rd.from_numpy({"k": np.array([1, 2, 3, 4]),
                          "a": np.array([10, 20, 30, 40])}, num_blocks=2)
    right = rd.from_numpy({"k": np.array([2, 3, 5]),
                           "b": np.array([200, 300, 500])}, num_blocks=2)

    inner = left.join(right, on="k").take_all()
    assert sorted((int(r["k"]), int(r["a"]), int(r["b"])) for r in inner) \
        == [(2, 20, 200), (3, 30, 300)]

    lrows = left.join(right, on="k", how="left").take_all()
    assert sorted(int(r["k"]) for r in lrows) == [1, 2, 3, 4]
    unmatched = [r for r in lrows if int(r["k"]) == 1]
    assert np.isnan(unmatched[0]["b"])

    orows = left.join(right, on="k", how="outer").take_all()
    assert sorted(int(r["k"]) for r in orows) == [1, 2, 3, 4, 5]


def test_join_name_collision(ray_start_regular):
    left = rd.from_numpy({"k": np.array([1]), "v": np.array([7])})
    right = rd.from_numpy({"k": np.array([1]), "v": np.array([9])})
    rows = left.join(right, on="k").take_all()
    assert len(rows) == 1
    assert int(rows[0]["v"]) == 7 and int(rows[0]["v_1"]) == 9


def test_write_read_roundtrip(ray_start_regular, tmp_path):
    ds = rd.from_numpy({"x": np.arange(20), "y": np.arange(20) * 2.0},
                       num_blocks=3)
    pq_dir = str(tmp_path / "pq")
    files = ds.write_parquet(pq_dir)
    assert len(files) == 3
    back = rd.read_parquet(pq_dir)
    assert back.count() == 20
    assert back.sum("x") == sum(range(20))

    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    assert rd.read_csv(csv_dir).count() == 20

    js_dir = str(tmp_path / "js")
    ds.write_json(js_dir)
    assert rd.read_json(js_dir).count() == 20


def test_to_pandas_from_arrow(ray_start_regular):
    import pyarrow as pa

    ds = rd.from_numpy({"x": np.arange(5)})
    df = ds.to_pandas()
    assert list(df["x"]) == [0, 1, 2, 3, 4]
    t = pa.table({"z": [1, 2, 3]})
    assert rd.from_arrow(t).count() == 3
    assert rd.from_numpy({"x": np.arange(5)}).to_arrow().num_rows == 5


def test_read_text_binary(ray_start_regular, tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("hello\nworld\n")
    ds = rd.read_text(str(p))
    assert [r["text"] for r in ds.take_all()] == ["hello", "world"]

    bp = tmp_path / "b.bin"
    bp.write_bytes(b"\x00\x01\x02")
    rows = rd.read_binary_files(str(bp), include_paths=True).take_all()
    assert rows[0]["bytes"] == b"\x00\x01\x02"
    assert rows[0]["path"].endswith("b.bin")


def test_read_images(ray_start_regular, tmp_path):
    from PIL import Image

    arr = np.zeros((4, 6, 3), np.uint8)
    arr[..., 0] = 255
    Image.fromarray(arr).save(tmp_path / "im.png")
    rows = rd.read_images(str(tmp_path / "im.png")).take_all()
    assert rows[0]["image"].shape == (4, 6, 3)
    assert rows[0]["image"][0, 0, 0] == 255


def test_read_tfrecords(ray_start_regular, tmp_path):
    import struct

    def varint(x):
        out = b""
        while True:
            b7 = x & 0x7F
            x >>= 7
            out += bytes([b7 | (0x80 if x else 0)])
            if not x:
                return out

    def field(num, wt, payload):
        return varint((num << 3) | wt) + payload

    def ld(num, data):
        return field(num, 2, varint(len(data)) + data)

    def example(feats):
        entries = b""
        for k, (kind, vals) in feats.items():
            if kind == "int64":
                packed = b"".join(varint(v) for v in vals)
                flist = ld(3, ld(1, packed) if len(vals) > 1
                           else field(1, 0, varint(vals[0])))
            elif kind == "float":
                flist = ld(2, ld(1, struct.pack(f"<{len(vals)}f", *vals)))
            else:
                flist = ld(1, b"".join(ld(1, v) for v in vals))
            entry = ld(1, k.encode()) + ld(2, flist)
            entries += ld(1, entry)
        return ld(1, entries)

    path = tmp_path / "t.tfrecords"
    with open(path, "wb") as f:
        for i in range(3):
            rec = example({"id": ("int64", [i]),
                           "score": ("float", [i * 0.5, 1.0]),
                           "name": ("bytes", [f"r{i}".encode()])})
            f.write(struct.pack("<Q", len(rec)) + b"\x00" * 4 + rec
                    + b"\x00" * 4)
    rows = rd.read_tfrecords(str(path)).take_all()
    assert len(rows) == 3
    assert sorted(int(r["id"]) for r in rows) == [0, 1, 2]
    r0 = [r for r in rows if int(r["id"]) == 0][0]
    assert r0["name"] == b"r0"
    assert abs(r0["score"][1] - 1.0) < 1e-6


def test_dataset_stats(ray_start_regular):
    s = rd.range(100, num_blocks=4).stats()
    assert "4 blocks" in s and "100 rows" in s


def test_join_outer_empty_left_partition(ray_start_regular):
    left = rd.from_numpy({"k": np.array([2]), "a": np.array([20])})
    right = rd.from_numpy({"k": np.array([5]), "b": np.array([500])})
    rows = left.join(right, on="k", how="outer", num_partitions=2).take_all()
    assert sorted(int(r["k"]) for r in rows) == [2, 5]


def test_join_mixed_numeric_dtypes(ray_start_regular):
    left = rd.from_numpy({"k": np.array([2]), "a": np.array([1])})
    right = rd.from_numpy({"k": np.array([2.0]), "b": np.array([9])})
    rows = left.join(right, on="k", num_partitions=4).take_all()
    assert len(rows) == 1 and int(rows[0]["b"]) == 9


def test_tfrecords_negative_int64(ray_start_regular, tmp_path):
    import struct

    def varint(x):
        out = b""
        while True:
            b7 = x & 0x7F
            x >>= 7
            out += bytes([b7 | (0x80 if x else 0)])
            if not x:
                return out

    def field(num, wt, payload):
        return varint((num << 3) | wt) + payload

    def ld(num, data):
        return field(num, 2, varint(len(data)) + data)

    neg = varint((-3) & ((1 << 64) - 1))      # proto int64 -3 as 10B varint
    flist = ld(3, field(1, 0, neg))
    entry = ld(1, b"label") + ld(2, flist)
    rec = ld(1, ld(1, entry))
    path = tmp_path / "n.tfrecords"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(rec)) + b"\0" * 4 + rec + b"\0" * 4)
    rows = rd.read_tfrecords(str(path)).take_all()
    assert int(rows[0]["label"]) == -3


def test_sql_roundtrip(ray_start_regular, tmp_path):
    """ref: datasource/sql_datasource.py — DBAPI2 read/write (sqlite)."""
    import sqlite3

    from ray_tpu_torch import data as rd

    db = str(tmp_path / "t.db")

    def connect():
        return sqlite3.connect(db)

    ds = rd.from_numpy({"x": np.arange(10), "name": np.asarray(
        [f"row{i}" for i in range(10)], dtype=object)}, num_blocks=3)
    assert rd.write_sql(ds, "items", connect) == 10

    out = rd.read_sql("SELECT x, name FROM items ORDER BY x", connect)
    rows = out.take_all()
    assert len(rows) == 10 and rows[3] == {"x": 3, "name": "row3"}

    # paginated parallel read
    out2 = rd.read_sql("SELECT x FROM items ORDER BY x", connect,
                       parallelism=3)
    xs = sorted(r["x"] for r in out2.take_all())
    assert xs == list(range(10))

    # replace mode
    assert rd.write_sql(ds, "items", connect, if_exists="replace") == 10
    assert len(rd.read_sql("SELECT * FROM items", connect).take_all()) == 10

    # blocks emptied by transforms are skipped, not crashed on
    assert rd.write_sql(ds.filter(lambda r: False), "none_t", connect) == 0


def test_webdataset_reader(ray_start_regular, tmp_path):
    """ref: datasource/webdataset_datasource.py — tar shards of
    extension-keyed samples."""
    import io
    import json as _json
    import tarfile

    shard = tmp_path / "shard-000.tar"
    with tarfile.open(shard, "w") as tf:
        for i in range(3):
            for ext, payload in (
                    ("txt", f"caption {i}".encode()),
                    ("json", _json.dumps({"idx": i}).encode()),
                    ("bin", bytes([i, i + 1]))):
                info = tarfile.TarInfo(f"sample{i:04d}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))

    from ray_tpu_torch import data as rd

    rows = rd.read_webdataset(str(shard)).take_all()
    assert len(rows) == 3
    assert rows[0]["__key__"] == "sample0000"
    assert rows[1]["txt"] == "caption 1"
    assert rows[2]["json"] == {"idx": 2}
    assert rows[0]["bin"] == b"\x00\x01"


def test_iter_torch_batches(ray_start_regular):
    import torch

    from ray_tpu_torch import data

    ds = data.range(100)
    seen = 0
    for b in ds.iter_torch_batches(batch_size=32):
        assert isinstance(b["id"], torch.Tensor)
        seen += len(b["id"])
    assert seen == 100
    # dtype + list-block path
    ds2 = data.from_items([float(i) for i in range(10)], num_blocks=2)
    b = next(ds2.iter_torch_batches(batch_size=10, dtypes=torch.float32))
    assert b.dtype == torch.float32 and b.shape == (10,)
    # per-column dtypes dict (ref iterator.py API shape)
    b = next(ds.iter_torch_batches(batch_size=8,
                                   dtypes={"id": torch.float64}))
    assert b["id"].dtype == torch.float64


def test_map_batches_actor_pool(ray_start_regular):
    """Stateful class UDF over an actor pool: construction happens once
    per actor, not per block (ref: actor_pool_map_operator.py)."""
    import os

    from ray_tpu_torch import data
    from ray_tpu_torch.data import ActorPoolStrategy

    class AddModelBias:
        def __init__(self, bias):
            self.bias = bias          # "expensive model load"
            self.pid = os.getpid()
            # identity of THIS pool actor: fractional-CPU pool actors may
            # lane-pack into one process, so pid no longer distinguishes
            # them — actor id (per lane execution context) does
            self.tag = hash(ray_tpu_torch.get_runtime_context().get_actor_id())

        def __call__(self, batch):
            return {"id": batch["id"] + self.bias,
                    "tag": np.full(len(batch["id"]), self.tag,
                                   dtype=np.int64)}

    ds = data.range(64, num_blocks=8).map_batches(
        AddModelBias, compute=ActorPoolStrategy(size=2),
        fn_constructor_args=(1000,))
    rows = ds.take_all()
    assert len(rows) == 64
    assert sorted(r["id"] for r in rows) == list(range(1000, 1064))
    # 8 blocks ran on exactly 2 pool actors (one ctor each)
    assert len({int(r["tag"]) for r in rows}) == 2


def test_map_batches_actor_pool_after_lazy_ops(ray_start_regular):
    from ray_tpu_torch import data
    from ray_tpu_torch.data import ActorPoolStrategy

    class Square:
        def __call__(self, batch):
            return {"id": batch["id"] ** 2}

    ds = (data.range(20, num_blocks=4)
          .filter(lambda r: r["id"] % 2 == 0)
          .map_batches(Square, compute=ActorPoolStrategy(size=1)))
    assert sorted(r["id"] for r in ds.take_all()) == [
        (2 * i) ** 2 for i in range(10)]


def test_map_batches_actor_pool_empty_block(ray_start_regular):
    """A block fully emptied by an upstream filter skips the UDF
    (regression: the empty block loses its schema and arrives as [])."""
    from ray_tpu_torch import data
    from ray_tpu_torch.data import ActorPoolStrategy

    class Add5:
        def __call__(self, b):
            return {"id": b["id"] + 5}

    out = (data.range(30, num_blocks=3)
           .filter(lambda r: r["id"] < 20)   # third block -> empty
           .map_batches(Add5, compute=ActorPoolStrategy(size=2))
           .take_all())
    assert sorted(r["id"] for r in out) == [i + 5 for i in range(20)]


def test_split_at_indices_and_train_test_split(ray_start_regular):
    from ray_tpu_torch import data

    parts = data.range(100).split_at_indices([30, 80])
    assert [p.count() for p in parts] == [30, 50, 20]
    assert parts[1].take(1)[0]["id"] == 30

    train, test = data.range(50).train_test_split(0.2)
    assert train.count() == 40 and test.count() == 10
    train, test = data.range(50).train_test_split(0.2, shuffle=True, seed=7)
    assert train.count() == 40 and test.count() == 10
    ids = {r["id"] for r in train.take_all()} | {
        r["id"] for r in test.take_all()}
    assert ids == set(range(50))


def test_unique_and_show(ray_start_regular, capsys):
    from ray_tpu_torch import data

    ds = data.from_items([{"c": i % 3} for i in range(30)], num_blocks=3)
    assert ds.unique("c") == [0, 1, 2]
    ds.show(2)
    out = capsys.readouterr().out
    assert out.count("\n") == 2


def test_iter_blocks_streaming_backpressure(ray_start_regular, tmp_path):
    """Producers must not run unboundedly ahead of a slow consumer: each
    shard executor stalls in its withheld item ack once it is
    _STREAM_AHEAD blocks ahead (streaming-generator backpressure)."""
    import time

    from ray_tpu_torch import data

    marker_dir = tmp_path

    def mark(batch):
        (marker_dir / f"b{int(batch['id'][0])}").write_text("x")
        return batch

    ds = data.range(20, num_blocks=20).map_batches(mark)
    it = iter(ds._iter_blocks())
    for _ in range(4):                   # consume one round-robin round
        next(it)
    time.sleep(1.5)                      # give producers time to run ahead
    produced = len(list(marker_dir.iterdir()))
    # 4 shards x (1 consumed + 2 ahead + 1 awaiting ack) = 16 max
    assert produced < 20, "producers transformed everything despite slow consumer"
    rest = list(it)
    assert len(rest) == 16               # and the stream still completes
    assert len(list(marker_dir.iterdir())) == 20


def test_byte_budget_backpressure_small_store(tmp_path):
    """Block size x naive window would exceed the store: the byte-budget
    admission must throttle producers so iteration completes with peak
    store usage under the spill threshold — no spill-thrash, no OOM
    (VERDICT r1 weak #8; ref: streaming_executor_state.py admission by
    object-store memory)."""
    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.core import runtime as rt

    store_mb = 256
    ray_tpu_torch.init(num_cpus=8, _system_config={
        "object_store_memory": store_mb << 20,
        "object_spill_dir": str(tmp_path / "spill")})
    try:
        blk = 16 << 20                       # each output block 16 MiB

        def inflate(batch):
            n = int(batch["id"][0])
            return {"id": batch["id"],
                    "payload": np.full((len(batch["id"]), blk),
                                       n, dtype=np.uint8)}   # blk BYTES/row

        # 20 blocks x 16 MiB = 320 MiB through a 256 MiB store.
        # Unthrottled: 4 shards x (2 ahead + 1 in-ack + 1 consumed) x
        # 16 MiB = 256 MiB resident -> crosses the 0.8 spill threshold
        # (204 MiB). Byte budget (0.25 x store / 4 shards = 16 MiB/shard)
        # caps each shard at ~2 resident blocks -> ~128 MiB peak.
        ds = data.range(20, num_blocks=20).map_batches(inflate)
        runtime = rt.get_runtime()
        peak = 0
        seen = 0
        for block in ds._iter_blocks():
            assert block["payload"].nbytes == blk
            peak = max(peak, runtime.store.bytes_in_use())
            del block                       # consumer keeps nothing
            seen += 1
        assert seen == 20
        spill_dir = tmp_path / "spill"
        spilled = (len(list(spill_dir.rglob("*")))
                   if spill_dir.exists() else 0)
        assert peak < int(0.8 * (store_mb << 20)), \
            f"peak store usage {peak >> 20} MiB crossed the spill threshold"
        assert spilled == 0, f"{spilled} objects spilled — admission failed"
    finally:
        ray_tpu_torch.shutdown()


def test_unique_after_emptying_filter(ray_start_regular):
    """unique() must skip blocks fully emptied by an upstream filter —
    they pass through as schemaless [] (regression for ADVICE r1)."""
    from ray_tpu_torch import data

    ds = data.from_items([{"c": i} for i in range(30)], num_blocks=3)
    assert ds.filter(lambda r: r["c"] < 20).unique("c") == list(range(20))


def test_map_batches_empty_block_task_path(ray_start_regular):
    """Empty-block UDF skip on the plain task path too (the guard lives
    in _apply_op, not only the actor path)."""
    from ray_tpu_torch import data

    out = (data.range(30, num_blocks=3)
           .filter(lambda r: r["id"] < 20)
           .map_batches(lambda b: {"id": b["id"] + 5})
           .take_all())
    assert sorted(r["id"] for r in out) == [i + 5 for i in range(20)]


def test_split_at_indices_validates(ray_start_regular):
    from ray_tpu_torch import data

    import pytest as _pt

    with _pt.raises(ValueError, match="sorted"):
        data.range(10).split_at_indices([8, 3])
    with _pt.raises(ValueError, match="non-negative"):
        data.range(10).split_at_indices([-1])
