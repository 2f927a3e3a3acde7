"""The port's data layer (``ray_tpu_torch/data``) against the JAX package's
(``ray_tpu/data``) on the same seeded numpy inputs.

The reference's data modules load through ``test_torch_support``'s stub
packages (``import ray_tpu`` fails on this Python). Where a reference
function reaches the object store (``random_shuffle``, ``DataIterator``),
``reference_store()`` gives the stub ``ray_tpu`` module identity
``put``/``get``/``wait`` for the block: a ref is the block itself. The
port runs on its own runtime (a module-scoped cluster).

Held here, exactly (integers and f32/f64 through the same numpy) unless a
test says otherwise:
- the block-level functions of ``dataset.py`` (``_apply_op``,
  ``_transform_block``, ``_apply_rebatched``, ``_to_batch_format``,
  ``_coerce_block``, ``_block_concat``, ``_block_slice``,
  ``_rows_to_block`` and the row/byte counts);
- every aggregate of ``aggregate.py``, block by block and merged;
- each preprocessor's ``transform_batch`` given the same fitted state;
- ``DataIterator.iter_batches`` with ``local_shuffle_seed`` and
  ``random_shuffle``'s row order;
- the ``ResourceManager``'s admission choices on the same operator states;
- whole pipelines (``map_batches`` -> ``filter`` -> ``random_shuffle`` ->
  ``iter_batches``) through the port's runtime, under each execution
  policy, against the reference's block functions applied in process.
"""

from __future__ import annotations

import contextlib
import copy
import sys

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.data import aggregate as port_agg
from ray_tpu_torch.data import dataset as port_ds
from ray_tpu_torch.data import preprocessors as port_pp
from ray_tpu_torch.data.execution import get_context
from ray_tpu_torch.data.execution import interfaces as port_if
from ray_tpu_torch.data.execution import resource_manager as port_rm
from test_torch_support import jax_reference
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@contextlib.contextmanager
def reference_store():
    """Identity put/get/wait on the stub ``ray_tpu`` module (call inside
    ``jax_reference()``): an object ref is the object itself. On exit the
    stub's own attributes come back (its local-mode ``get`` and ``wait``,
    which the RL parity tests run on in the same process)."""
    stub = sys.modules["ray_tpu"]
    names = ("put", "get", "wait")
    saved = {n: getattr(stub, n) for n in names if hasattr(stub, n)}
    stub.put = lambda x: x
    stub.get = lambda r: [x for x in r] if isinstance(r, list) else r
    stub.wait = lambda refs, num_returns=1, timeout=None: (
        list(refs[:num_returns]), list(refs[num_returns:]))
    try:
        yield
    finally:
        for name in names:
            if name in saved:
                setattr(stub, name, saved[name])
            else:
                delattr(stub, name)


def same(a, b, path="out"):
    """a and b equal in type, structure, dtype and value (NaN == NaN)."""
    import pandas as pd
    import pyarrow as pa

    if isinstance(a, dict):
        assert isinstance(b, dict), path
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == object:
            assert len(a.reshape(-1)) == len(b.reshape(-1)), path
            for i, (x, y) in enumerate(zip(a.reshape(-1), b.reshape(-1))):
                same(x, y, f"{path}.flat[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, pa.Table):
        assert a.equals(b), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _blocks(seed=0, n_blocks=4, rows=(5, 9)):
    """Seeded tabular blocks: f64, int64, f32 [n, 3] and one empty-ish
    spread of block sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        n = int(rng.integers(*rows))
        out.append({"x": rng.standard_normal(n),
                    "i": rng.integers(-50, 50, n).astype(np.int64),
                    "v": rng.standard_normal((n, 3)).astype(np.float32)})
    return out


# --- module-level UDFs: the same function object goes to both packages -----

def _mb_double(b):
    return {"x": b["x"] * 2.0, "i": b["i"] + 1, "v": b["v"] * np.float32(3)}


def _row_map(r):
    if isinstance(r, dict):
        return {"x": r["x"] - 1.0, "i": r["i"] * 2, "v": r["v"]}
    return r * 3


def _row_keep(r):
    return (r["i"] % 3 != 0) if isinstance(r, dict) else r % 2 == 0


def _row_flat(r):
    if isinstance(r, dict):
        return [r, {"x": -r["x"], "i": -r["i"], "v": r["v"]}]
    return [r, r + 100]


OPS = {"map_batches": _mb_double, "map": _row_map, "filter": _row_keep,
       "flat_map": _row_flat}


def _block_of(layout, seed):
    if layout == "dict":
        return _blocks(seed, 1)[0]
    return [int(v) for v in np.random.default_rng(seed).integers(0, 40, 11)]


# --- block functions ---------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(OPS))
@pytest.mark.parametrize("layout", ["dict", "list"])
def test_apply_op_matches(kind, layout):
    if kind == "map_batches" and layout == "list":
        fn = lambda b: [x + 1 for x in b]          # noqa: E731
    else:
        fn = OPS[kind]
    block = _block_of(layout, 1)
    got = port_ds._apply_op(copy.deepcopy(block), (kind, fn))
    with jax_reference() as ref:
        want = ref.dataset._apply_op(copy.deepcopy(block), (kind, fn))
    same(got, want)


def test_apply_op_rejects_unknown_kind_alike():
    with pytest.raises(ValueError, match="unknown op"):
        port_ds._apply_op({"x": np.zeros(2)}, ("nope", None))
    with jax_reference() as ref:
        with pytest.raises(ValueError, match="unknown op"):
            ref.dataset._apply_op({"x": np.zeros(2)}, ("nope", None))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_block_chain_matches(seed):
    ops = [("map_batches", _mb_double), ("filter", _row_keep),
           ("flat_map", _row_flat), ("map", _row_map)]
    for block in _blocks(seed, 3):
        got = port_ds._transform_block(copy.deepcopy(block), ops)
        with jax_reference() as ref:
            want = ref.dataset._transform_block(copy.deepcopy(block), ops)
        same(got, want)


@pytest.mark.parametrize("bs", [None, 1, 3, 7, 100])
def test_apply_rebatched_matches(bs):
    calls_port, calls_ref = [], []

    def fn(calls):
        def f(b):
            calls.append(port_ds._block_rows(b))
            return {"x": b["x"].cumsum(), "i": b["i"][::-1].copy(),
                    "v": b["v"]}
        return f

    block = _blocks(3, 1, rows=(10, 11))[0]
    got = port_ds._apply_rebatched(fn(calls_port), block, bs)
    with jax_reference() as ref:
        want = ref.dataset._apply_rebatched(fn(calls_ref), block, bs)
        empty = ref.dataset._apply_rebatched(fn(calls_ref), [], bs)
    same(got, want)
    assert calls_port == calls_ref
    same(port_ds._apply_rebatched(fn(calls_port), [], bs), empty)


@pytest.mark.parametrize("fmt", [None, "default", "numpy", "pandas",
                                 "pyarrow"])
@pytest.mark.parametrize("layout", ["dict", "list", "rows"])
def test_to_batch_format_matches(fmt, layout):
    if layout == "rows":
        block = [{"a": i, "b": float(i) / 3} for i in range(5)]
    else:
        block = _block_of(layout, 4)
    if layout == "dict":
        block = {"x": block["x"], "i": block["i"]}
    got = port_ds._to_batch_format(copy.deepcopy(block), fmt)
    with jax_reference() as ref:
        want = ref.dataset._to_batch_format(copy.deepcopy(block), fmt)
    same(got, want)


def test_to_batch_format_rejects_alike():
    with pytest.raises(ValueError, match="unsupported batch_format"):
        port_ds._to_batch_format({"x": np.zeros(2)}, "torch")
    with jax_reference() as ref:
        with pytest.raises(ValueError, match="unsupported batch_format"):
            ref.dataset._to_batch_format({"x": np.zeros(2)}, "torch")


@pytest.mark.parametrize("kind", ["dict", "list", "arrow", "pandas",
                                  "pandas_2d", "bad"])
def test_coerce_block_matches(kind):
    import pandas as pd
    import pyarrow as pa

    b = _blocks(5, 1)[0]
    out = {"dict": {"x": b["x"]}, "list": [1, 2, 3],
           "arrow": pa.table({"x": b["x"], "i": b["i"]}),
           "pandas": pd.DataFrame({"x": b["x"], "i": b["i"]}),
           "pandas_2d": port_ds._to_batch_format(b, "pandas"),
           "bad": 3.5}[kind]
    if kind == "bad":
        with pytest.raises(TypeError, match="unsupported type"):
            port_ds._coerce_block(out)
        with jax_reference() as ref:
            with pytest.raises(TypeError, match="unsupported type"):
                ref.dataset._coerce_block(out)
        return
    got = port_ds._coerce_block(out)
    with jax_reference() as ref:
        want = ref.dataset._coerce_block(out)
    same(got, want)


@pytest.mark.parametrize("layout", ["dict", "list"])
def test_block_slice_concat_rows_match(layout):
    blocks = ([_block_of("dict", s) for s in range(3)] if layout == "dict"
              else [_block_of("list", s) for s in range(3)])
    blocks.insert(1, [])                       # an emptied block
    with jax_reference() as ref:
        R = ref.dataset
        for fn in ("_block_rows", "_block_nbytes"):
            for b in blocks:
                same(getattr(port_ds, fn)(b), getattr(R, fn)(b))
        same(port_ds._block_concat(blocks), R._block_concat(blocks))
        same(port_ds._block_concat([[]]), R._block_concat([[]]))
        whole = port_ds._block_concat(blocks)
        for lo, hi in [(0, 0), (0, 3), (2, 9), (5, 1000)]:
            same(port_ds._block_slice(whole, lo, hi),
                 R._block_slice(whole, lo, hi))
        if layout == "dict":
            rows = port_ds._rows_of(whole)
            same(rows, R._rows_of(whole))
            same(port_ds._rows_to_block(rows), R._rows_to_block(rows))
        ragged = [{"a": [1, 2]}, {"a": [3]}]
        same(port_ds._rows_to_block(ragged), R._rows_to_block(ragged))
        same(port_ds._rows_to_block([4, 5]), R._rows_to_block([4, 5]))


# --- aggregates --------------------------------------------------------------

AGGS = {"count": ("Count", ()), "sum": ("Sum", ("x",)),
        "min": ("Min", ("x",)), "max": ("Max", ("x",)),
        "mean": ("Mean", ("x",)), "std": ("Std", ("x",)),
        "std_ddof0": ("Std", ("x", 0)), "std_i": ("Std", ("i",))}


@pytest.mark.parametrize("name", sorted(AGGS))
def test_aggregate_matches(name):
    cls, args = AGGS[name]
    blocks = _blocks(6, 5)
    for b in blocks:                    # a large mean stresses Std's merge
        b["x"] = b["x"] + 1e6
    cols = [b[args[0] if args else "x"] for b in blocks] + [np.zeros(0)]

    def run(mod):
        agg = getattr(mod, cls)(*args)
        parts = [agg.accumulate_block(agg.init(), c) for c in cols]
        acc = agg.init()
        for p in parts:
            acc = agg.merge(acc, p)
        return agg.name, parts, agg.finalize(acc)

    got = run(port_agg)
    with jax_reference() as ref:
        want = run(ref.aggregate)
    same(got, want)


# --- preprocessors -----------------------------------------------------------

def _pp_batch():
    rng = np.random.default_rng(7)
    n = 12
    x = rng.standard_normal(n) * 4
    x[[2, 7]] = np.nan
    return {"x": x, "y": rng.standard_normal(n),
            "z": rng.integers(-3, 9, n).astype(np.int64),
            "cat": np.asarray(["a", "b", "c", "b", "a", "d"] * 2),
            "tags": np.asarray([["p", "q"], ["q"], [], ["r", "p"]] * 3,
                               dtype=object),
            "text": np.asarray(["the cat sat", "a dog", "the the end",
                                "cat dog cat"] * 3)}


def _upper(df):
    df = df.copy()
    df["y"] = df["y"] * 10
    return df


# name -> (ctor args, ctor kwargs, fitted attributes, batch columns used)
PREPROCESSORS = {
    "Preprocessor": ((), {}, {}, None),
    "StandardScaler": ((["y", "z"],), {}, {
        "stats_": {"y": (0.25, 1.5), "z": (2.0, 3.0)}}, None),
    "MinMaxScaler": ((["y", "z"],), {}, {
        "stats_": {"y": (-2.0, 4.0), "z": (-3.0, 11.0)}}, None),
    "LabelEncoder": (("cat",), {}, {
        "classes_": np.asarray(["a", "b", "c", "d"])}, None),
    "OneHotEncoder": ((["cat"],), {}, {
        "classes_": {"cat": np.asarray(["a", "b", "c", "d"])}}, None),
    "SimpleImputer": ((["x"],), {}, {"stats_": {"x": 0.75}}, None),
    "SimpleImputer_constant": ((["x"],), {"strategy": "constant",
                                         "fill_value": -9.0}, {}, None),
    "Concatenator": ((["y", "z"],), {}, {}, None),
    "Chain": (None, {}, {}, None),
    "BatchMapper": ((_upper,), {"batch_format": "pandas"}, {},
                    ["x", "y", "z"]),
    "Normalizer": ((["y", "z"],), {"norm": "l1"}, {}, None),
    "Normalizer_l2": ((["y", "z"],), {}, {}, None),
    "Normalizer_max": ((["y", "z"],), {"norm": "max"}, {}, None),
    "MaxAbsScaler": ((["y", "z"],), {}, {"stats_": {"y": 2.5, "z": 8.0}},
                     None),
    "RobustScaler": ((["y"],), {}, {"stats_": {"y": (0.1, 1.3)}}, None),
    "PowerTransformer": ((["y"],), {"power": 0.5}, {}, None),
    "PowerTransformer_boxcox": ((["z"],), {"power": 0.0,
                                           "method": "box-cox"}, {}, None),
    "UniformKBinsDiscretizer": ((["y"],), {"bins": 4}, {
        "stats_": {"y": np.asarray([-1.0, 0.0, 1.0])}}, None),
    "CustomKBinsDiscretizer": ((["y"],), {"bins": [-5, -0.5, 0.5, 5]}, {},
                               None),
    "OrdinalEncoder": ((["cat"],), {}, {
        "stats_": {"cat": {"a": 0, "b": 1, "c": 2}}}, None),
    "MultiHotEncoder": ((["tags"],), {}, {
        "stats_": {"tags": {"p": 0, "q": 1, "r": 2}}}, None),
    "FeatureHasher": ((["cat", "z"],), {"num_features": 8}, {}, None),
    "Tokenizer": ((["text"],), {}, {}, None),
    "CountVectorizer": ((["text"],), {}, {
        "stats_": {"text": {"cat": 0, "dog": 1, "the": 2}}}, None),
}


def _make_pp(mod, name):
    args, kwargs, fitted, _ = PREPROCESSORS[name]
    cls = getattr(mod, name.split("_")[0] if name != "Preprocessor"
                  else name)
    if name == "Chain":
        return mod.Chain(_make_pp(mod, "SimpleImputer"),
                         _make_pp(mod, "StandardScaler"),
                         _make_pp(mod, "Concatenator"))
    p = cls(*args, **kwargs)
    for k, v in fitted.items():
        setattr(p, k, copy.deepcopy(v))
    return p


def test_every_preprocessor_class_is_held():
    classes = {n for n, v in vars(port_pp).items() if isinstance(v, type)
               and issubclass(v, port_pp.Preprocessor)}
    held = {n.split("_")[0] for n in PREPROCESSORS}
    assert len(classes) == 20 and classes == held


@pytest.mark.parametrize("name", sorted(PREPROCESSORS))
def test_preprocessor_transform_batch_matches(name):
    batch = _pp_batch()
    if name == "PowerTransformer_boxcox":
        batch["z"] = np.abs(batch["z"]) + 1
    cols = PREPROCESSORS[name][3]
    if cols:
        batch = {k: batch[k] for k in cols}
    if name == "Preprocessor":
        with pytest.raises(NotImplementedError):
            _make_pp(port_pp, name).transform_batch(batch)
        with jax_reference() as ref:
            with pytest.raises(NotImplementedError):
                _make_pp(ref.preprocessors, name).transform_batch(batch)
        return
    got = _make_pp(port_pp, name).transform_batch(copy.deepcopy(batch))
    with jax_reference() as ref:
        want = _make_pp(ref.preprocessors, name).transform_batch(
            copy.deepcopy(batch))
    same(got, want)


# --- the object-store paths: shuffles and iteration --------------------------

def _arrays(seed, n=61):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(n),
            "i": np.arange(n, dtype=np.int64),
            "v": rng.standard_normal((n, 3)).astype(np.float32)}


def _port_blocks(ds):
    return [ray_tpu_torch.get(r) for r in ds._block_refs]


@pytest.mark.parametrize("seed", [0, 11])
def test_random_shuffle_row_order_matches(cluster, seed):
    arrays = _arrays(seed)
    got = _port_blocks(port_ds.from_numpy(arrays, num_blocks=5)
                       .random_shuffle(seed=seed))
    with jax_reference() as ref, reference_store():
        want = ref.dataset.from_numpy(arrays, num_blocks=5).random_shuffle(
            seed=seed)._block_refs
    same(got, want)


@pytest.mark.parametrize("seed,bs,drop_last", [(3, 8, False), (4, 13, True),
                                               (5, 61, False)])
def test_iter_batches_local_shuffle_matches(cluster, seed, bs, drop_last):
    arrays = _arrays(seed)
    ds = port_ds.from_numpy(arrays, num_blocks=6)
    got = list(ds.iter_batches(batch_size=bs, drop_last=drop_last,
                               local_shuffle_seed=seed))
    with jax_reference() as ref, reference_store():
        rds = ref.dataset.from_numpy(arrays, num_blocks=6)
        want = list(ref.dataset.DataIterator(rds._block_refs, []).iter_batches(
            batch_size=bs, drop_last=drop_last, local_shuffle_seed=seed))
    same(got, want)


@pytest.mark.parametrize("policy", ["streaming", "fused", "compiled"])
def test_pipeline_matches_reference_blocks(cluster, policy):
    """map_batches -> filter -> random_shuffle(seed) -> iter_batches
    through the port's runtime under each execution policy, against the
    reference's block functions applied in process (its shuffle and
    iterator over identity refs). The UDFs are local, so workers get them
    by value."""
    def _mb_double(b):
        return {"x": b["x"] * 2.0, "i": b["i"] + 1,
                "v": b["v"] * np.float32(3)}

    def _keep_odd_i(r):
        return r["i"] % 2 == 1

    arrays = _arrays(21, n=97)
    ops = [("map_batches", _mb_double), ("filter", _keep_odd_i)]
    ctx = get_context()
    saved = ctx.execution_policy
    ctx.execution_policy = policy
    try:
        ds = (port_ds.from_numpy(arrays, num_blocks=7)
              .map_batches(_mb_double).filter(_keep_odd_i)
              .random_shuffle(seed=5))
        got = list(ds.iter_batches(batch_size=9, local_shuffle_seed=6))
    finally:
        ctx.execution_policy = saved
    with jax_reference() as ref, reference_store():
        R = ref.dataset
        src = R.from_numpy(arrays, num_blocks=7)._block_refs
        blocks = [R._transform_block(b, ops) for b in src]
        shuffled = R.Dataset(blocks, []).random_shuffle(seed=5)
        want = list(R.DataIterator(shuffled._block_refs, []).iter_batches(
            batch_size=9, local_shuffle_seed=6))
    same(got, want)


# --- the ResourceManager's admission -----------------------------------------

def _fake_pipeline(iface, spec):
    """A source and len(spec["ops"]) map operators whose queues, in-flight
    counts and finished-task metrics are spec's: the same states built
    from each package's PhysicalOperator. submit_next moves one input
    bundle into flight, as a map operator does."""

    class Op(iface.PhysicalOperator):
        budgetable = True

        def __init__(self, name, inp, st):
            super().__init__(name, inp, max_in_flight=st["max"])
            self._flight = st["flight"]
            self.metrics.tasks_finished = st["fin"]
            self.metrics.bytes_out = st["bout"]

        def num_in_flight(self):
            return self._flight

        def submit_next(self):
            self.input_op.output.popleft()
            self._flight += 1

    src = iface.PhysicalOperator("input", None)
    for j, nb in enumerate(spec["source"]):
        src.output.append(iface.RefBundle(j, iface.BlockMeta(nbytes=nb), j))
    ops = [src]
    for i, st in enumerate(spec["ops"]):
        op = Op(f"op{i}", ops[-1], st)
        for j, nb in enumerate(st["queued"]):
            op.output.append(iface.RefBundle(j, iface.BlockMeta(nbytes=nb),
                                             j))
        ops.append(op)
    return ops


def _random_spec(seed):
    rng = np.random.default_rng(seed)
    sizes = [None, 0, 1 << 10, 200 << 10, 1 << 20, 3 << 20]

    def nb():
        return sizes[int(rng.integers(len(sizes)))]

    ops = []
    for _ in range(int(rng.integers(1, 4))):
        mx = int(rng.integers(1, 5))
        fin = int(rng.integers(0, 4))
        ops.append({"max": mx, "flight": int(rng.integers(0, mx + 1)),
                    "fin": fin, "bout": fin * int(rng.integers(1, 3 << 20)),
                    "queued": [nb() for _ in range(int(rng.integers(0, 4)))]})
    budget = [None, 1, 512 << 10, 2 << 20, 8 << 20][int(rng.integers(5))]
    return {"source": [nb() for _ in range(int(rng.integers(0, 6)))],
            "ops": ops, "per_op": budget,
            "total": None if budget else int(rng.integers(1, 16 << 20))}


def _admission_trace(iface, rm_mod, spec, rounds=10):
    ops = _fake_pipeline(iface, spec)
    rm = rm_mod.ResourceManager(ops, total_budget_bytes=spec["total"],
                                per_op_budget_bytes=spec["per_op"])
    trace = [rm.per_op_budget]
    for _ in range(rounds):
        trace.append([(rm.est_output_bytes(op), rm.outqueue_usage(op),
                       rm.under_budget(op), op.can_submit()) for op in ops])
        chosen = rm.select_operator_to_run(ops)
        trace.append(None if chosen is None else ops.index(chosen))
        if chosen is None:
            break
        chosen.submit_next()
    return trace


@pytest.mark.parametrize("seed", range(12))
def test_resource_manager_admission_matches(seed):
    spec = _random_spec(seed)
    got = _admission_trace(port_if, port_rm, spec)
    with jax_reference() as ref:
        want = _admission_trace(ref.interfaces, ref.resource_manager, spec)
    assert got == want


def test_resource_manager_forces_an_idle_blocked_pipeline_alike():
    """Every candidate over a 1-byte budget and nothing in flight: both
    force the most downstream candidate (the liveness rule)."""
    spec = {"source": [4096, 4096],
            "ops": [{"max": 2, "flight": 0, "fin": 2, "bout": 8192,
                     "queued": [4096]},
                    {"max": 2, "flight": 0, "fin": 1, "bout": 4096,
                     "queued": [4096]}],
            "per_op": 1, "total": None}
    got = _admission_trace(port_if, port_rm, spec, rounds=1)
    with jax_reference() as ref:
        want = _admission_trace(ref.interfaces, ref.resource_manager, spec,
                                rounds=1)
    assert got == want and got[-1] == 2
