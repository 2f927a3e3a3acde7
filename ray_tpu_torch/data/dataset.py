"""Dataset: lazy plan over blocks, streaming per-operator execution.

Reference map (python/ray/data/):
  Dataset/logical plan        -> Dataset._ops list (dataset.py:385 map_batches)
  StreamingExecutor           -> ray_tpu_torch.data.execution: a physical operator
                                 graph scheduled task-by-task against output
                                 byte budgets (streaming_executor_state.py:376
                                 select_operator_to_run); multi-op chains
                                 route through it, single-op chains keep the
                                 legacy fused windowed-generator path (the
                                 `fused` policy)
  DataIterator / train ingest -> DataIterator.iter_batches / split();
                                 per-host shard feeds via iter_split()
                                 (OutputSplitter over ONE executor run)
  datasources                 -> read_parquet/csv/json via pyarrow

A copy of ``ray_tpu/data/dataset.py`` over the port's runtime. Blocks keep
the reference's types; the one change is at the device edge:
``DataIterator.iter_device_batches`` (the reference's double-buffered
``jax.device_put``) stages each batch in pinned host memory and copies it
to the card on a side stream, ordered by a CUDA event, so that batch i+1
copies while the step reads batch i.
"""

from __future__ import annotations

import builtins
import itertools
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Union)

import numpy as np

Block = Union[Dict[str, np.ndarray], list]

_DEFAULT_BLOCK_ROWS = 4096
_WINDOW = 4  # streaming shard tasks per iterator (execution parallelism)
_STREAM_AHEAD = 2  # blocks each shard executor may run ahead of consumption
_ADMISSION_FRACTION = 0.25  # share of the object store unconsumed blocks may hold


def _block_rows(b: Block) -> int:
    if isinstance(b, dict):
        return len(next(iter(b.values()))) if b else 0
    return len(b)


def _block_nbytes(b: Block) -> int:
    """Approximate in-memory bytes of a block — the unit the streaming
    executor's ResourceManager budgets (ref: BlockMetadata.size_bytes).
    Array columns are exact; object columns and list blocks estimate via
    per-item getsizeof."""
    import sys

    if isinstance(b, dict):
        total = 0
        for v in b.values():
            a = np.asarray(v)
            if a.dtype == object:
                total += int(sum(sys.getsizeof(x) for x in a.reshape(-1)))
            else:
                total += int(a.nbytes)
        return total
    if isinstance(b, list):
        return int(sum(sys.getsizeof(x) for x in b))
    return int(sys.getsizeof(b))


def _block_slice(b: Block, lo: int, hi: int) -> Block:
    if isinstance(b, dict):
        return {k: v[lo:hi] for k, v in b.items()}
    return b[lo:hi]


def _block_concat(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if _block_rows(b)]
    if not blocks:
        return []
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    out: list = []
    for b in blocks:
        out.extend(b)
    return out


def _arrow_to_block(table) -> Block:
    """Arrow table -> dict-of-numpy, ZERO-COPY per column when the type
    allows (numeric, single-chunk, no nulls — the same condition the
    reference's Arrow block accessor exploits for plasma reads); copies
    only the columns Arrow can't view (ref: data/_internal/arrow_block.py
    to_numpy path)."""
    out = {}
    for c in table.column_names:
        col = table[c]
        if col.num_chunks == 1:
            try:
                out[c] = col.chunk(0).to_numpy(zero_copy_only=True)
                continue
            except Exception:
                pass
        out[c] = col.to_numpy(zero_copy_only=False)
    return out


def _to_batch_format(block: Block, fmt: Optional[str]):
    """Present a block to a UDF in the requested format (ref:
    map_batches/iter_batches batch_format= in python/ray/data/dataset.py
    — "numpy"/"default" dict-of-ndarray, "pandas", "pyarrow")."""
    if fmt in (None, "default", "numpy"):
        return block
    if not isinstance(block, dict):
        block = _rows_to_block(block)
        if not isinstance(block, dict):
            block = {"value": np.asarray(block)}
    if fmt == "pandas":
        import pandas as pd

        return pd.DataFrame({k: (list(v) if getattr(v, "ndim", 1) > 1
                                 else v) for k, v in block.items()})
    if fmt == "pyarrow":
        import pyarrow as pa

        return pa.table({k: np.asarray(v) for k, v in block.items()})
    raise ValueError(f"unsupported batch_format {fmt!r}; "
                     "use 'numpy', 'pandas', or 'pyarrow'")


def _coerce_block(out) -> Block:
    """Normalize a UDF's return (dict / list / pa.Table / pd.DataFrame)
    back into a native block."""
    if isinstance(out, (dict, list)):
        return out
    mod = type(out).__module__
    if mod.startswith("pyarrow"):
        return _arrow_to_block(out)
    if mod.startswith("pandas"):
        cols = {}
        for c in out.columns:
            v = out[c].to_numpy()
            if v.dtype == object and len(v) and \
                    isinstance(v[0], np.ndarray):
                # 2-D column that rode through pandas as array-of-arrays
                # (see _to_batch_format's list(v) wrap) — restack it
                v = np.stack(v)
            cols[c] = v
        return cols
    raise TypeError(f"batch UDF returned unsupported type {type(out)}")


class _FormattedUDF:
    """Stateful-UDF wrapper adding batch_format conversion around a user
    class's __call__ (actor-pool map_batches with batch_format=)."""

    def __init__(self, cls, fmt, *args):
        self._inner = cls(*args)
        self._fmt = fmt

    def __call__(self, batch):
        return _coerce_block(self._inner(_to_batch_format(batch,
                                                          self._fmt)))


def _apply_op(block: Block, op: tuple) -> Block:
    kind, fn = op[0], op[1]
    if kind == "map_batches":
        # empty blocks skip the UDF on EVERY path: a fully-filtered
        # tabular block degrades to [] (schema lost), which a column-
        # addressing UDF cannot handle
        if _block_rows(block) == 0:
            return block
        return fn(block)
    if kind == "map":
        if isinstance(block, dict):
            rows = _rows_of(block)
            out = [fn(r) for r in rows]
            return _rows_to_block(out)
        return [fn(r) for r in block]
    if kind == "filter":
        if isinstance(block, dict):
            rows = _rows_of(block)
            out = [r for r in rows if fn(r)]
            return _rows_to_block(out)
        return [r for r in block if fn(r)]
    if kind == "flat_map":
        rows = _rows_of(block) if isinstance(block, dict) else block
        out: list = []
        for r in rows:
            out.extend(fn(r))
        return _rows_to_block(out) if isinstance(block, dict) else out
    raise ValueError(f"unknown op {kind}")


def _rows_of(block: Dict[str, np.ndarray]) -> List[dict]:
    keys = list(block.keys())
    n = _block_rows(block)
    return [{k: block[k][i] for k in keys} for i in builtins.range(n)]


def _rows_to_block(rows: List[Any]) -> Block:
    if rows and isinstance(rows[0], dict):
        keys = rows[0].keys()
        try:
            return {k: np.asarray([r[k] for r in rows]) for k in keys}
        except Exception:
            return rows
    return rows


def _transform_block(block: Block, ops: List[tuple]) -> Block:
    for op in ops:
        block = _apply_op(block, op)
    return block


def _apply_rebatched(fn, block: Block, bs: Optional[int]) -> Block:
    """Run fn over bs-row slices of the block and concat (shared by the
    task and actor-pool map_batches paths). Empty blocks (e.g. a filter
    matched nothing) skip the UDF — they also lose their column schema,
    so calling fn would hand it a bare list."""
    if _block_rows(block) == 0:
        return block
    if bs is None:
        return fn(block)
    n = _block_rows(block)
    outs = [fn(_block_slice(block, lo, min(lo + bs, n)))
            for lo in builtins.range(0, n, bs)]
    return _block_concat(outs)


class ActorPoolStrategy:
    """Stateful-actor compute for map_batches (ref: ActorPoolStrategy in
    data/_internal/compute.py). size actors each construct the UDF class
    once and stream blocks through it."""

    def __init__(self, size: int = 2, *, num_cpus_per_actor: float = 0.5,
                 min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        # min_size/max_size accepted for reference-API compatibility;
        # the pool is fixed-size (autoscaling pools are a later round)
        self.size = max_size or size
        self.num_cpus_per_actor = num_cpus_per_actor


class Dataset:
    """Immutable, lazy. Transformations append ops; execution happens on
    iteration/materialize via remote tasks over blocks. Exception:
    actor-pool map_batches stages (compute=ActorPoolStrategy / class
    UDFs) execute EAGERLY at call time — the pool's lifetime must bracket
    the pass (same shape as the reference's materialize-on-actor-pool
    paths)."""

    def __init__(self, block_refs: List[Any], ops: Optional[List[tuple]] = None):
        self._block_refs = block_refs
        self._ops = ops or []

    # ---- transformations (lazy) -------------------------------------------

    def map_batches(self, fn: Callable[[Block], Block], *,
                    batch_size: Optional[int] = None,
                    batch_format: Optional[str] = None,
                    compute: Optional["ActorPoolStrategy"] = None,
                    fn_constructor_args: tuple = ()) -> "Dataset":
        """batch_size re-slices each block before fn (ref: dataset.py:385
        map_batches(batch_size=...) — bounds the UDF's working set, e.g.
        a model's device batch). batch_format presents batches as
        "numpy" (default), "pandas", or "pyarrow" and accepts the same
        formats back (ref: map_batches(batch_format=...); Arrow
        conversion is zero-copy per column where types allow). A CLASS
        fn (or compute=ActorPoolStrategy(...)) runs on a pool of
        stateful actors so expensive setup — loading a model to the
        device — happens once per actor, not once per block (ref:
        _internal/execution/operators/actor_pool_map_operator.py)."""
        if batch_format not in (None, "default", "numpy",
                                "pandas", "pyarrow"):
            raise ValueError(f"unsupported batch_format {batch_format!r}; "
                             "use 'numpy', 'pandas', or 'pyarrow'")
        if batch_format not in (None, "default", "numpy"):
            fmt = batch_format
            if isinstance(fn, type):
                return self._map_batches_actors(
                    _FormattedUDF, batch_size,
                    compute or ActorPoolStrategy(),
                    (fn, fmt, *fn_constructor_args))
            user_fn = fn
            fn = lambda b: _coerce_block(user_fn(_to_batch_format(b, fmt)))
        if compute is not None or isinstance(fn, type):
            return self._map_batches_actors(
                fn, batch_size, compute or ActorPoolStrategy(),
                fn_constructor_args)
        if batch_size is None:
            return Dataset(self._block_refs,
                           self._ops + [("map_batches", fn)])
        return Dataset(
            self._block_refs,
            self._ops + [("map_batches",
                          lambda b: _apply_rebatched(fn, b, batch_size))])

    def _map_batches_actors(self, fn_cls, batch_size, strategy,
                            ctor_args) -> "Dataset":
        """Dispatch blocks over a pool of stateful map actors via the
        streaming executor's ActorPoolMapOperator; blocks travel as refs
        (never through the driver), dispatch/harvest ride the ordered
        ActorPool, and the pool is reaped at executor shutdown. Output
        block order matches input order."""
        from ray_tpu_torch.data.execution import (ActorPoolMapOperator,
                                                  InputDataBuffer,
                                                  ResourceManager,
                                                  StreamingExecutor, get_context)

        if not isinstance(fn_cls, type):
            raise TypeError(
                "compute=ActorPoolStrategy(...) needs a callable CLASS "
                "(stateful UDF with __call__), got a function")
        if not self._block_refs:
            return Dataset([], [])
        ctx = get_context()
        # pending lazy ops fuse INTO the actor (one hop per block, no
        # intermediate materialize through the store)
        n_actors = max(1, min(strategy.size, len(self._block_refs)))
        inp = InputDataBuffer(self._block_refs)
        op = ActorPoolMapOperator(
            "map_batches(actors)", fn_cls, tuple(ctor_args), n_actors,
            strategy.num_cpus_per_actor, batch_size,
            fused_ops=self._ops, input_op=inp)
        rm = ResourceManager([inp, op],
                             per_op_budget_bytes=ctx.per_op_budget_bytes)
        refs = StreamingExecutor([inp, op], rm).execute_to_refs()
        return Dataset(refs, [])

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return Dataset(self._block_refs, self._ops + [("map", fn)])

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        return Dataset(self._block_refs, self._ops + [("filter", fn)])

    def flat_map(self, fn: Callable[[Any], Iterable[Any]]) -> "Dataset":
        return Dataset(self._block_refs, self._ops + [("flat_map", fn)])

    # ---- execution ---------------------------------------------------------

    def _executed_refs(self) -> List[Any]:
        """Launch transform tasks for all blocks (full materialize path)."""
        import ray_tpu_torch

        if not self._ops:
            return list(self._block_refs)
        ops = self._ops

        @ray_tpu_torch.remote
        def _t(block):
            return _transform_block(block, ops)

        return [_t.remote(ref) for ref in self._block_refs]

    def materialize(self) -> "Dataset":
        import ray_tpu_torch

        from ray_tpu_torch.data.execution import build_pipeline, get_context

        pol = (get_context().resolve_policy(None, len(self._ops))
               if self._ops and self._block_refs else "fused")
        if pol in ("streaming", "compiled"):
            # budget-aware drain: transformed blocks land in the store in
            # source order; unconsumed bytes stay under the executor budget
            refs = build_pipeline(self._block_refs, self._ops,
                                  policy=pol).execute_to_refs()
            return Dataset(refs, [])
        refs = self._executed_refs()
        ray_tpu_torch.wait(refs, num_returns=len(refs))
        return Dataset(refs, [])

    def iter_split(self, n: int) -> List["Iterator[Block]"]:
        """n in-process block iterators fed by ONE streaming-executor run
        (OutputSplitter sink, round-robin bundles) — the per-host shape of
        train ingest: one pipeline per host feeding that host's local
        consumers, instead of n disjoint pipelines (ref:
        output_splitter.py behind streaming_split). Consumers should be
        drained roughly together; a shard nobody reads parks its bundles
        in its queue. For cross-process per-rank ingest, use
        streaming_split() — its iterators pickle."""
        import ray_tpu_torch

        from ray_tpu_torch.data.execution import build_pipeline

        if not self._block_refs:
            return [iter(()) for _ in builtins.range(n)]
        executor = build_pipeline(self._block_refs, self._ops, split=n)

        def _blocks(shard):
            for bundle in shard:
                yield ray_tpu_torch.get(bundle.block_ref)

        return [_blocks(s) for s in executor.execute_split(n)]

    def _iter_blocks(self, policy: Optional[str] = None) -> Iterator[Block]:
        """Streaming pull through one of two physical paths.

        `streaming` (default for chains of 2+ ops): the per-operator
        executor in ray_tpu_torch.data.execution — every logical op becomes an
        independently scheduled operator, and select_operator_to_run
        keeps each operator's unconsumed output under a store-derived
        byte budget, so a slow late stage throttles the early stages
        (ref: streaming_executor_state.py:376).

        `fused` (default for single-op chains): _WINDOW generator tasks
        each transform a strided shard of the blocks with the whole
        chain fused, consumer-coupled generator backpressure keeps every
        executor at most _STREAM_AHEAD blocks ahead of consumption
        (ref: streaming generators). Round-robin over strided shards
        restores original block order. Both paths yield identical
        blocks in identical order."""
        import ray_tpu_torch

        ops = self._ops
        if not ops:
            for ref in self._block_refs:
                yield ray_tpu_torch.get(ref)
            return
        refs = self._block_refs
        if not refs:
            return
        from ray_tpu_torch.data.execution import build_pipeline, get_context

        pol = get_context().resolve_policy(policy, len(ops))
        if pol in ("streaming", "compiled"):
            for bundle in build_pipeline(refs, ops, policy=pol).execute():
                yield ray_tpu_torch.get(bundle.block_ref)
            return
        w = min(_WINDOW, len(refs))
        # Admission by object-store byte budget, not just block count
        # (ref: streaming_executor_state.py select_operator_to_run): all
        # shards together may hold at most ~ADMISSION_FRACTION of the
        # store in unconsumed blocks, so huge blocks throttle production
        # instead of spill-thrashing a small store.
        from ray_tpu_torch.core import runtime as _rt

        r = _rt.current_runtime_or_none()
        store_budget = (r.cfg.object_store_memory if r is not None
                        else 2 << 30)
        frac = (r.cfg.data_execution_budget_fraction if r is not None
                else _ADMISSION_FRACTION)
        bp_bytes = max(1 << 20, int(store_budget * frac / w))

        @ray_tpu_torch.remote(num_returns="streaming",
                        generator_backpressure=_STREAM_AHEAD,
                        generator_backpressure_bytes=bp_bytes)
        def _shard_t(shard_refs, ops):
            for r in shard_refs:
                yield _transform_block(ray_tpu_torch.get(r), ops)

        active = [_shard_t.remote(refs[i::w], ops)
                  for i in builtins.range(w)]
        while active:
            exhausted = []
            for g in active:
                try:
                    ref = next(g)
                except StopIteration:
                    exhausted.append(g)
                    continue
                yield ray_tpu_torch.get(ref)
            for g in exhausted:
                active.remove(g)

    # ---- consumption -------------------------------------------------------

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for block in self._iter_blocks():
            rows = _rows_of(block) if isinstance(block, dict) else block
            out.extend(rows[:n - len(out)])
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for block in self._iter_blocks():
            out.extend(_rows_of(block) if isinstance(block, dict) else block)
        return out

    def count(self) -> int:
        import ray_tpu_torch

        if not self._ops:
            @ray_tpu_torch.remote
            def _n(b):
                return _block_rows(b)

            return sum(ray_tpu_torch.get([_n.remote(r) for r in self._block_refs]))
        return sum(_block_rows(b) for b in self._iter_blocks())

    def schema(self) -> Optional[List[str]]:
        for b in self._iter_blocks():
            if isinstance(b, dict):
                return list(b.keys())
            return None
        return None

    def columns(self) -> Optional[List[str]]:
        """Column names (ref: Dataset.columns — schema().names there)."""
        return self.schema()

    def take_batch(self, batch_size: int = 20,
                   batch_format: Optional[str] = None):
        """First up-to-batch_size rows as ONE batch (ref:
        Dataset.take_batch)."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format):
            return batch
        return _to_batch_format({}, batch_format)

    def iter_batches(self, *, batch_size: int = 256, drop_last: bool = False,
                     local_shuffle_seed: Optional[int] = None,
                     batch_format: Optional[str] = None):
        return DataIterator(self._block_refs, self._ops).iter_batches(
            batch_size=batch_size, drop_last=drop_last,
            local_shuffle_seed=local_shuffle_seed,
            batch_format=batch_format)

    def iter_torch_batches(self, **kw):
        return DataIterator(self._block_refs, self._ops).iter_torch_batches(
            **kw)

    def iter_rows(self) -> Iterator[Any]:
        for b in self._iter_blocks():
            yield from (_rows_of(b) if isinstance(b, dict) else b)

    # ---- reorganization ----------------------------------------------------

    def repartition(self, num_blocks: int) -> "Dataset":
        import ray_tpu_torch

        blocks = [b for b in self.materialize()._iter_blocks()]
        whole = _block_concat(blocks)
        n = _block_rows(whole)
        per = max(1, (n + num_blocks - 1) // num_blocks)
        refs = [ray_tpu_torch.put(_block_slice(whole, i * per, min((i + 1) * per, n)))
                for i in builtins.range(num_blocks) if i * per < n]
        return Dataset(refs, [])

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        import ray_tpu_torch

        rng = np.random.default_rng(seed)
        blocks = list(self.materialize()._iter_blocks())
        whole = _block_concat(blocks)
        n = _block_rows(whole)
        perm = rng.permutation(n)
        if isinstance(whole, dict):
            shuffled: Block = {k: v[perm] for k, v in whole.items()}
        else:
            shuffled = [whole[i] for i in perm]
        k = max(1, len(blocks))
        per = (n + k - 1) // k
        refs = [ray_tpu_torch.put(_block_slice(shuffled, i * per,
                                         min((i + 1) * per, n)))
                for i in builtins.range(k) if i * per < n]
        return Dataset(refs, [])

    def split(self, n: int) -> List["Dataset"]:
        """Block-granularity split (ref: dataset.split)."""
        parts: List[List[Any]] = [[] for _ in builtins.range(n)]
        for i, ref in enumerate(self._block_refs):
            parts[i % n].append(ref)
        return [Dataset(p, list(self._ops)) for p in parts]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        """Row-exact split at sorted global indices (ref:
        dataset.split_at_indices)."""
        import ray_tpu_torch

        if any(i < 0 for i in indices) or list(indices) != sorted(indices):
            raise ValueError(
                f"indices must be non-negative and sorted, got {indices}")
        whole = _block_concat(list(self._iter_blocks()))
        n = _block_rows(whole)
        bounds = [0] + [min(i, n) for i in indices] + [n]
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            out.append(Dataset([ray_tpu_torch.put(_block_slice(whole, lo, hi))],
                               []))
        return out

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> "tuple[Dataset, Dataset]":
        """(train, test) row split (ref: dataset.train_test_split)."""
        if not 0 < test_size < 1:
            raise ValueError("test_size must be in (0, 1)")
        # materialize once: count() + split would otherwise execute the
        # pending op pipeline twice (and disagree under nondeterminism)
        ds = (self.random_shuffle(seed=seed) if shuffle
              else self).materialize()
        n = ds.count()
        cut = n - int(n * test_size)
        train, test = ds.split_at_indices([cut])
        return train, test

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (ref: dataset.unique). Per-block
        np.unique runs in the transform tasks; only the small distinct
        sets reach the driver (same shape as preprocessors'
        _distributed_unique)."""
        def per_block(block):
            col = (block[column] if isinstance(block, dict)
                   else [r[column] for r in block])
            return {column: np.unique(np.asarray(col).reshape(-1))}

        seen: set = set()
        for block in self.map_batches(per_block)._iter_blocks():
            # blocks fully emptied by an upstream filter pass through
            # _apply_op untransformed as schemaless [] — nothing to add
            if _block_rows(block) == 0:
                continue
            for v in block[column]:
                seen.add(v.item() if hasattr(v, "item") else v)
        return sorted(seen)

    def show(self, limit: int = 20) -> None:
        """Print the first rows (ref: dataset.show)."""
        for r in self.take(limit):
            print(r)

    def streaming_split(self, n: int) -> List["DataIterator"]:
        """Per-rank iterators for train ingest (ref:
        stream_split_iterator.py)."""
        parts: List[List[Any]] = [[] for _ in builtins.range(n)]
        for i, ref in enumerate(self._block_refs):
            parts[i % n].append(ref)
        return [DataIterator(p, list(self._ops)) for p in parts]

    def groupby(self, key: str):
        """Two-stage distributed groupby (ref: dataset.groupby →
        grouped_data.py)."""
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sample-sort (ref: dataset.sort → sort exchange op in
        _internal/planner/exchange/sort_task_spec.py): sample keys to pick
        range boundaries, range-partition blocks in map tasks, sort each
        partition in reduce tasks."""
        import ray_tpu_torch

        ops = self._ops
        refs = self._block_refs
        if not refs:
            return Dataset([], [])
        P = max(1, len(refs))

        @ray_tpu_torch.remote
        def _sample(block):
            block = _transform_block(block, ops)
            if not isinstance(block, dict):
                block = _rows_to_block(block)
            if not isinstance(block, dict) or key not in block:
                return np.empty(0)   # block emptied by transforms
            col = np.asarray(block[key])
            if len(col) == 0:
                return col
            k = min(64, len(col))
            idx = np.random.default_rng(0).choice(len(col), size=k,
                                                  replace=False)
            return col[idx]

        sampled = [s for s in ray_tpu_torch.get([_sample.remote(r) for r in refs])
                   if len(s)]
        if not sampled:   # every block empty after transforms
            return self.materialize()
        samples = np.concatenate(sampled)
        samples.sort()
        bounds = [samples[int(len(samples) * (i + 1) / P)]
                  for i in builtins.range(P - 1)]

        @ray_tpu_torch.remote
        def _partition(block):
            block = _transform_block(block, ops)
            if not isinstance(block, dict):
                block = _rows_to_block(block)
            if not isinstance(block, dict) or key not in block:
                empty = {}
                return tuple(empty for _ in builtins.range(P)) \
                    if P > 1 else empty
            col = np.asarray(block[key])
            part_ids = np.searchsorted(np.asarray(bounds), col, side="right")
            out = []
            for p in builtins.range(P):
                idx = np.flatnonzero(part_ids == p)
                out.append({c: v[idx] for c, v in block.items()})
            return tuple(out) if P > 1 else out[0]

        @ray_tpu_torch.remote
        def _sort_part(*subs):
            whole = _block_concat([b for b in subs if _block_rows(b)])
            if not _block_rows(whole):
                return {}
            order = np.argsort(np.asarray(whole[key]), kind="stable")
            if descending:
                order = order[::-1]
            return {c: v[order] for c, v in whole.items()}

        part_refs = [_partition.options(num_returns=P).remote(r)
                     if P > 1 else [_partition.remote(r)] for r in refs]
        out_refs = [_sort_part.remote(*[pr[p] for pr in part_refs])
                    for p in builtins.range(P)]
        if descending:
            out_refs = out_refs[::-1]
        return Dataset(out_refs, [])

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of equal-length datasets (ref: dataset.zip).
        Blocks stay in the object store: per-output-block merge tasks pull
        only the row ranges they need from the right side."""
        import ray_tpu_torch

        a = self.materialize()
        b = other.materialize()

        @ray_tpu_torch.remote
        def _rows(block):
            return _block_rows(block)

        na = ray_tpu_torch.get([_rows.remote(r) for r in a._block_refs])
        nb = ray_tpu_torch.get([_rows.remote(r) for r in b._block_refs])
        if sum(na) != sum(nb):
            raise ValueError("zip requires equal row counts")

        @ray_tpu_torch.remote
        def _merge(left, lo, hi, *right_parts):
            """left block + the right-side row range [lo, hi) assembled
            from the overlapping right blocks."""
            right = _block_concat(list(right_parts))
            right = _block_slice(right, lo, hi)
            merged = dict(left) if isinstance(left, dict) else \
                {"_left": np.asarray(left)}
            rd = right if isinstance(right, dict) else \
                {"_right": np.asarray(right)}
            for c, v in rd.items():
                merged[c if c not in merged else f"{c}_1"] = v
            return merged

        # offsets of each right block in global row space
        b_starts = np.cumsum([0] + nb)
        out_refs = []
        pos = 0
        for ref, n in builtins.zip(a._block_refs, na):
            lo, hi = pos, pos + n
            # right blocks overlapping [lo, hi)
            first = int(np.searchsorted(b_starts, lo, side="right")) - 1
            last = int(np.searchsorted(b_starts, hi, side="left"))
            parts = b._block_refs[first:last]
            out_refs.append(_merge.remote(
                ref, lo - int(b_starts[first]),
                hi - int(b_starts[first]), *parts))
            pos = hi
        return Dataset(out_refs, [])

    def join(self, other: "Dataset", on: str, *, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join (ref: Dataset.join / join exchange op):
        hash-partition both sides on the key in map tasks, then one join
        task per partition pairs matching rows. Supports inner/left/right/
        outer; non-key columns colliding on name get a ``_1`` suffix on the
        right side, as the reference does."""
        import ray_tpu_torch

        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join type {how!r}")
        P = num_partitions or max(len(self._block_refs),
                                  len(other._block_refs), 1)

        def _hash_partition(ops, key):
            @ray_tpu_torch.remote
            def _part(block):
                block = _transform_block(block, ops)
                if not isinstance(block, dict):
                    block = _rows_to_block(block)
                if not isinstance(block, dict) or key not in block:
                    return tuple({} for _ in builtins.range(P)) \
                        if P > 1 else {}
                import zlib

                def _khash(v):
                    # crc32: stable across worker processes, unlike the
                    # salted builtin str hash. Integral floats normalize to
                    # int so 2 and 2.0 land in the same partition (they
                    # compare equal in the join task).
                    v = v.item() if hasattr(v, "item") else v
                    if isinstance(v, float) and v.is_integer():
                        v = int(v)
                    return zlib.crc32(str(v).encode()) % P

                col = np.asarray(block[key])
                pid = np.asarray([_khash(v) for v in col])
                out = []
                for p in builtins.range(P):
                    idx = np.flatnonzero(pid == p)
                    out.append({c: np.asarray(v)[idx]
                                for c, v in block.items()})
                return tuple(out) if P > 1 else out[0]

            return _part

        pa = _hash_partition(self._ops, on)
        pb = _hash_partition(other._ops, on)
        a_parts = [pa.options(num_returns=P).remote(r) if P > 1
                   else [pa.remote(r)] for r in self._block_refs]
        b_parts = [pb.options(num_returns=P).remote(r) if P > 1
                   else [pb.remote(r)] for r in other._block_refs]

        @ray_tpu_torch.remote
        def _join_part(na, nb, *subs):
            left = _block_concat([s for s in subs[:na] if _block_rows(s)])
            right = _block_concat([s for s in subs[na:] if _block_rows(s)])
            lrows = _rows_of(left) if isinstance(left, dict) else []
            rrows = _rows_of(right) if isinstance(right, dict) else []
            rindex: Dict[Any, List[dict]] = {}
            for r in rrows:
                rindex.setdefault(np.asarray(r[on]).item(), []).append(r)
            # Column sets come from every source block's partition output
            # (not just this partition's non-empty rows), so fill columns
            # are stable even when one side is empty in this partition.
            def _cols(ds):
                cols: List[str] = []
                for d in ds:
                    if isinstance(d, dict):
                        for c in d.keys():
                            if c not in cols:
                                cols.append(c)
                return cols

            lcols = _cols(subs[:na])
            rcols = _cols(subs[na:])
            matched_r = set()
            out_rows: List[dict] = []
            for lr in lrows:
                k = np.asarray(lr[on]).item()
                matches = rindex.get(k, [])
                if matches:
                    matched_r.add(k)
                    for rr in matches:
                        row = dict(lr)
                        for c in rcols:
                            if c == on:
                                continue
                            row[c if c not in row else f"{c}_1"] = rr[c]
                        out_rows.append(row)
                elif how in ("left", "outer"):
                    row = dict(lr)
                    for c in rcols:
                        if c == on:
                            continue
                        row.setdefault(c if c not in lr else f"{c}_1",
                                       np.nan)
                    out_rows.append(row)
            if how in ("right", "outer"):
                for rr in rrows:
                    if np.asarray(rr[on]).item() in matched_r:
                        continue
                    # key always survives, even when this partition saw no
                    # left rows (lcols empty)
                    row = {on: rr[on]}
                    for c in lcols:
                        if c != on:
                            row[c] = np.nan
                    for c in rcols:
                        if c == on:
                            continue
                        row[c if c not in row else f"{c}_1"] = rr[c]
                    out_rows.append(row)
            return _rows_to_block(out_rows) if out_rows else {}

        out_refs = []
        for p in builtins.range(P):
            subs = [ap[p] for ap in a_parts] + [bp[p] for bp in b_parts]
            out_refs.append(_join_part.remote(len(a_parts), len(b_parts),
                                              *subs))
        return Dataset(out_refs, [])

    def limit(self, n: int) -> "Dataset":
        rows = self.take(n)
        from ray_tpu_torch.data.dataset import _put_blocks

        return _put_blocks([_rows_to_block(rows)])

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]
                   ) -> "Dataset":
        def _add(block):
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out

        return self.map_batches(_add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        drop = set(cols)
        return self.map_batches(
            lambda b: {c: v for c, v in b.items() if c not in drop})

    def select_columns(self, cols: List[str]) -> "Dataset":
        keep = list(cols)
        return self.map_batches(lambda b: {c: b[c] for c in keep})

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(c, c): v for c, v in b.items()})

    # ---- global aggregates -------------------------------------------------

    def _global_agg(self, agg) -> Any:
        import ray_tpu_torch

        ops = self._ops

        @ray_tpu_torch.remote
        def _partial(block):
            block = _transform_block(block, ops)
            if not isinstance(block, dict):
                col = np.asarray(block)
            else:
                col = np.asarray(block[agg.on]) if getattr(agg, "on", None) \
                    else next(iter(block.values()))
            return agg.accumulate_block(agg.init(), col)

        partials = ray_tpu_torch.get(
            [_partial.remote(r) for r in self._block_refs])
        acc = agg.init()
        for p in partials:
            acc = agg.merge(acc, p)
        return agg.finalize(acc)

    def sum(self, on: str):
        from ray_tpu_torch.data.aggregate import Sum

        return self._global_agg(Sum(on))

    def min(self, on: str):
        from ray_tpu_torch.data.aggregate import Min

        return self._global_agg(Min(on))

    def max(self, on: str):
        from ray_tpu_torch.data.aggregate import Max

        return self._global_agg(Max(on))

    def mean(self, on: str):
        from ray_tpu_torch.data.aggregate import Mean

        return self._global_agg(Mean(on))

    def std(self, on: str, ddof: int = 1):
        from ray_tpu_torch.data.aggregate import Std

        return self._global_agg(Std(on, ddof))

    def union(self, other: "Dataset") -> "Dataset":
        if self._ops or other._ops:
            a = self.materialize()
            b = other.materialize()
            return Dataset(a._block_refs + b._block_refs, [])
        return Dataset(self._block_refs + other._block_refs, [])

    # ---- output ------------------------------------------------------------

    def _write_files(self, path: str, ext: str, write_one) -> List[str]:
        """One write task per block → part-NNNNN.<ext> under `path`
        (ref: Dataset.write_parquet et al., file-per-block layout)."""
        import os

        import ray_tpu_torch

        os.makedirs(path, exist_ok=True)
        ops = self._ops

        @ray_tpu_torch.remote
        def _w(block, out_path):
            block = _transform_block(block, ops)
            if not isinstance(block, dict):
                block = _rows_to_block(block)
            if not isinstance(block, dict):
                block = {"value": np.asarray(block)}
            write_one(block, out_path)
            return out_path

        refs = [_w.remote(ref, os.path.join(path, f"part-{i:05d}.{ext}"))
                for i, ref in enumerate(self._block_refs)]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> List[str]:
        def _one(block, out):
            import pyarrow as pa
            import pyarrow.parquet as pq

            pq.write_table(pa.table(block), out)

        return self._write_files(path, "parquet", _one)

    def write_csv(self, path: str) -> List[str]:
        def _one(block, out):
            import pyarrow as pa
            import pyarrow.csv as pc

            pc.write_csv(pa.table(block), out)

        return self._write_files(path, "csv", _one)

    def write_json(self, path: str) -> List[str]:
        def _one(block, out):
            import json as _json

            rows = _rows_of(block)
            with open(out, "w") as f:
                for r in rows:
                    f.write(_json.dumps(
                        {k: (v.item() if isinstance(v, np.generic)
                             else v.tolist() if isinstance(v, np.ndarray)
                             else v) for k, v in r.items()}) + "\n")

        return self._write_files(path, "json", _one)

    def to_pandas(self):
        import pandas as pd

        blocks = [b for b in self._iter_blocks() if _block_rows(b)]
        if not blocks:
            return pd.DataFrame()
        whole = _block_concat(blocks)
        if not isinstance(whole, dict):
            whole = _rows_to_block(whole)
            if not isinstance(whole, dict):
                whole = {"value": np.asarray(whole)}
        return pd.DataFrame(
            {k: list(v) if getattr(v, "ndim", 1) > 1 else v
             for k, v in whole.items()})

    def to_arrow(self):
        import pyarrow as pa

        whole = _block_concat(list(self._iter_blocks()))
        if not isinstance(whole, dict):
            whole = _rows_to_block(whole)
        return pa.table(whole)

    def stats(self) -> str:
        """Execution summary (ref: Dataset.stats())."""
        import ray_tpu_torch

        @ray_tpu_torch.remote
        def _n(b):
            return _block_rows(b)

        rows = ray_tpu_torch.get([_n.remote(r) for r in self._block_refs])
        total = sum(rows)
        # Counts describe the stored source blocks; pending lazy ops (which
        # may change row counts, e.g. filter) run at materialization.
        kind = "source rows" if self._ops else "rows"
        return (f"Dataset: {len(self._block_refs)} blocks, {total} {kind} "
                f"(min {min(rows) if rows else 0} / "
                f"max {max(rows) if rows else 0} rows/block), "
                f"pending ops: {[o[0] for o in self._ops]}")

    def num_blocks(self) -> int:
        return len(self._block_refs)

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._block_refs)}, "
                f"ops={[o[0] for o in self._ops]})")


class DataIterator:
    """Picklable per-rank iterator: holds block refs + pending ops and pulls
    through `_iter_blocks` in the consumer process — i.e. multi-op train
    ingest rides the streaming executor on each rank automatically
    (ref: DataIterator, iterator.py; train ingest session.py:901)."""

    def __init__(self, block_refs: List[Any], ops: List[tuple]):
        self._block_refs = block_refs
        self._ops = ops

    def __reduce__(self):
        return (DataIterator, (self._block_refs, self._ops))

    def _dataset(self) -> Dataset:
        return Dataset(self._block_refs, self._ops)

    def iter_batches(self, *, batch_size: int = 256, drop_last: bool = False,
                     local_shuffle_seed: Optional[int] = None,
                     batch_format: Optional[str] = None):
        rng = (np.random.default_rng(local_shuffle_seed)
               if local_shuffle_seed is not None else None)
        buf: List[Block] = []
        rows_in_buf = 0
        for block in self._dataset()._iter_blocks():
            buf.append(block)
            rows_in_buf += _block_rows(block)
            while rows_in_buf >= batch_size:
                whole = _block_concat(buf)
                if rng is not None:
                    n = _block_rows(whole)
                    perm = rng.permutation(n)
                    if isinstance(whole, dict):
                        whole = {k: v[perm] for k, v in whole.items()}
                    else:
                        whole = [whole[i] for i in perm]
                batch = _block_slice(whole, 0, batch_size)
                rest = _block_slice(whole, batch_size, _block_rows(whole))
                buf = [rest]
                rows_in_buf = _block_rows(rest)
                yield _to_batch_format(batch, batch_format)
        if rows_in_buf and not drop_last:
            yield _to_batch_format(_block_concat(buf), batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           local_shuffle_seed: Optional[int] = None,
                           dtypes=None, device=None):
        """Batches as torch tensors (ref: iterator.py iter_torch_batches,
        the reference's torch-ingest path): host tensors unless `device`
        is given. Tabular blocks become {col: tensor}; list blocks become
        a tensor when rows are numeric. For a feed that overlaps the copy
        to the card with the step, use ``iter_device_batches``."""
        import torch

        def to_t(v, col=None):
            t = torch.as_tensor(np.asarray(v))
            dt = dtypes.get(col) if isinstance(dtypes, dict) else dtypes
            if dt is not None:
                t = t.to(dt)
            if device is not None:
                t = t.to(device)
            return t

        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last,
                                       local_shuffle_seed=local_shuffle_seed):
            if isinstance(batch, dict):
                yield {k: to_t(v, k) for k, v in batch.items()}
            else:
                yield to_t(batch)

    def iter_device_batches(self, *, batch_size: int, sharding=None,
                            drop_last: bool = True, device=None):
        """Double-buffered device feed: batch i+1's copy is issued before
        batch i is yielded, so it copies while the step consumes batch i
        (the reference's double-buffered ``jax.device_put``, SURVEY.md §7.7
        device-side prefetch). The same batches in the same order as
        ``iter_batches``, each column a tensor on `device`: None means the
        current CUDA device and raises without CUDA; "cpu" runs only when
        asked, with no pinning and no streams.

        On the card (``_DeviceFeed``) each numeric column is written into
        a pinned host staging buffer, one of a ring of two per column, and
        copied with ``non_blocking=True`` on a dedicated copy stream, which
        then records an event. A staging buffer is refilled only once the
        event of the copy that read it has completed. Before a batch is
        yielded, the consumer's current stream waits on its event and each
        of its tensors is recorded on that stream, so the caching
        allocator does not reuse their memory while the step still reads
        them. `sharding` (the port's ``parallel.sharding.NamedSharding``,
        one for every column) makes each column a DTensor: only this
        rank's shard is staged and copied. A column that is not numeric
        raises TypeError naming it, as ``jax.device_put`` rejects it."""
        import ray_tpu_torch

        feed = _DeviceFeed(ray_tpu_torch.resolve_device(device), sharding)
        prev = None
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            cur = feed.put(batch)
            if prev is not None:
                yield feed.ready(prev)
            prev = cur
        if prev is not None:
            yield feed.ready(prev)


class _DeviceFeed:
    """The staging of ``DataIterator.iter_device_batches`` for one
    iteration: ``put`` issues a batch's copy, ``ready`` hands it to the
    consumer's stream."""

    def __init__(self, device, sharding=None):
        import torch

        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.cuda = device.type == "cuda"
        self.sharding = sharding
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._staging: List[Dict[Any, Any]] = [{}, {}]  # ring slot -> col -> pinned
        self._copied: List[Any] = [None, None]  # ring slot -> its last copy's event
        self._puts = 0

    def _host(self, name, v) -> np.ndarray:
        """A column as numpy, cut to this rank's shard under `sharding`."""
        a = np.asarray(v)
        if a.dtype.kind not in "biufc":
            raise TypeError(
                f"iter_device_batches: column {name!r} has dtype "
                f"{a.dtype}, which has no tensor type; drop it or map it "
                "to numbers first")
        if self.sharding is None:
            return a
        from torch.distributed.tensor import Shard

        from ray_tpu_torch.parallel.sharding import check_divisible

        mesh = self.sharding.mesh
        check_divisible(a.shape, self.sharding.spec, mesh,
                        f"column {name!r}")
        coord = mesh.get_coordinate()
        for i, p in enumerate(self.sharding.placements):
            if isinstance(p, Shard):
                n = a.shape[p.dim] // int(mesh.size(i))
                idx = [slice(None)] * a.ndim
                idx[p.dim] = slice(coord[i] * n, (coord[i] + 1) * n)
                a = a[tuple(idx)]
        return a

    def put(self, batch):
        """Issue the copy of one batch; returns what ``ready`` takes."""
        import torch

        named = isinstance(batch, dict)
        cols = batch.items() if named else [(None, batch)]
        full = {k: np.shape(v) for k, v in cols}
        host = {k: self._host(k, v) for k, v in cols}
        if not self.cuda:
            out = {k: torch.from_numpy(np.array(a)).to(self.device)
                   for k, a in host.items()}
            return named, out, None, full
        slot = self._puts % 2
        self._puts += 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        staging = self._staging[slot]
        for k, a in host.items():
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            buf = staging.get(k)
            if buf is None or buf.shape != a.shape or buf.dtype != dtype:
                buf = torch.empty(a.shape, dtype=dtype, pin_memory=True)
                staging[k] = buf
            np.copyto(buf.numpy(), a, casting="no")
        with torch.cuda.stream(self.stream):
            out = {k: staging[k].to(self.device, non_blocking=True)
                   for k in host}
            event = torch.cuda.Event()
            event.record(self.stream)
        self._copied[slot] = event
        return named, out, event, full

    def ready(self, item):
        """The batch `put` issued, safe to read on the consumer's current
        stream."""
        import torch

        named, out, event, full = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        if self.sharding is not None:
            from torch.distributed.tensor import DTensor

            from ray_tpu_torch.parallel.sharding import contiguous_stride

            out = {k: DTensor.from_local(
                t, self.sharding.mesh, self.sharding.placements,
                run_check=False, shape=torch.Size(full[k]),
                stride=contiguous_stride(full[k])) for k, t in out.items()}
        return out if named else out[None]


# --- creation ---------------------------------------------------------------


def _put_blocks(blocks: List[Block]) -> Dataset:
    import ray_tpu_torch

    return Dataset([ray_tpu_torch.put(b) for b in blocks], [])


def range(n: int, *, num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    k = num_blocks or max(1, min(64, n // _DEFAULT_BLOCK_ROWS or 1))
    per = (n + k - 1) // k
    blocks = []
    i = 0
    while i * per < n:
        blocks.append({"id": np.arange(i * per, min((i + 1) * per, n))})
        i += 1
    return _put_blocks(blocks)


def from_items(items: Sequence[Any], *, num_blocks: int = 8) -> Dataset:
    items = list(items)
    k = max(1, min(num_blocks, len(items) or 1))
    per = (len(items) + k - 1) // k
    blocks = []
    i = 0
    while i * per < len(items):
        blocks.append(items[i * per:(i + 1) * per])
        i += 1
    return _put_blocks([_rows_to_block(b) for b in blocks])


def from_numpy(arrays: Dict[str, np.ndarray], *, num_blocks: int = 8) -> Dataset:
    n = len(next(iter(arrays.values())))
    k = max(1, min(num_blocks, n))
    per = (n + k - 1) // k
    blocks = []
    i = 0
    while i * per < n:
        blocks.append({key: v[i * per:(i + 1) * per]
                       for key, v in arrays.items()})
        i += 1
    return _put_blocks(blocks)


def from_pandas(df, *, num_blocks: int = 8) -> Dataset:
    return from_numpy({c: df[c].to_numpy() for c in df.columns},
                      num_blocks=num_blocks)


def _read_files(paths, reader) -> Dataset:
    import glob as _glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(_glob.glob(os.path.join(p, "*"))))
        else:
            files.extend(sorted(_glob.glob(p)) or [p])
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _read(path: str):
        return reader(path)

    return Dataset([_read.remote(f) for f in files], [])


def read_parquet(paths) -> Dataset:
    def reader(path):
        import pyarrow.parquet as pq

        t = pq.read_table(path)
        return _arrow_to_block(t)

    return _read_files(paths, reader)


def read_csv(paths) -> Dataset:
    def reader(path):
        import pyarrow.csv as pc

        t = pc.read_csv(path)
        return _arrow_to_block(t)

    return _read_files(paths, reader)


def read_json(paths) -> Dataset:
    def reader(path):
        import pyarrow.json as pj

        t = pj.read_json(path)
        return _arrow_to_block(t)

    return _read_files(paths, reader)


def read_text(paths) -> Dataset:
    """One row per line: {"text": str} (ref: read_api.read_text)."""
    def reader(path):
        with open(path, "r", errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": np.asarray(lines, dtype=object)}

    return _read_files(paths, reader)


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """One row per file: {"bytes": ...} (ref: read_api.read_binary_files)."""
    def reader(path):
        with open(path, "rb") as f:
            data = f.read()
        row = {"bytes": np.asarray([data], dtype=object)}
        if include_paths:
            row["path"] = np.asarray([path], dtype=object)
        return row

    return _read_files(paths, reader)


def read_images(paths, *, size=None, mode: Optional[str] = None) -> Dataset:
    """Decode images with PIL into {"image": HxWxC uint8}
    (ref: datasource/image_datasource.py)."""
    def reader(path):
        from PIL import Image

        im = Image.open(path)
        if mode:
            im = im.convert(mode)
        if size:
            im = im.resize(tuple(size))
        arr = np.asarray(im)
        return {"image": arr[None, ...]}

    return _read_files(paths, reader)


def _parse_tfrecord_example(buf: bytes) -> Dict[str, Any]:
    """Minimal protobuf wire parse of tf.train.Example — enough to round-trip
    Int64List/FloatList/BytesList features without a TF dependency
    (ref: datasource/tfrecords_datasource.py, which uses tf.train.Example)."""
    import struct

    def varint(b, i):
        x = s = 0
        while True:
            c = b[i]
            x |= (c & 0x7F) << s
            i += 1
            if not c & 0x80:
                return x, i
            s += 7

    def fields(b):
        i = 0
        while i < len(b):
            tag, i = varint(b, i)
            fnum, wt = tag >> 3, tag & 7
            if wt == 0:
                v, i = varint(b, i)
            elif wt == 2:
                ln, i = varint(b, i)
                v = b[i:i + ln]
                i += ln
            elif wt == 5:
                v = b[i:i + 4]
                i += 4
            elif wt == 1:
                v = b[i:i + 8]
                i += 8
            else:
                raise ValueError(f"wire type {wt}")
            yield fnum, wt, v

    out: Dict[str, Any] = {}
    for fnum, _, features in fields(buf):     # Example.features = 1
        if fnum != 1:
            continue
        for fn2, _, entry in fields(features):  # Features.feature = 1 (map)
            if fn2 != 1:
                continue
            key, feat = None, b""
            for fn3, _, v in fields(entry):
                if fn3 == 1:
                    key = v.decode()
                elif fn3 == 2:
                    feat = v
            if key is None:
                continue
            for fn4, wt4, flist in fields(feat):  # Feature oneof
                vals: List[Any] = []
                for fn5, wt5, v in fields(flist):  # *List.value = 1
                    if fn5 != 1:
                        continue
                    if fn4 == 1:                 # BytesList
                        vals.append(v)
                    elif fn4 == 2:               # FloatList
                        if wt5 == 2:             # packed
                            vals.extend(struct.unpack(
                                f"<{len(v) // 4}f", v))
                        else:
                            vals.append(struct.unpack("<f", v)[0])
                    elif fn4 == 3:               # Int64List
                        def _signed(x):
                            # proto int64 negatives arrive as 10-byte
                            # varints; fold back to two's complement
                            return x - (1 << 64) if x >= 1 << 63 else x

                        if wt5 == 2:             # packed varints
                            j = 0
                            while j < len(v):
                                x, j = varint(v, j)
                                vals.append(_signed(x))
                        else:
                            vals.append(_signed(v))
                out[key] = vals[0] if len(vals) == 1 else vals
    return out


def read_tfrecords(paths) -> Dataset:
    """TFRecord container framing is public and simple: per record
    {u64 length, u32 masked-crc(length), bytes, u32 masked-crc(data)};
    payloads are tf.train.Example protos parsed by the wire-level reader
    above. CRCs are not verified (matches the reference's default)."""
    def reader(path):
        import struct

        rows: List[dict] = []
        with open(path, "rb") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                (length,) = struct.unpack("<Q", hdr)
                f.read(4)
                data = f.read(length)
                if len(data) < length:
                    raise ValueError(
                        f"truncated TFRecord in {path}: record claims "
                        f"{length} bytes, file ends after {len(data)}")
                f.read(4)
                rows.append(_parse_tfrecord_example(data))
        return _rows_to_block(rows)

    return _read_files(paths, reader)


def from_arrow(table, *, num_blocks: int = 8) -> Dataset:
    """Arrow table -> Dataset; numeric columns become zero-copy numpy
    views over the Arrow buffers (ref: from_arrow in read_api.py; the
    copy happens only at the object-store put, as in the reference)."""
    return from_numpy(_arrow_to_block(table), num_blocks=num_blocks)


def read_sql(sql: str, connection_factory, *,
             parallelism: int = 1) -> Dataset:
    """Read query results into a Dataset (ref: datasource/sql_datasource.py
    — any DBAPI2 connection factory; sqlite3 in-image, client libraries
    for other engines plug in the same way). `parallelism` splits with
    LIMIT/OFFSET pagination when > 1 (same strategy as the reference)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _query(page: Optional[Tuple[int, int]]):
        conn = connection_factory()
        try:
            cur = conn.cursor()
            if page is None:
                cur.execute(sql)
            else:
                # integers inlined (no driver paramstyle dependency) and
                # the derived table aliased (PostgreSQL/MySQL require it)
                off, lim = int(page[0]), int(page[1])
                cur.execute(f"SELECT * FROM ({sql}) AS _rt_page "
                            f"LIMIT {lim} OFFSET {off}")
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return {c: np.asarray([r[i] for r in rows])
                for i, c in enumerate(cols)}

    if parallelism <= 1:
        refs = [_query.remote(None)]
    else:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT COUNT(*) FROM ({sql}) AS _rt_count")
            (total,) = cur.fetchone()
        finally:
            conn.close()
        per = max((total + parallelism - 1) // parallelism, 1)
        refs = [_query.remote((off, per))
                for off in builtins.range(0, max(total, 1), per)]
    return Dataset(refs, [])


def write_sql(ds: "Dataset", table: str, connection_factory,
              *, if_exists: str = "append") -> int:
    """Write a Dataset into a DBAPI2 table; returns rows written
    (ref: Dataset.write_sql)."""
    import ray_tpu_torch

    total = 0
    blocks = ray_tpu_torch.get(ds._executed_refs())
    conn = connection_factory()
    try:
        cur = conn.cursor()
        first = True
        for block in blocks:
            if not isinstance(block, dict):
                block = _rows_to_block(block)
            if not isinstance(block, dict) or not block:
                continue  # block emptied by transforms
            cols = list(block)
            n = len(block[cols[0]])
            if n == 0:
                continue
            if first and if_exists == "replace":
                cur.execute(f"DROP TABLE IF EXISTS {table}")
            if first:
                decls = ", ".join(f'"{c}"' for c in cols)
                cur.execute(
                    f"CREATE TABLE IF NOT EXISTS {table} ({decls})")
                first = False
            ph = ", ".join("?" * len(cols))
            rows = [tuple(_py_scalar(block[c][i]) for c in cols)
                    for i in builtins.range(n)]
            cur.executemany(f"INSERT INTO {table} VALUES ({ph})", rows)
            total += n
        conn.commit()
    finally:
        conn.close()
    return total


def _py_scalar(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def read_webdataset(paths) -> Dataset:
    """WebDataset-style tar shards: files grouped by basename stem, one
    row per sample keyed by extension (ref: datasource/webdataset_datasource.py;
    the format itself is just POSIX tar, stdlib-readable)."""
    def reader(path):
        import tarfile

        samples: Dict[str, dict] = {}
        order: List[str] = []
        with tarfile.open(path, "r") as tf:
            for m in tf.getmembers():
                if not m.isfile():
                    continue
                stem, _, ext = m.name.partition(".")
                if stem not in samples:
                    samples[stem] = {"__key__": stem}
                    order.append(stem)
                data = tf.extractfile(m).read()
                if ext in ("txt", "cls", "json"):
                    data = data.decode("utf-8", errors="replace")
                    if ext == "json":
                        import json as _json

                        data = _json.loads(data)
                samples[stem][ext] = data
        return _rows_to_block([samples[k] for k in order])

    return _read_files(paths, reader)


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[dict]] = None,
               parallelism: int = 1) -> Dataset:
    """Read a MongoDB collection (ref: datasource/mongo_datasource.py —
    pymongo there too; parallel reads partition on `_id` ranges).
    Gated: pymongo is an optional dependency."""
    try:
        import pymongo  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_mongo needs the pymongo package, which is not "
            "installed; install it in your driver/worker environment"
        ) from e
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _read(shard: int):
        import pymongo

        client = pymongo.MongoClient(uri)
        coll = client[database][collection]
        stages = list(pipeline or [])
        if parallelism > 1:
            # shard on a hash of _id (works for ObjectId AND scalar _id
            # types; a timestamp-derived key would be second-granular —
            # every ObjectId's ms value is a multiple of 1000, starving
            # shards whenever parallelism shares a factor with 1000)
            stages.insert(0, {"$match": {"$expr": {"$eq": [
                {"$mod": [{"$abs": {"$toHashedIndexKey": "$_id"}},
                          parallelism]}, shard]}}})
        rows = []
        for doc in coll.aggregate(stages) if stages else coll.find():
            doc.pop("_id", None)
            rows.append(doc)
        client.close()
        return _rows_to_block(rows)

    return Dataset([_read.remote(i) for i in builtins.range(parallelism)],
                   [])


def read_bigquery(query: str, *, project: Optional[str] = None) -> Dataset:
    """Read BigQuery results (ref: datasource/bigquery_datasource.py).
    Gated: google-cloud-bigquery is an optional dependency."""
    try:
        from google.cloud import bigquery  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_bigquery needs the google-cloud-bigquery package, "
            "which is not installed; install it in your driver "
            "environment") from e
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _read():
        from google.cloud import bigquery as bq

        client = bq.Client(project=project)
        table = client.query(query).to_arrow()
        return _arrow_to_block(table)

    return Dataset([_read.remote()], [])
