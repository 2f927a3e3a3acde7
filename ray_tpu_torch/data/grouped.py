"""GroupedData: two-stage distributed groupby.

Reference: python/ray/data/grouped_data.py + the map/reduce exchange in
_internal/planner/exchange/ — stage 1 runs per-block partial aggregation
(or hash partitioning for map_groups) as parallel tasks; stage 2 merges
partials (aggregate) or applies the UDF per key partition (map_groups).

A copy of ``ray_tpu/data/grouped.py`` over the port's runtime
(``ray_tpu_torch.remote``/``get``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ray_tpu_torch.data.aggregate import (AggregateFn, Count, Max, Mean, Min, Std,
                                          Sum)


def _stable_hash(k) -> int:
    """Process-independent key hash (built-in str hash is seeded per
    process, which would scatter one key across reduce partitions)."""
    import zlib

    return zlib.crc32(repr(k).encode())


def _group_indices(keycol: np.ndarray) -> Dict[Any, np.ndarray]:
    order = np.argsort(keycol, kind="stable")
    skeys = keycol[order]
    bounds = np.flatnonzero(skeys[1:] != skeys[:-1]) + 1
    splits = np.split(order, bounds)
    # each split holds indices into the ORIGINAL keycol
    return {keycol[s[0]]: s for s in splits if len(s)}


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    # ---- aggregate ---------------------------------------------------------

    def aggregate(self, *aggs: AggregateFn):
        """Returns a Dataset of one row per key with aggregate columns."""
        import ray_tpu_torch
        from ray_tpu_torch.data import dataset as D

        key = self._key
        ops = self._ds._ops

        @ray_tpu_torch.remote
        def _partial(block):
            block = D._transform_block(block, ops)
            if not isinstance(block, dict):
                block = D._rows_to_block(block)
            if not isinstance(block, dict) or key not in block:
                return {}
            keycol = np.asarray(block[key])
            out: Dict[Any, list] = {}
            for k, idx in _group_indices(keycol).items():
                states = []
                for agg in aggs:
                    col = block[agg.on][idx] if getattr(agg, "on", None) \
                        else keycol[idx]
                    states.append(agg.accumulate_block(agg.init(), col))
                out[k] = states
            return out

        partials = ray_tpu_torch.get(
            [_partial.remote(r) for r in self._ds._block_refs])
        merged: Dict[Any, list] = {}
        for p in partials:
            for k, states in p.items():
                if k not in merged:
                    merged[k] = states
                else:
                    merged[k] = [agg.merge(a, b) for agg, a, b
                                 in zip(aggs, merged[k], states)]
        keys = sorted(merged.keys())
        cols: Dict[str, np.ndarray] = {key: np.asarray(keys)}
        for j, agg in enumerate(aggs):
            cols[agg.name] = np.asarray(
                [agg.finalize(merged[k][j]) for k in keys])
        return D.from_numpy(cols, num_blocks=1)

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof))

    # ---- map_groups --------------------------------------------------------

    def map_groups(self, fn: Callable[[dict], Any], *,
                   num_partitions: int = 8):
        """Hash-partition rows by key across tasks, then apply fn per group
        (ref: grouped_data.py map_groups → sort-based shuffle)."""
        import ray_tpu_torch
        from ray_tpu_torch.data import dataset as D

        key = self._key
        ops = self._ds._ops
        P = num_partitions

        @ray_tpu_torch.remote
        def _partition(block):
            block = D._transform_block(block, ops)
            if not isinstance(block, dict):
                block = D._rows_to_block(block)
            if not isinstance(block, dict) or key not in block:
                return tuple({} for _ in range(P))
            keycol = np.asarray(block[key])
            hashes = np.asarray([_stable_hash(k) % P
                                 for k in keycol.tolist()])
            parts = []
            for p in range(P):
                idx = np.flatnonzero(hashes == p)
                parts.append({c: v[idx] for c, v in block.items()})
            return tuple(parts)

        @ray_tpu_torch.remote
        def _reduce(*sub_blocks):
            whole = D._block_concat([b for b in sub_blocks
                                     if D._block_rows(b)])
            if not D._block_rows(whole):
                return []
            keycol = np.asarray(whole[key])
            out = []
            for k, idx in _group_indices(keycol).items():
                group = {c: v[idx] for c, v in whole.items()}
                res = fn(group)
                if isinstance(res, list):
                    out.extend(res)
                else:
                    out.append(res)
            return D._rows_to_block(out)

        part_refs = [_partition.options(num_returns=P).remote(r)
                     for r in self._ds._block_refs]
        # part_refs[i] is a list of P refs (one per partition)
        out_refs = []
        for p in range(P):
            ins = [refs[p] for refs in part_refs]
            out_refs.append(_reduce.remote(*ins))
        return D.Dataset(out_refs, [])
