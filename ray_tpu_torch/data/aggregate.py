"""Aggregation functions for Dataset.groupby / global aggregates.

Reference: python/ray/data/aggregate.py — AggregateFn protocol
(init/accumulate/merge/finalize) with Count/Sum/Min/Max/Mean/Std built-ins;
partial aggregation runs per block in parallel tasks, merge happens at the
consumer (map-side combine, the same two-stage shape as the reference's
shuffle-based aggregate).

A copy of ``ray_tpu/data/aggregate.py``: numpy only.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np


class AggregateFn:
    def __init__(self, init: Callable[[], Any],
                 accumulate_block: Callable[[Any, Any], Any],
                 merge: Callable[[Any, Any], Any],
                 finalize: Callable[[Any], Any], name: str):
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize
        self.name = name


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda acc, col: acc + len(col),
            merge=lambda a, b: a + b,
            finalize=lambda acc: acc,
            name="count()")


class Sum(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        super().__init__(
            init=lambda: 0.0,
            accumulate_block=lambda acc, col: acc + float(np.sum(col)),
            merge=lambda a, b: a + b,
            finalize=lambda acc: acc,
            name=f"sum({on})")


class Min(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        super().__init__(
            init=lambda: float("inf"),
            accumulate_block=lambda acc, col: min(acc, float(np.min(col)))
            if len(col) else acc,
            merge=min,
            finalize=lambda acc: acc,
            name=f"min({on})")


class Max(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        super().__init__(
            init=lambda: float("-inf"),
            accumulate_block=lambda acc, col: max(acc, float(np.max(col)))
            if len(col) else acc,
            merge=max,
            finalize=lambda acc: acc,
            name=f"max({on})")


class Mean(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        super().__init__(
            init=lambda: (0.0, 0),
            accumulate_block=lambda acc, col: (acc[0] + float(np.sum(col)),
                                               acc[1] + len(col)),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda acc: acc[0] / acc[1] if acc[1] else None,
            name=f"mean({on})")


class Std(AggregateFn):
    """Chan/Welford parallel variance: mergeable (n, mean, M2) sketch —
    numerically stable where the naive sum/sum-of-squares formula
    catastrophically cancels on large-mean data."""

    def __init__(self, on: str, ddof: int = 1):
        self.on = on

        def acc_block(acc, col):
            bn = len(col)
            if bn == 0:
                return acc
            col = np.asarray(col, dtype=np.float64)
            bmean = float(np.mean(col))
            bM2 = float(np.sum((col - bmean) ** 2))
            return merge(acc, (bn, bmean, bM2))

        def merge(a, b):
            n1, m1, M1 = a
            n2, m2, M2 = b
            if n1 == 0:
                return b
            if n2 == 0:
                return a
            n = n1 + n2
            delta = m2 - m1
            return (n, m1 + delta * n2 / n,
                    M1 + M2 + delta * delta * n1 * n2 / n)

        def fin(acc):
            n, _, M2 = acc
            if n <= ddof:
                return None
            return float(np.sqrt(max(0.0, M2 / (n - ddof))))

        super().__init__(
            init=lambda: (0, 0.0, 0.0),
            accumulate_block=acc_block,
            merge=merge,
            finalize=fin,
            name=f"std({on})")
