"""ray_tpu_torch.data.execution: streaming executor scheduling behavior.

Reference test model: python/ray/data/tests/test_streaming_executor.py —
backpressure holds queued bytes under budget while stages stay
pipelined; tiny budgets never deadlock; executor output is bitwise
identical to the legacy fused path.

Port of tests/test_data_executor.py, aimed at ray_tpu_torch.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.execution import get_context, get_last_execution_stats
from ray_tpu_torch.util.actor_pool import ActorPool
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

BLOCK_ROWS = 16384                       # float64 -> 128 KiB per block
BLOCK_BYTES = BLOCK_ROWS * 8


@pytest.fixture
def data_ctx():
    """Expose the DataContext singleton and restore it after the test."""
    ctx = get_context()
    saved = (ctx.execution_policy, ctx.budget_fraction,
             ctx.per_op_budget_bytes, ctx.max_tasks_per_op)
    yield ctx
    (ctx.execution_policy, ctx.budget_fraction,
     ctx.per_op_budget_bytes, ctx.max_tasks_per_op) = saved


def _float_ds(num_blocks=12):
    blocks = [{"x": np.arange(BLOCK_ROWS, dtype=np.float64) + i * BLOCK_ROWS}
              for i in range(num_blocks)]
    refs = [ray_tpu_torch.put(b) for b in blocks]
    return rd.Dataset(refs, [])


def test_two_stage_backpressure(ray_start_regular, data_ctx):
    """Stage 2 is ~10x slower than stage 1. The scheduler must throttle
    stage 1 (queued bytes bounded by the budget) WITHOUT serializing the
    pipeline (both stages concurrently in flight at some point)."""
    budget = 4 * BLOCK_BYTES
    data_ctx.per_op_budget_bytes = budget

    def fast(b):
        return {"x": b["x"] * 2.0}

    def slow(b):
        time.sleep(0.05)
        return {"x": b["x"] + 1.0}

    ds = _float_ds(12).map_batches(fast).map_batches(slow)
    streaming = list(ds._iter_blocks(policy="streaming"))
    stats = get_last_execution_stats()
    assert stats is not None and stats["rounds"] > 0

    # budget adherence: no operator ever held more unconsumed output
    # than its budget plus one block of estimate slack (the min-one
    # liveness rule admits a first task before any size estimate exists)
    per_op_peak = {}
    for round_ in stats["trace"]:
        for o in round_["ops"]:
            per_op_peak[o["name"]] = max(
                per_op_peak.get(o["name"], 0), o["queued_bytes"])
    for name, peak in per_op_peak.items():
        assert peak <= budget + BLOCK_BYTES, (name, peak, budget)

    # ...which is real throttling: stage 1 produced 12 blocks total but
    # never held anywhere near all of them
    total_stage1_bytes = 12 * BLOCK_BYTES
    assert stats["peak_queued_bytes"] < total_stage1_bytes

    # interleaving: some round saw BOTH map stages with tasks in flight
    both_busy = any(
        all(o["in_flight"] > 0 for o in round_["ops"]
            if "map_batches" in o["name"])
        and sum(o["in_flight"] for o in round_["ops"]
                if "map_batches" in o["name"]) >= 2
        for round_ in stats["trace"])
    assert both_busy, "stages never overlapped — pipeline serialized"

    # the slow stage spent time budget-blocking its producer
    ops = stats["operators"]
    assert any(m["tasks_finished"] == 12 for m in ops.values())

    # bitwise equivalence with the fused path, block order preserved
    fused = list(ds._iter_blocks(policy="fused"))
    assert len(streaming) == len(fused) == 12
    for s, f in zip(streaming, fused):
        assert np.array_equal(s["x"], f["x"])


def test_liveness_tiny_budget(ray_start_regular, data_ctx):
    """A budget smaller than any single block must degrade to
    one-task-at-a-time execution, never deadlock (min-one rule)."""
    data_ctx.per_op_budget_bytes = 1
    ds = (_float_ds(6)
          .map_batches(lambda b: {"x": b["x"] * 2.0})
          .map_batches(lambda b: {"x": b["x"] + 1.0})
          .map_batches(lambda b: {"x": b["x"] - 3.0}))
    out = list(ds._iter_blocks(policy="streaming"))
    assert len(out) == 6
    expect = np.arange(6 * BLOCK_ROWS, dtype=np.float64) * 2.0 + 1.0 - 3.0
    got = np.concatenate([b["x"] for b in out])
    assert np.array_equal(got, expect)


def test_actor_pool_ordered_vs_unordered(ray_start_regular):
    @ray_tpu_torch.remote
    class W:
        def work(self, v):
            if v == 0:
                time.sleep(0.4)      # first submission finishes LAST
            return v

    # ordered: submission order regardless of completion order
    pool = ActorPool([W.remote(), W.remote()])
    for v in range(4):
        pool.submit(lambda a, v: a.work.remote(v), v)
    got = [pool.get_next() for _ in range(4)]
    assert got == [0, 1, 2, 3]

    # unordered: a fast later task overtakes the slow first one
    pool = ActorPool([W.remote(), W.remote()])
    for v in range(4):
        pool.submit(lambda a, v: a.work.remote(v), v)
    first = pool.get_next_unordered()
    rest = sorted(pool.get_next_unordered() for _ in range(3))
    assert first != 0
    assert sorted(rest + [first]) == [0, 1, 2, 3]


def test_cross_path_equivalence(ray_start_regular, data_ctx):
    """Multi-op chain: streaming output must be bitwise equal to the
    fused path, including block order."""
    ds = (rd.range(200, num_blocks=8)
          .map_batches(lambda b: {"id": b["id"], "y": b["id"] * 0.5})
          .filter(lambda r: r["id"] % 3 != 0)
          .map_batches(lambda b: {"id": b["id"], "y": b["y"] + 7.0}))
    streaming = list(ds._iter_blocks(policy="streaming"))
    fused = list(ds._iter_blocks(policy="fused"))
    assert len(streaming) == len(fused)
    for s, f in zip(streaming, fused):
        assert sorted(s) == sorted(f)
        for k in s:
            assert np.array_equal(s[k], f[k]), k


def test_actor_pool_operator_equivalence(ray_start_regular, data_ctx):
    """map_batches(ActorPoolStrategy) rides the executor too, with
    block order preserved by the ordered pool."""
    class Scale:
        def __call__(self, b):
            return {"id": b["id"] * 10}

    ds = rd.range(64, num_blocks=8)
    out = ds.map_batches(
        Scale, compute=rd.ActorPoolStrategy(size=2)).take_all()
    assert [int(r["id"]) for r in out] == [i * 10 for i in range(64)]


def test_iter_split_single_run(ray_start_regular, data_ctx):
    """iter_split shares ONE executor run across n consumers; draining
    the shards interleaved or sequentially both complete."""
    ds = rd.range(48, num_blocks=6).map_batches(
        lambda b: {"id": b["id"] + 100})

    # interleaved drain
    its = ds.iter_split(2)
    a, b = iter(its[0]), iter(its[1])
    seen, done_a, done_b = [], False, False
    while not (done_a and done_b):
        for which, it in (("a", a), ("b", b)):
            if (which == "a" and done_a) or (which == "b" and done_b):
                continue
            try:
                seen.append(next(it))
            except StopIteration:
                if which == "a":
                    done_a = True
                else:
                    done_b = True
    ids = sorted(int(x) for blk in seen for x in blk["id"])
    assert ids == list(range(100, 148))

    # sequential drain (shard 1 queues while shard 0 drains; splitter
    # shard queues are budget-exempt so this cannot deadlock)
    its = ds.iter_split(2)
    seen = [blk for it in its for blk in it]
    ids = sorted(int(x) for blk in seen for x in blk["id"])
    assert ids == list(range(100, 148))


def test_stats_published(ray_start_regular, data_ctx):
    ds = rd.range(32, num_blocks=4).map_batches(
        lambda b: {"id": b["id"] + 1}).map_batches(
        lambda b: {"id": b["id"] * 2})
    list(ds._iter_blocks(policy="streaming"))
    st = get_last_execution_stats()
    assert st["per_op_budget_bytes"] > 0
    assert st["max_concurrent_ops"] >= 1
    names = list(st["operators"])
    assert names[0].endswith("input")
    finished = [m["tasks_finished"] for m in st["operators"].values()]
    assert finished[1:] == [4, 4]
    assert all(m["bytes_out"] > 0 for name, m in st["operators"].items()
               if "map_batches" in name)
