"""Core-runtime microbenchmark harness.

Port of ray_tpu/_perf.py over the port's runtime. Reference:
python/ray/_private/ray_perf.py:120-318 (`ray microbenchmark`,
scripts.py:1821) — the canonical task/actor/object-plane throughput and
latency suite. Same dimensions, same methodology (timed loops against a
live cluster, ops/sec reported); run via `python -m ray_tpu_torch.cli
microbenchmark` or programmatically with run_microbenchmarks().
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch


def _timeit(name: str, fn: Callable[[], int], results: List[dict],
            min_seconds: float = 2.0):
    """Run fn (returns #ops) until min_seconds elapsed; record ops/s."""
    fn()  # warmup
    ops = 0
    t0 = time.time()
    while time.time() - t0 < min_seconds:
        ops += fn()
    dt = time.time() - t0
    results.append({"name": name, "ops_per_s": round(ops / dt, 1),
                    "ops": ops, "seconds": round(dt, 2)})


@ray_tpu_torch.remote
def _noop():
    return None


@ray_tpu_torch.remote
def _noop_arg(x):
    return None


@ray_tpu_torch.remote
class _Actor:
    def noop(self):
        return None

    def echo(self, x):
        return x


def run_microbenchmarks(which: Optional[List[str]] = None,
                        min_seconds: float = 2.0) -> List[dict]:
    """Runs against the current cluster (ray_tpu_torch.init first).
    `which` filters by substring (like ray microbenchmark --filter)."""
    results: List[dict] = []

    def want(name: str) -> bool:
        return not which or any(w in name for w in which)

    # Pool warmup before any measurement (ref: ray_perf.py benchmarks
    # run against a warm cluster; ray prestarts workers at init): a
    # fractional-CPU fan-out forces the worker pool to steady state so
    # the first benchmarks don't measure worker spawn + imports.
    # Skipped when only object-plane benches run — they need no workers.
    if any(want(n) for n in ("task_single", "task_batch", "task_args",
                             "actor")):
        ray_tpu_torch.get([_noop.options(num_cpus=0.1).remote()
                     for _ in range(16)])

    # --- object plane (ref: ray_perf.py put/get benchmarks)
    if want("put_small"):
        def put_small():
            for _ in range(100):
                ray_tpu_torch.put(b"x" * 100)
            return 100
        _timeit("put_small_100B", put_small, results, min_seconds)

    if want("put_get_1MiB"):
        buf = np.zeros(1 << 20, np.uint8)

        def put_get_large():
            for _ in range(10):
                ray_tpu_torch.get(ray_tpu_torch.put(buf))
            return 10
        _timeit("put_get_1MiB", put_get_large, results, min_seconds)

    if want("get_batch"):
        refs = [ray_tpu_torch.put(i) for i in range(1000)]

        def get_batch():
            ray_tpu_torch.get(refs)
            return 1000
        _timeit("get_batch_1k", get_batch, results, min_seconds)

    # --- task plane (ref: single/batch task invocation benchmarks)
    if want("task_single"):
        def task_single():
            ray_tpu_torch.get(_noop.remote())
            return 1
        _timeit("task_roundtrip", task_single, results, min_seconds)

    if want("task_batch"):
        def task_batch():
            ray_tpu_torch.get([_noop.remote() for _ in range(100)])
            return 100
        _timeit("task_batch_100", task_batch, results, min_seconds)

    if want("task_args"):
        ref = ray_tpu_torch.put(np.zeros(1 << 16, np.uint8))

        def task_args():
            ray_tpu_torch.get([_noop_arg.remote(ref) for _ in range(50)])
            return 50
        _timeit("task_obj_arg_64KiB", task_args, results, min_seconds)

    # --- actor plane (ref: actor call benchmarks)
    if want("actor"):
        a = _Actor.options(num_cpus=0.1).remote()
        ray_tpu_torch.get(a.noop.remote())

        def actor_sync():
            ray_tpu_torch.get(a.noop.remote())
            return 1
        _timeit("actor_call_roundtrip", actor_sync, results, min_seconds)

        def actor_pipelined():
            ray_tpu_torch.get([a.noop.remote() for _ in range(100)])
            return 100
        _timeit("actor_calls_pipelined_100", actor_pipelined, results,
                min_seconds)
        ray_tpu_torch.kill(a)

    return results


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--address", default=None)
    p.add_argument("--filter", action="append", default=None,
                   help="substring filter, repeatable")
    p.add_argument("--min-seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if args.address:
        ray_tpu_torch.init(address=args.address)
    else:
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    try:
        for r in run_microbenchmarks(args.filter, args.min_seconds):
            print(json.dumps(r))
    finally:
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
