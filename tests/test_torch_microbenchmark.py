"""Microbenchmark harness smoke on the port (ray_tpu_torch/_perf.py):
tests/test_microbenchmark.py's case re-aimed (ref: ray_perf.py is
exercised in CI via short runs; correctness here, numbers at release
time)."""

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def test_microbenchmark_runs(ray_start_regular):
    from ray_tpu_torch._perf import run_microbenchmarks

    res = run_microbenchmarks(
        which=["task_single", "put_small", "actor"], min_seconds=0.3)
    names = {r["name"] for r in res}
    assert "task_roundtrip" in names
    assert "put_small_100B" in names
    assert "actor_call_roundtrip" in names
    for r in res:
        assert r["ops_per_s"] > 0
