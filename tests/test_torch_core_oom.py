"""OOM defense: memory monitor + worker-killing policy.

Mirrors the reference's memory_monitor_test.cc / worker_killing_policy
tests (SURVEY.md §5.3): policy selection is unit-tested as a pure function;
the monitor loop is exercised end-to-end with a fake usage file, asserting
a retriable task is killed under pressure and retried to completion once
pressure clears.

Port of tests/test_core_oom.py, aimed at ray_tpu_torch.
"""

import os
import time

import pytest

from ray_tpu_torch.core.memory_monitor import (KillCandidate, get_memory_usage,
                                         pick_worker_to_kill)
from torch_runtime_support import reap_orphans  # noqa: F401


def _c(wid, job, actor=False, retriable=True, t=0.0):
    return KillCandidate(worker_id=wid, job_id=job, is_actor=actor,
                         retriable=retriable, start_time=t)


class TestKillPolicy:
    def test_empty(self):
        assert pick_worker_to_kill([]) is None

    def test_group_by_owner_prefers_larger_group_newest_member(self):
        # job A has 3 tasks, job B has 1 → kill newest of A so B keeps
        # progressing (ref: worker_killing_policy_group_by_owner.h).
        cands = [_c(b"a1", b"A", t=1), _c(b"a2", b"A", t=3),
                 _c(b"a3", b"A", t=2), _c(b"b1", b"B", t=9)]
        assert pick_worker_to_kill(cands).worker_id == b"a2"

    def test_group_by_owner_prefers_retriable(self):
        cands = [_c(b"x", b"A", retriable=False, t=5),
                 _c(b"y", b"B", retriable=True, t=1)]
        assert pick_worker_to_kill(cands).worker_id == b"y"

    def test_singletons_kill_newest(self):
        cands = [_c(b"x", b"A", t=1), _c(b"y", b"B", t=2)]
        assert pick_worker_to_kill(cands).worker_id == b"y"

    def test_retriable_fifo(self):
        cands = [_c(b"x", b"A", retriable=False, t=9),
                 _c(b"y", b"A", retriable=True, t=1),
                 _c(b"z", b"A", retriable=True, t=2)]
        assert pick_worker_to_kill(cands, "retriable_fifo").worker_id == b"z"

    def test_retriable_fifo_falls_back_to_nonretriable(self):
        cands = [_c(b"x", b"A", retriable=False, t=1),
                 _c(b"y", b"A", retriable=False, t=2)]
        assert pick_worker_to_kill(cands, "retriable_fifo").worker_id == b"y"


def test_get_memory_usage_sane():
    used, total = get_memory_usage()
    assert total > 0
    assert 0 <= used <= total


def test_oom_kill_and_retry(tmp_path):
    """Under fake pressure the monitor kills the running task's worker; the
    owner retries; once pressure clears the retry completes."""
    import ray_tpu_torch

    usage = tmp_path / "usage"
    usage.write_text("0.0")
    marker = tmp_path / "attempts"
    ray_tpu_torch.init(num_cpus=2, _system_config={
        "memory_monitor_refresh_ms": 100,
        "memory_usage_threshold": 0.9,
        "memory_monitor_test_usage_file": str(usage),
        "health_check_period_s": 0.2,
    })
    try:
        @ray_tpu_torch.remote(max_retries=3)
        def hog(marker_path):
            with open(marker_path, "a") as f:
                f.write("x")
            attempts = os.path.getsize(marker_path)
            if attempts == 1:
                time.sleep(60)       # first attempt: stall under pressure
            return attempts

        ref = hog.remote(str(marker))
        # Wait for attempt 1 to start, then apply pressure.
        for _ in range(200):
            if marker.exists() and marker.stat().st_size >= 1:
                break
            time.sleep(0.05)
        usage.write_text("1.0")
        # Wait for the kill, then release pressure so the retry survives.
        for _ in range(200):
            if marker.stat().st_size >= 2:
                break
            time.sleep(0.05)
        usage.write_text("0.0")
        assert ray_tpu_torch.get(ref, timeout=60) >= 2
        stats = [n for n in ray_tpu_torch.nodes()]
        assert stats  # node alive after the kill
    finally:
        ray_tpu_torch.shutdown()
