"""Tuner.restore on the port (ray_tpu_torch/tune/tuner.py): driver-crash
recovery of a sweep — tests/test_tune_restore.py's cases re-aimed at
``ray_tpu_torch.tune`` (ref: python/ray/tune/tuner.py:180 Tuner.restore +
tune/execution/experiment_state.py): the driver process is SIGKILLed
mid-sweep; Tuner.restore(run_dir) resumes — completed trials are NOT
re-run, in-flight trials resume from their last persisted checkpoint.
The JAX package marks the driver-kill case slow; here it runs unmarked
(about ten seconds).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphan_daemons, reap_orphans)

from ray_tpu_torch.tune import TuneConfig, Tuner


_DRIVER = textwrap.dedent("""
    import os, sys, time
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import Tuner, TuneConfig
    from ray_tpu_torch.train.config import RunConfig

    MARKER = os.environ["MARKER_DIR"]

    def trainable(config):
        i = config["i"]
        open(os.path.join(MARKER, f"exec_{i}_{os.getpid()}"), "w").close()
        ck = tune.get_checkpoint()
        start = ck["step"] if ck else 0
        if ck is not None:
            open(os.path.join(MARKER, f"resume_{i}_{start}"), "w").close()
        sleep = 0.05 if i < 2 else 0.8
        for step in range(start, 5):
            time.sleep(sleep)
            tune.report({"score": i * 100 + step, "step": step},
                        checkpoint={"step": step + 1})
        return {"final": i}

    ray_tpu_torch.init(num_cpus=8)
    tuner = Tuner(trainable,
                  param_space={"i": tune.grid_search([0, 1, 2, 3])},
                  tune_config=TuneConfig(metric="score", mode="max",
                                         max_concurrent_trials=4),
                  run_config=RunConfig(name=os.environ["RUN_NAME"],
                                       storage_path=os.environ["RUN_BASE"]))
    tuner.fit()
    print("DRIVER_DONE", flush=True)
""")


def _exp_state(run_dir):
    try:
        with open(os.path.join(run_dir, "experiment_state.json")) as f:
            return json.load(f)["trials"]
    except Exception:
        return {}


def test_tuner_restore_after_driver_kill(ray_start_regular, tmp_path):
    marker = tmp_path / "markers"
    marker.mkdir()
    run_base = str(tmp_path / "runs")
    run_dir = os.path.join(run_base, "sweep")
    driver = tmp_path / "driver.py"
    driver.write_text(_DRIVER)
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(MARKER_DIR=str(marker), RUN_BASE=run_base, RUN_NAME="sweep",
               PYTHONPATH=repo_root + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, str(driver)], env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # wait until the fast trials completed and a slow trial has
        # checkpointed, then SIGKILL the whole driver session
        deadline = time.time() + 120
        while time.time() < deadline:
            trials = _exp_state(run_dir)
            done = [t for t, r in trials.items() if r["status"] == "done"]
            ck = [t for t, r in trials.items()
                  if r["status"] == "running" and r.get("has_ckpt")]
            if len(done) >= 2 and len(ck) >= 2:
                break
            if proc.poll() is not None:
                pytest.fail(f"driver exited early:\n{proc.stdout.read()}")
            time.sleep(0.1)
        else:
            pytest.fail(f"sweep never reached kill point: {_exp_state(run_dir)}")
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        # the killed driver's cluster outlives it (its daemons run in
        # their own sessions): reap it, the nodelet's workers once their
        # nodelet is gone
        for _ in range(10):
            reap_orphan_daemons()
            time.sleep(0.1)
    time.sleep(1.0)

    trials = _exp_state(run_dir)
    done_before = {t for t, r in trials.items() if r["status"] == "done"}
    running_before = {t for t, r in trials.items()
                     if r["status"] == "running"}
    assert len(done_before) >= 2
    assert running_before

    # restore in this (fresh) cluster — the original trainable is
    # recovered from trainable.pkl (cloudpickled by value)
    tuner = Tuner.restore(run_dir)
    grid = tuner.fit()
    assert len(grid) == 4
    assert not grid.errors
    best = grid.get_best_result()
    assert best.metrics["final"] == 3 or best.metrics.get("score") == 304

    # completed trials were not re-run: one exec marker each
    for tid in done_before:
        i = trials[tid]["config"]["i"]
        execs = [m for m in os.listdir(marker) if m.startswith(f"exec_{i}_")]
        assert len(execs) == 1, (tid, execs)
    # in-flight trials resumed from a checkpoint (step > 0), not scratch
    resumed = [m for m in os.listdir(marker) if m.startswith("resume_")]
    assert resumed, os.listdir(marker)
    assert all(int(m.split("_")[-1]) > 0 for m in resumed)


def test_tuner_restore_requires_run_dir_artifacts(tmp_path):
    with pytest.raises(FileNotFoundError):
        Tuner.restore(str(tmp_path / "nope"))


def test_restored_metrics_keep_types(ray_start_regular, tmp_path):
    """Completed-trial metrics must round-trip restore as numbers, not the
    strings json default=str produces for np/jnp scalars (the pickle
    sidecar carries the typed values)."""
    import numpy as np

    from ray_tpu_torch.train.config import RunConfig

    def trainable(config):
        return {"score": np.float32(config["i"] * 1.5)}

    from ray_tpu_torch import tune

    run_base = str(tmp_path / "runs")
    tuner = Tuner(trainable,
                  param_space={"i": tune.grid_search([7])},
                  tune_config=TuneConfig(metric="score", mode="max"),
                  run_config=RunConfig(name="typed", storage_path=run_base))
    tuner.fit()

    restored = Tuner.restore(os.path.join(run_base, "typed"),
                             trainable=trainable)
    grid = restored.fit()
    score = grid.get_best_result().metrics["score"]
    assert isinstance(score, (int, float, np.floating)), type(score)
    assert float(score) == pytest.approx(10.5)


def test_restore_bare_relative_path(ray_start_regular, tmp_path, monkeypatch):
    """Tuner.restore('name') from inside the storage dir must still
    persist (dirname of a bare path is '' — regression guard)."""
    from ray_tpu_torch.train.config import RunConfig

    def trainable(config):
        return {"score": 1.0}

    run_base = str(tmp_path / "runs")
    from ray_tpu_torch import tune

    tuner = Tuner(trainable, param_space={"i": tune.grid_search([0])},
                  tune_config=TuneConfig(metric="score", mode="max"),
                  run_config=RunConfig(name="rel", storage_path=run_base))
    tuner.fit()
    # simulate a run_config that did not survive pickling
    meta_path = os.path.join(run_base, "rel", "tuner.pkl")
    import pickle
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    meta["run_config"] = None
    with open(meta_path, "wb") as f:
        pickle.dump(meta, f)

    monkeypatch.chdir(run_base)
    restored = Tuner.restore("rel", trainable=trainable)
    assert restored._run_dir() == os.path.join(run_base, "rel")
