"""Tune on the port (ray_tpu_torch/tune/): grid/random search, ASHA early
stopping, best-result selection — tests/test_tune.py's cases re-aimed at
``ray_tpu_torch.tune`` over the port's runtime (trial actors in worker
processes). The two cases the JAX package marks slow run here unmarked
(a few seconds each)."""

import subprocess
import sys
from pathlib import Path

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch import tune

REPO = Path(__file__).resolve().parents[1]


def test_tune_imports_no_torch_jax_or_reference():
    """Importing the tune package (every module) in a fresh interpreter
    loads no torch, jax, optax or ray_tpu module (tune is host code); no
    source line imports jax, optax or ray_tpu."""
    code = ("import sys; import ray_tpu_torch.tune; "
            "from ray_tpu_torch.tune import loggers, schedulers, search, "
            "tuner; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'optax', 'ray_tpu', 'jaxlib')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for path in sorted(Path(REPO, "ray_tpu_torch", "tune").glob("*.py")):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "optax", "ray_tpu"), \
                    (path.name, s)


def test_grid_search_best(ray_start_regular, tmp_path):
    def objective(config):
        return {"score": -(config["x"] - 3) ** 2}

    results = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4, 5])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=3),
    ).fit()
    assert len(results) == 6
    assert results.get_best_result().config["x"] == 3


def test_random_sampling(ray_start_regular):
    def objective(config):
        return {"val": config["lr"]}

    results = tune.Tuner(
        objective,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(metric="val", mode="min", num_samples=4,
                                    max_concurrent_trials=2),
    ).fit()
    assert len(results) == 4
    for r in results:
        assert 1e-4 <= r.metrics["val"] <= 1e-1


def test_intermediate_reports_and_asha(ray_start_regular, tmp_path):
    # The four trials wait for one another before their first report and
    # report every 50 ms: under a loaded host their actors start seconds
    # apart, and a trial that ran all its reports before its peers reached
    # a rung (or before the controller polled it) could not be stopped.
    def objective(config):
        import os
        import time

        open(os.path.join(config["peers"], str(config["q"])), "w").close()
        deadline = time.time() + 60
        while len(os.listdir(config["peers"])) < 4 and \
                time.time() < deadline:
            time.sleep(0.01)
        for i in range(20):
            tune.report({"loss": 100.0 / config["q"] - i})
            time.sleep(0.05)
        return {"final": True}

    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=20,
                               grace_period=2, reduction_factor=2)
    results = tune.Tuner(
        objective,
        param_space={"q": tune.grid_search([1, 2, 4, 8]),
                     "peers": str(tmp_path)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(results) == 4
    best = results.get_best_result()
    assert best.config["q"] == 8
    stopped = [r for r in results if r.stopped_early]
    assert stopped, "ASHA should stop at least one losing trial"


def test_trial_error_isolated(ray_start_regular):
    def objective(config):
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        return {"ok": 1}

    results = tune.Tuner(
        objective, param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
    ).fit()
    assert len(results.errors) == 1
    assert results.get_best_result().metrics["ok"] == 1


def test_tpe_searcher(ray_start_regular):
    """TPE should concentrate samples near the optimum after startup."""

    def objective(config):
        return {"score": -(config["x"] - 0.7) ** 2}

    results = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=24,
            search_alg=tune.TPESearcher(n_startup_trials=6, seed=0),
            max_concurrent_trials=4),
    ).fit()
    assert len(results) == 24
    best = results.get_best_result()
    assert abs(best.config["x"] - 0.7) < 0.2
    # later (post-startup) samples should be closer on average than startup
    xs = [r.config["x"] for r in sorted(results, key=lambda r: r.trial_id)]
    startup = xs[:6]
    late = xs[-8:]
    import statistics
    assert statistics.mean(abs(x - 0.7) for x in late) <= \
        statistics.mean(abs(x - 0.7) for x in startup) + 0.05


def test_concurrency_limiter(ray_start_regular):
    def objective(config):
        return {"v": config["x"]}

    limiter = tune.ConcurrencyLimiter(tune.RandomSearch(seed=1),
                                      max_concurrent=2)
    results = tune.Tuner(
        objective, param_space={"x": tune.uniform(0, 1)},
        tune_config=tune.TuneConfig(metric="v", mode="max", num_samples=5,
                                    search_alg=limiter,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(results) == 5


def test_median_stopping(ray_start_regular):
    def objective(config):
        import time
        for i in range(15):
            tune.report({"acc": config["q"] * (i + 1)})
            time.sleep(0.01)
        return {"done": 1}

    sched = tune.MedianStoppingRule(metric="acc", mode="max",
                                    grace_period=3)
    results = tune.Tuner(
        objective, param_space={"q": tune.grid_search([1, 1, 1, 10])},
        tune_config=tune.TuneConfig(metric="acc", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(results) == 4


def test_hyperband_brackets(ray_start_regular):
    def objective(config):
        import time
        for i in range(10):
            tune.report({"loss": 10.0 / config["q"] - i * 0.1})
            time.sleep(0.005)
        return {"fin": 1}

    sched = tune.HyperBandScheduler(metric="loss", mode="min", max_t=9,
                                    reduction_factor=3)
    results = tune.Tuner(
        objective, param_space={"q": tune.grid_search([1, 2, 4, 8])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(results) == 4
    assert results.get_best_result().config["q"] == 8


def test_pbt_exploit_transfers_checkpoint(ray_start_regular, tmp_path):
    """Bottom-quantile trials must clone top checkpoints and perturb lr.
    The four first attempts wait for one another before they report (PBT
    ranks a population of four), as the ASHA case above does."""

    def objective(config):
        import os
        import time

        peers = os.path.join(config["peers"], str(config["lr"]))
        if not os.path.exists(peers) and tune.get_checkpoint() is None:
            open(peers, "w").close()
            deadline = time.time() + 60
            while len(os.listdir(config["peers"])) < 4 and \
                    time.time() < deadline:
                time.sleep(0.01)
        start = tune.get_checkpoint()
        score = start["score"] if start else 0.0
        lr = config["lr"]
        for _ in range(30):
            score += lr
            tune.report({"score": score, "lr": lr},
                        checkpoint={"score": score})
            time.sleep(0.01)
        return {"score": score}

    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=5,
        quantile_fraction=0.5,
        hyperparam_mutations={"lr": tune.uniform(0.001, 1.0)}, seed=0)
    results = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.001, 0.002, 0.5, 1.0]),
                     "peers": str(tmp_path)},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(results) == 4
    # the losers should have been pulled up by exploitation: every trial's
    # final score should be far above what lr=0.001 alone could reach (0.03)
    finals = sorted(r.metrics["score"] for r in results)
    assert finals[0] > 0.1, finals


def test_bayesopt_search_beats_random_on_quadratic(ray_start_regular):
    """GP+EI must concentrate samples near the optimum of a smooth
    objective (ref: BayesOptSearch wrapper semantics)."""
    from ray_tpu_torch import tune

    def objective(config):
        return {"score": -(config["x"] - 0.7) ** 2
                         - (config["y"] - 0.3) ** 2}

    searcher = tune.BayesOptSearch(n_startup_trials=5, seed=0)
    results = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(0, 1), "y": tune.uniform(0, 1),
                     "tag": tune.choice(["a", "b"])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    num_samples=20, search_alg=searcher,
                                    max_concurrent_trials=2),
    ).fit()
    best = results.get_best_result()
    assert best.metrics["score"] > -0.02  # within ~0.14 of the optimum
    assert best.config["tag"] in ("a", "b")


def test_bayesopt_loguniform_and_randint(ray_start_regular):
    from ray_tpu_torch import tune

    def objective(config):
        import math

        return {"loss": abs(math.log10(config["lr"]) + 2)
                        + abs(config["layers"] - 3) * 0.1}

    searcher = tune.BayesOptSearch(n_startup_trials=4, seed=1)
    results = tune.Tuner(
        objective,
        param_space={"lr": tune.loguniform(1e-4, 1e-1),
                     "layers": tune.randint(1, 6)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    num_samples=16, search_alg=searcher,
                                    max_concurrent_trials=2),
    ).fit()
    best = results.get_best_result()
    assert best.metrics["loss"] < 0.8
    assert isinstance(best.config["layers"], int)


def test_trials_wait_for_resources_not_lost(tmp_path, monkeypatch):
    """Q4 (ROADMAP.md queue 3), repaired in the port: two 3 s trials
    asking for the cluster's one unit of "X", the controller's poll
    timeout patched to 1 s. The second trial waits in the queue until the
    first's actor is gone (the reference starts both actors at once and
    reports the second lost after its poll timeout); both finish, neither
    is lost, and no two trial actors are alive at once."""
    import json

    import ray_tpu_torch
    from ray_tpu_torch.tune import tuner

    monkeypatch.setattr(tuner, "POLL_TIMEOUT_S", 1.0)

    def objective(config):
        import json
        import os
        import time

        t0 = time.time()
        time.sleep(3.0)
        with open(os.path.join(config["dir"], f"{config['i']}.json"),
                  "w") as f:
            json.dump({"start": t0, "end": time.time(),
                       "pid": os.getpid()}, f)
        return {"done": 1}

    ray_tpu_torch.init(num_cpus=4, resources={"X": 1.0},
                       _system_config={"health_check_period_s": 0.2})
    try:
        results = tune.Tuner(
            objective,
            param_space={"i": tune.grid_search([0, 1]),
                         "dir": str(tmp_path)},
            tune_config=tune.TuneConfig(
                metric="done", mode="max",
                resources_per_trial={"CPU": 1.0, "X": 1.0}),
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert len(results) == 2
    assert not results.errors, [r.error for r in results.errors]
    spans = sorted(
        (json.load(open(tmp_path / f"{i}.json")) for i in range(2)),
        key=lambda s: s["start"])
    # the second trial's actor started after the first's had exited
    assert spans[1]["start"] >= spans[0]["end"], spans
    assert spans[0]["pid"] != spans[1]["pid"]
