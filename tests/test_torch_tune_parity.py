"""The port's tune (ray_tpu_torch/tune/{search,schedulers,loggers}.py)
against the reference's modules (ray_tpu/tune/), loaded in this process
through test_torch_support's stubs (its ``tune`` group: the three modules
import no runtime at module level). Tune is host code with no tensor math,
so every comparison is exact:

- each sampler's draws and ``generate_variants`` (grids crossed with
  samplers, repeated ``num_samples`` times) for the same seed;
- the suggestions of ``BasicVariantGenerator``, ``RandomSearch``,
  ``ConcurrencyLimiter``, ``TPESearcher`` and ``BayesOptSearch`` (sklearn's
  GP) told the same results of the same objective;
- the decisions of ``FIFOScheduler``, ``ASHAScheduler``,
  ``MedianStoppingRule``, ``HyperBandScheduler`` and
  ``PopulationBasedTraining`` (its exploit targets and explored configs)
  on a fixed interleaved stream of results, including the rungs at which
  ASHA stops each trial;
- the files the CSV and JSON logger callbacks write for the same events,
  byte for byte.
"""

import math
import random

import pytest

from test_torch_support import jax_reference

from ray_tpu_torch.tune import loggers as tloggers
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch


def _space(m):
    """The same search space built from module `m`'s constructors."""
    return {"lr": m.loguniform(1e-5, 1e-1), "drop": m.uniform(0.0, 0.5),
            "layers": m.randint(1, 8), "act": m.choice(["relu", "gelu",
                                                        "tanh"]),
            "batch": m.grid_search([16, 32]), "fixed": 7}


def test_samplers_draw_the_same_values():
    def draws(m):
        rng = random.Random(9)
        return {k: [v.sample(rng) for _ in range(50)]
                for k, v in _space(m).items() if isinstance(v, m.Sampler)}

    with jax_reference("tune") as ref:
        want = draws(ref.tune_search)
    got = draws(tsearch)
    assert got == want
    assert set(got) == {"lr", "drop", "layers", "act"}


@pytest.mark.parametrize("num_samples,seed", [(1, 0), (3, 5)])
def test_generate_variants(num_samples, seed):
    with jax_reference("tune") as ref:
        want = ref.tune_search.generate_variants(
            _space(ref.tune_search), num_samples, seed)
    got = tsearch.generate_variants(_space(tsearch), num_samples, seed)
    assert got == want
    assert len(got) == 2 * num_samples


def _objective(cfg):
    return -(math.log10(cfg["lr"]) + 3) ** 2 - (cfg["drop"] - 0.2) ** 2 \
        - 0.05 * abs(cfg["layers"] - 4) + (0.1 if cfg["act"] == "gelu"
                                          else 0.0)


def _drive(searcher, space, n, metric="score", mode="max"):
    """Ask `n` suggestions of `searcher`, telling each one's score before
    the next ask (failing every fifth): the configs it suggested."""
    searcher.set_search_properties(metric, mode, space)
    out = []
    for i in range(n):
        tid = f"trial_{i:05d}"
        cfg = searcher.suggest(tid)
        out.append(cfg)
        if cfg is None or cfg == "PENDING":
            continue
        searcher.on_trial_complete(
            tid, {metric: _objective(cfg), "config": cfg}, error=i % 5 == 4)
    return out


def _numeric_space(m):
    return {k: v for k, v in _space(m).items() if k != "batch"}


@pytest.mark.parametrize("kind", ["basic", "random", "limited", "tpe",
                                  "bayesopt"])
def test_searcher_suggestions(kind):
    if kind == "bayesopt":
        pytest.importorskip("sklearn")

    def make(m):
        return {"basic": lambda: m.BasicVariantGenerator(num_samples=2,
                                                         seed=4),
                "random": lambda: m.RandomSearch(seed=4),
                "limited": lambda: m.ConcurrencyLimiter(m.RandomSearch(
                    seed=4), max_concurrent=2),
                "tpe": lambda: m.TPESearcher(n_startup_trials=5, seed=4),
                "bayesopt": lambda: m.BayesOptSearch(n_startup_trials=4,
                                                     n_candidates=64,
                                                     seed=4)}[kind]()

    n = 14 if kind in ("tpe", "bayesopt") else 6
    with jax_reference("tune") as ref:
        rs = ref.tune_search
        space = _space(rs) if kind == "basic" else _numeric_space(rs)
        want = _drive(make(rs), space, n)
    space = _space(tsearch) if kind == "basic" else _numeric_space(tsearch)
    got = _drive(make(tsearch), space, n)
    assert got == want
    assert any(isinstance(c, dict) for c in got)


def _stream(n_trials=6, steps=12, seed=1):
    """An interleaved stream of (trial_id, result): trial k's loss falls at
    its own rate, with noise; trials report in a shuffled order, each in
    its own step order, as a controller polling several actors sees
    them."""
    rng = random.Random(seed)
    rate = [0.5 + 0.3 * k + rng.random() * 0.1 for k in range(n_trials)]
    cursors = {f"trial_{k:05d}": 0 for k in range(n_trials)}
    out = []
    while cursors:
        tid = rng.choice(sorted(cursors))
        k, t = int(tid[-5:]), cursors[tid] + 1
        loss = 10.0 / (1 + rate[k] * t) + rng.random() * 0.05
        out.append((tid, {"training_iteration": t, "loss": loss,
                          "score": -loss, "config": {"lr": 0.1 * (k + 1)}}))
        if t == steps:
            del cursors[tid]
        else:
            cursors[tid] = t
    return out


def _decisions(sched, stream):
    """Each result's decision, with a stopped trial's later results
    dropped (the controller stops it)."""
    stopped, out = set(), []
    for tid, r in stream:
        if tid in stopped:
            continue
        d = sched.on_result(tid, r)
        out.append((tid, r["training_iteration"], d))
        if d == "STOP":
            stopped.add(tid)
    return out


def _schedulers(m, rs):
    return {
        "fifo": lambda: m.FIFOScheduler(),
        "asha_min": lambda: m.ASHAScheduler(metric="loss", mode="min",
                                            max_t=8, grace_period=2,
                                            reduction_factor=2),
        "asha_max": lambda: m.ASHAScheduler(metric="score", mode="max",
                                            max_t=12, grace_period=1,
                                            reduction_factor=3),
        "median": lambda: m.MedianStoppingRule(metric="loss", mode="min",
                                               grace_period=2),
        "hyperband": lambda: m.HyperBandScheduler(metric="loss", mode="min",
                                                  max_t=9,
                                                  reduction_factor=3),
        "pbt": lambda: m.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=3,
            quantile_fraction=0.34, seed=2,
            hyperparam_mutations={"lr": rs.uniform(0.01, 1.0),
                                  "wd": [0.0, 0.01, 0.1]}),
    }


@pytest.mark.parametrize("kind", ["fifo", "asha_min", "asha_max", "median",
                                  "hyperband", "pbt"])
def test_scheduler_decisions(kind):
    stream = _stream()
    with jax_reference("tune") as ref:
        want = _decisions(_schedulers(ref.tune_schedulers,
                                      ref.tune_search)[kind](), stream)
    got = _decisions(_schedulers(tsched, tsearch)[kind](), stream)
    assert got == want
    if kind.startswith("asha"):
        # some trial is stopped at a rung below max_t, which the
        # comparison pins (the rung is each STOP's training_iteration)
        assert any(d == "STOP" and t < 8 for _, t, d in got), got
    if kind == "pbt":
        assert any(isinstance(d, tuple) for _, _, d in got), got


def test_asha_milestones():
    for kw in (dict(max_t=8, grace_period=2, reduction_factor=2),
               dict(max_t=100, grace_period=1, reduction_factor=4),
               dict(max_t=81, grace_period=3, reduction_factor=3)):
        with jax_reference("tune") as ref:
            want = ref.tune_schedulers.ASHAScheduler(**kw).milestones
        assert tsched.ASHAScheduler(**kw).milestones == want


def _log_events(m, run_dir):
    """The same events through module `m`'s CSV and JSON callbacks."""
    cbs = [m.CSVLoggerCallback(), m.JsonLoggerCallback()]
    for cb in cbs:
        cb.setup(run_dir)
    for tid in ("trial_00000", "trial_00001"):
        for cb in cbs:
            cb.on_trial_start(tid, {"lr": 0.01, "act": "gelu"})
    for tid, r in _stream(n_trials=2, steps=4):
        r = {k: v for k, v in r.items() if k != "config"}
        r["_ts"] = 1.5e9 + r["training_iteration"]
        for cb in cbs:
            cb.on_trial_result(tid, r)
    for tid in ("trial_00000", "trial_00001"):
        for cb in cbs:
            cb.on_trial_complete(tid, None)
    for cb in cbs:
        cb.on_experiment_end([])


def test_csv_and_json_logger_files(tmp_path):
    with jax_reference("tune") as ref:
        _log_events(ref.tune_loggers, str(tmp_path / "ref"))
    _log_events(tloggers, str(tmp_path / "port"))
    ref_files = sorted(p.relative_to(tmp_path / "ref")
                       for p in (tmp_path / "ref").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*")
                        if p.is_file())
    assert port_files == ref_files and len(ref_files) == 6
    for rel in ref_files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "ref" / rel).read_bytes(), rel


def test_gated_searchers_raise_like_the_reference():
    for name in ("HyperOptSearch", "TuneBOHB", "AxSearch"):
        with jax_reference("tune") as ref:
            with pytest.raises(ImportError) as want:
                getattr(ref.tune_search, name)()
        with pytest.raises(ImportError) as got:
            getattr(tsearch, name)()
        assert type(got.value) is type(want.value)
        assert str(got.value).split(",")[0] == str(want.value).split(",")[0]
