"""The port's OptunaSearch adapter (ray_tpu_torch/tune/search.py),
exercised against a mock optuna module — tests/test_tune_optuna.py's
cases re-aimed at ``ray_tpu_torch.tune``; none needs the real package.

Covers VERDICT r2 item 10: the optuna-gated surface must have executed at
least once before a user reaches for it. The mock implements the slice of
optuna's ask/tell Study API the adapter uses (create_study, Trial.suggest_*,
study.tell, samplers.TPESampler, trial.TrialState), so the adapter's
distribution mapping and completion plumbing run for real; the real package
slots in unchanged when installed in a driver env.
"""

import sys
import types

import pytest

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


class _MockTrial:
    def __init__(self, number, rng):
        self.number = number
        self._rng = rng
        self.params = {}

    def suggest_float(self, name, lo, hi, log=False):
        if log:
            import math

            v = math.exp(self._rng.uniform(math.log(lo), math.log(hi)))
        else:
            v = self._rng.uniform(lo, hi)
        self.params[name] = ("float", lo, hi, log, v)
        return v

    def suggest_int(self, name, lo, hi):
        v = self._rng.randint(lo, hi)
        self.params[name] = ("int", lo, hi, v)
        return v

    def suggest_categorical(self, name, values):
        v = self._rng.choice(list(values))
        self.params[name] = ("cat", tuple(values), v)
        return v


class _MockStudy:
    def __init__(self, direction, sampler):
        self.direction = direction
        self.sampler = sampler
        self.told = []
        self._n = 0
        import random

        self._rng = random.Random(getattr(sampler, "seed", 0) or 0)

    def ask(self):
        t = _MockTrial(self._n, self._rng)
        self._n += 1
        return t

    def tell(self, trial, value=None, state=None):
        self.told.append((trial.number, value, state))

    def add_trial(self, frozen):
        self.told.append(("replay", frozen["value"], None))


def _install_mock_optuna(monkeypatch):
    optuna = types.ModuleType("optuna")
    samplers = types.ModuleType("optuna.samplers")
    trialmod = types.ModuleType("optuna.trial")

    class TPESampler:
        def __init__(self, seed=None):
            self.seed = seed

    class TrialState:
        FAIL = "FAIL"

    samplers.TPESampler = TPESampler
    trialmod.TrialState = TrialState

    # distributions + replay surface (used by OptunaSearch restore)
    distmod = types.ModuleType("optuna.distributions")

    class _Dist:
        def __init__(self, *a, **k):
            self.args = a
            self.kw = k

    distmod.FloatDistribution = _Dist
    distmod.IntDistribution = _Dist
    distmod.CategoricalDistribution = _Dist
    optuna.distributions = distmod

    def create_trial(params=None, distributions=None, value=None):
        return {"params": params, "value": value}

    trialmod.create_trial = create_trial
    created = []

    def create_study(direction="maximize", sampler=None):
        s = _MockStudy(direction, sampler)
        created.append(s)
        return s

    optuna.create_study = create_study
    optuna.samplers = samplers
    optuna.trial = trialmod
    monkeypatch.setitem(sys.modules, "optuna", optuna)
    monkeypatch.setitem(sys.modules, "optuna.samplers", samplers)
    monkeypatch.setitem(sys.modules, "optuna.trial", trialmod)
    return created


def test_optuna_adapter_ask_tell(monkeypatch):
    created = _install_mock_optuna(monkeypatch)
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import OptunaSearch

    s = OptunaSearch(metric="score", mode="min", seed=7)
    s.set_search_properties("score", "min", {
        "lr": tune.loguniform(1e-4, 1e-1),
        "width": tune.randint(8, 32),
        "act": tune.choice(["relu", "gelu"]),
        "drop": tune.uniform(0.0, 0.5),
        "fixed": 3,
    })
    cfg = s.suggest("trial_00000")
    assert 1e-4 <= cfg["lr"] <= 1e-1
    assert 8 <= cfg["width"] <= 31 and isinstance(cfg["width"], int)
    assert cfg["act"] in ("relu", "gelu")
    assert 0.0 <= cfg["drop"] <= 0.5
    assert cfg["fixed"] == 3
    study = created[0]
    assert study.direction == "minimize"
    assert study.sampler.seed == 7

    s.on_trial_complete("trial_00000", {"score": 1.5, "config": cfg})
    assert study.told == [(0, 1.5, None)]
    # failed trial reported as FAIL, not a value
    s.suggest("trial_00001")
    s.on_trial_complete("trial_00001", None, error=True)
    assert study.told[1][2] == "FAIL"
    # completing an unknown trial is a no-op
    s.on_trial_complete("trial_99999", {"score": 0.0})
    assert len(study.told) == 2


def test_optuna_adapter_through_tuner(monkeypatch, ray_start_regular):
    _install_mock_optuna(monkeypatch)
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.search import OptunaSearch

    def objective(config):
        return {"loss": (config["x"] - 0.7) ** 2}

    tuner = Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=TuneConfig(metric="loss", mode="min", num_samples=6,
                               search_alg=OptunaSearch(metric="loss",
                                                       mode="min", seed=3)))
    grid = tuner.fit()
    assert len(grid) == 6
    assert not grid.errors
    best = grid.get_best_result()
    assert 0.0 <= best.config["x"] <= 1.0


def test_optuna_constructor_space_survives_empty_tuner_space(monkeypatch):
    _install_mock_optuna(monkeypatch)
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import OptunaSearch

    s = OptunaSearch(space={"x": tune.uniform(0, 1)}, metric="m")
    s.set_search_properties("m", "max", {})  # Tuner had no param_space
    cfg = s.suggest("t0")
    assert "x" in cfg and 0 <= cfg["x"] <= 1


def test_optuna_requires_metric(monkeypatch):
    _install_mock_optuna(monkeypatch)
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import OptunaSearch

    s = OptunaSearch(space={"x": tune.uniform(0, 1)})
    with pytest.raises(ValueError, match="metric"):
        s.suggest("t0")


def test_optuna_gate_raises_without_package():
    if "optuna" in sys.modules:
        pytest.skip("optuna importable in this env")
    from ray_tpu_torch.tune.search import OptunaSearch

    with pytest.raises(ImportError, match="optuna"):
        OptunaSearch(metric="m")


def test_optuna_adapter_pickles_with_history(monkeypatch):
    """The adapter must survive pickle (Tuner's controller.pkl snapshot):
    live module/study/trial handles are dropped, the observation history
    rides along and replays into the fresh study on restore."""
    import pickle

    _install_mock_optuna(monkeypatch)
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import OptunaSearch

    s = OptunaSearch(metric="score", mode="max", seed=11)
    s.set_search_properties("score", "max", {"x": tune.uniform(0.0, 1.0)})
    cfg = s.suggest("t0")
    s.on_trial_complete("t0", {"score": 2.5, "config": cfg})

    blob = pickle.dumps(s)          # would raise before the __getstate__ fix
    s2 = pickle.loads(blob)
    assert s2._history == [(cfg, 2.5, False)]
    # the revived adapter keeps suggesting from the same space
    cfg2 = s2.suggest("t1")
    assert 0.0 <= cfg2["x"] <= 1.0
