"""Search space + variant generation.

Port of ``ray_tpu/tune/search.py`` (reference: python/ray/tune/search/
{sample.py,basic_variant.py} — grid_search cross products with random
sampling for distribution params), unchanged: host code with no tensor
math. The adapters over optional packages (OptunaSearch, HyperOptSearch,
TuneBOHB, AxSearch) import them only when made and raise ImportError
naming the package when it is absent.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


class Sampler:
    def sample(self, rng: random.Random):
        raise NotImplementedError


class Choice(Sampler):
    def __init__(self, values):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)


class Uniform(Sampler):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.uniform(self.lo, self.hi)


class LogUniform(Sampler):
    def __init__(self, lo, hi):
        import math

        self.lo, self.hi = math.log(lo), math.log(hi)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.lo, self.hi))


class RandInt(Sampler):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.randrange(self.lo, self.hi)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def choice(values) -> Choice:
    return Choice(values)


def uniform(lo, hi) -> Uniform:
    return Uniform(lo, hi)


def loguniform(lo, hi) -> LogUniform:
    return LogUniform(lo, hi)


def randint(lo, hi) -> RandInt:
    return RandInt(lo, hi)


def sample_config(param_space: Dict[str, Any], rng: random.Random,
                  grid_combo: Dict[str, Any] | None = None) -> Dict[str, Any]:
    cfg = {}
    for k, v in param_space.items():
        if isinstance(v, GridSearch):
            cfg[k] = (grid_combo or {}).get(k, rng.choice(v.values))
        elif isinstance(v, Sampler):
            cfg[k] = v.sample(rng)
        else:
            cfg[k] = v
    return cfg


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Grid params cross-product; sampler params drawn per sample
    (ref: basic_variant.py — num_samples repeats the grid)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
    grids = [param_space[k].values for k in grid_keys]
    combos = list(itertools.product(*grids)) if grid_keys else [()]
    variants = []
    for _ in range(max(1, num_samples)):
        for combo in combos:
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Sampler):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants


# ---- searcher API -----------------------------------------------------------
# Reference: python/ray/tune/search/searcher.py — Searcher.suggest /
# on_trial_complete drive ask/tell search algorithms (Optuna, HyperOpt, ...).
# Here the algorithms are implemented natively instead of wrapping third-party
# libraries.

class Searcher:
    """Ask/tell interface: the Tuner calls suggest() to obtain configs and
    on_trial_complete() with the final result."""

    def __init__(self, metric: str | None = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: str | None, mode: str,
                              param_space: Dict[str, Any]) -> None:
        if self.metric is None:
            self.metric = metric
        if mode:
            self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Dict[str, Any] | None:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product + random sampling (ref: search/basic_variant.py)."""

    def __init__(self, num_samples: int = 1, seed: int = 0):
        super().__init__()
        self.num_samples = num_samples
        self.seed = seed
        self._variants: List[Dict[str, Any]] | None = None
        self._next = 0

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        self._variants = generate_variants(param_space, self.num_samples,
                                           self.seed)

    def suggest(self, trial_id):
        if self._variants is None or self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


class RandomSearch(Searcher):
    """Pure random sampling from the space, unbounded (until num_samples
    trials have been asked for by the controller)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.rng = random.Random(seed)

    def suggest(self, trial_id):
        return sample_config(self.param_space, self.rng)


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator (the algorithm behind the
    reference's OptunaSearch/HyperOptSearch defaults, implemented directly).

    Observations are split at the gamma-quantile into good/bad sets; numeric
    params are modeled as Parzen windows (gaussian KDE centered on past
    samples), categorical params as weighted categoricals; candidates are
    drawn from the good model and scored by the density ratio l(x)/g(x).
    """

    def __init__(self, metric: str | None = None, mode: str = "max",
                 n_startup_trials: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        super().__init__(metric, mode)
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._history: List[tuple[Dict[str, Any], float]] = []

    def on_trial_complete(self, trial_id, result=None, error=False):
        if error or not result or self.metric not in result:
            return
        val = float(result[self.metric])
        if self.mode == "min":
            val = -val
        self._history.append((result["config"], val))

    # -- per-parameter density models --
    def _split(self):
        ordered = sorted(self._history, key=lambda cv: -cv[1])
        n_good = max(1, int(len(ordered) * self.gamma))
        return ordered[:n_good], ordered[n_good:]

    @staticmethod
    def _kde_logpdf(x, centers, bw):
        import math

        if not centers:
            return 0.0
        acc = 0.0
        for c in centers:
            acc += math.exp(-0.5 * ((x - c) / bw) ** 2)
        return math.log(acc / len(centers) + 1e-12)

    def _score(self, key, spec, value, good, bad):
        import math

        gvals = [c[key] for c, _ in good if key in c]
        bvals = [c[key] for c, _ in bad if key in c]
        if isinstance(spec, (Choice, GridSearch)):
            values = spec.values
            gw = (gvals.count(value) + 1) / (len(gvals) + len(values))
            bw_ = (bvals.count(value) + 1) / (len(bvals) + len(values))
            return math.log(gw) - math.log(bw_)
        # numeric: bandwidth from the prior range
        if isinstance(spec, (Uniform, LogUniform, RandInt)):
            lo, hi = spec.lo, spec.hi
            x = math.log(value) if isinstance(spec, LogUniform) else value
            g_centers = [math.log(v) if isinstance(spec, LogUniform) else v
                         for v in gvals]
            b_centers = [math.log(v) if isinstance(spec, LogUniform) else v
                         for v in bvals]
            bw = max((hi - lo) / 5.0, 1e-9)
            return (self._kde_logpdf(x, g_centers, bw)
                    - self._kde_logpdf(x, b_centers, bw))
        return 0.0

    def _sample_from_good(self, key, spec, good):
        """Draw from the good-set Parzen model (fall back to the prior)."""
        gvals = [c[key] for c, _ in good if key in c]
        if not gvals or self.rng.random() < 0.2:
            return sample_config({key: spec}, self.rng)[key]
        if isinstance(spec, (Choice, GridSearch)):
            return self.rng.choice(gvals)
        if isinstance(spec, (Uniform, LogUniform, RandInt)):
            import math

            lo, hi = spec.lo, spec.hi
            center = self.rng.choice(gvals)
            x = math.log(center) if isinstance(spec, LogUniform) else center
            bw = max((hi - lo) / 5.0, 1e-9)
            x = self.rng.gauss(x, bw)
            x = max(lo, min(hi, x))
            if isinstance(spec, LogUniform):
                return math.exp(x)
            if isinstance(spec, RandInt):
                return int(round(max(spec.lo, min(spec.hi - 1, x))))
            return x
        return sample_config({key: spec}, self.rng)[key]

    def suggest(self, trial_id):
        tunable = {k: v for k, v in self.param_space.items()
                   if isinstance(v, (Sampler, GridSearch))}
        fixed = {k: v for k, v in self.param_space.items()
                 if not isinstance(v, (Sampler, GridSearch))}
        if len(self._history) < self.n_startup:
            return {**fixed, **sample_config(tunable, self.rng)}
        good, bad = self._split()
        best, best_score = None, float("-inf")
        for _ in range(self.n_candidates):
            cand = {k: self._sample_from_good(k, v, good)
                    for k, v in tunable.items()}
            score = sum(self._score(k, v, cand[k], good, bad)
                        for k, v in tunable.items())
            if score > best_score:
                best, best_score = cand, score
        return {**fixed, **best}


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (ref: search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        self.searcher.set_search_properties(metric, mode, param_space)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return "PENDING"
        cfg = self.searcher.suggest(trial_id)
        if isinstance(cfg, dict):
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class BayesOptSearch(Searcher):
    """GP-based Bayesian optimization with Expected Improvement
    (ref: search/bayesopt/bayesopt_search.py — the reference wraps the
    `bayesian-optimization` package; this is the same GP+EI loop on
    sklearn's GaussianProcessRegressor, imported when the searcher is used).

    Numeric params (Uniform/LogUniform/RandInt) are modeled in a unit
    hypercube (log-space for LogUniform); Choice params are sampled
    randomly per suggestion (categorical kernels are out of scope, as in
    the reference's wrapper).
    """

    def __init__(self, metric: str | None = None, mode: str = "max",
                 n_startup_trials: int = 6, n_candidates: int = 256,
                 xi: float = 0.01, seed: int = 0):
        super().__init__(metric, mode)
        self.n_startup = n_startup_trials
        self.n_candidates = n_candidates
        self.xi = xi
        import numpy as _np

        self._np = _np
        self.rng = _np.random.default_rng(seed)
        self._pyrng = random.Random(seed)
        self._X: List[List[float]] = []
        self._y: List[float] = []

    def _numeric_keys(self):
        out = []
        for k, v in sorted(self.param_space.items()):
            if isinstance(v, (Uniform, LogUniform, RandInt)):
                out.append((k, v))
        return out

    def _encode(self, cfg) -> List[float]:
        import math

        x = []
        for k, spec in self._numeric_keys():
            v = float(cfg[k])
            if isinstance(spec, LogUniform):
                x.append((math.log(v) - spec.lo) / (spec.hi - spec.lo))
            elif isinstance(spec, RandInt):
                x.append((v - spec.lo) / max(1, spec.hi - 1 - spec.lo))
            else:
                x.append((v - spec.lo) / (spec.hi - spec.lo))
        return x

    def _decode(self, x) -> Dict[str, Any]:
        import math

        cfg = {}
        for (k, spec), u in zip(self._numeric_keys(), x):
            u = min(1.0, max(0.0, float(u)))
            if isinstance(spec, LogUniform):
                cfg[k] = math.exp(spec.lo + u * (spec.hi - spec.lo))
            elif isinstance(spec, RandInt):
                cfg[k] = int(round(spec.lo + u * max(1, spec.hi - 1
                                                     - spec.lo)))
            else:
                cfg[k] = spec.lo + u * (spec.hi - spec.lo)
        return cfg

    def _non_numeric(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, Choice):
                cfg[k] = v.sample(self._pyrng)
            elif isinstance(v, GridSearch):
                cfg[k] = self._pyrng.choice(v.values)
            elif not isinstance(v, Sampler):
                cfg[k] = v
        return cfg

    def suggest(self, trial_id):
        np = self._np
        keys = self._numeric_keys()
        if not keys:
            return {**self._non_numeric()}
        d = len(keys)
        if len(self._y) < self.n_startup:
            u = self.rng.random(d)
            return {**self._non_numeric(), **self._decode(u)}

        from sklearn.gaussian_process import GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import Matern

        gp = GaussianProcessRegressor(
            kernel=Matern(nu=2.5), alpha=1e-6, normalize_y=True,
            random_state=int(self.rng.integers(1 << 31)))
        gp.fit(np.asarray(self._X), np.asarray(self._y))
        cand = self.rng.random((self.n_candidates, d))
        mu, sigma = gp.predict(cand, return_std=True)
        best = max(self._y)
        sigma = np.maximum(sigma, 1e-9)
        z = (mu - best - self.xi) / sigma
        from scipy.stats import norm  # scipy ships with sklearn deps

        ei = (mu - best - self.xi) * norm.cdf(z) + sigma * norm.pdf(z)
        return {**self._non_numeric(),
                **self._decode(cand[int(np.argmax(ei))])}

    def on_trial_complete(self, trial_id, result=None, error=False):
        if error or not result or self.metric not in result:
            return
        val = float(result[self.metric])
        if self.mode == "min":
            val = -val
        cfg = result["config"]
        try:
            self._X.append(self._encode(cfg))
            self._y.append(val)
        except (KeyError, ValueError):
            pass


def _gated_searcher(name: str, package: str):
    """External-library searcher surface (ref: tune/search/{optuna,
    hyperopt,bohb,ax}.py — thin wrappers over optional packages). None of
    them is a dependency; constructing one raises with install guidance.
    Built-in equivalents: TPESearcher (HyperOpt/Optuna-class TPE) and
    BayesOptSearch (GP+EI)."""

    class _Gated(Searcher):
        def __init__(self, *a, **k):
            raise ImportError(
                f"{name} needs the '{package}' package, which is not "
                f"installed. Install it in your driver environment, "
                f"or use the built-in TPESearcher / BayesOptSearch.")

    _Gated.__name__ = name
    _Gated.__qualname__ = name
    return _Gated


class OptunaSearch(Searcher):
    """Adapter over optuna's ask/tell Study API (ref:
    python/ray/tune/search/optuna/optuna_search.py). Our samplers map onto
    optuna distributions: Uniform→suggest_float, LogUniform→log float,
    RandInt→suggest_int, Choice/GridSearch→suggest_categorical. optuna is
    not a dependency; the class constructs against any module exposing
    create_study/ask/tell (exercised in CI via a mock), and against the
    real package when installed in a driver env."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 sampler=None, seed: Optional[int] = None):
        super().__init__(metric, mode)
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearch needs the 'optuna' package, which is not "
                "installed. Install it in your driver environment, or "
                "use the built-in TPESearcher / BayesOptSearch.") from e
        self._optuna = optuna
        self.param_space = space or {}
        self._sampler = sampler
        self._seed = seed
        self._study = None
        self._trials: Dict[str, Any] = {}
        self._cfgs: Dict[str, dict] = {}     # trial_id -> suggested cfg
        #: completed observations (cfg, value, failed) — the picklable
        #: record of what the study has seen; replayed into a fresh study
        #: after Tuner.restore unpickles this searcher
        self._history: list = []

    # The live optuna module/Study/Trial objects don't pickle, which would
    # make Tuner's controller.pkl snapshot silently fail for this adapter.
    # Pickle the observation history instead and replay it on restore.
    def __getstate__(self):
        state = dict(self.__dict__)
        for k in ("_optuna", "_study", "_trials"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        import optuna

        self._optuna = optuna
        self._study = None
        self._trials = {}

    def set_search_properties(self, metric, mode, param_space):
        if self.metric is None:
            self.metric = metric
        if mode:
            self.mode = mode
        # a constructor-provided space wins over an empty Tuner space
        # (ref: the reference adapter refuses to overwrite a set space)
        if param_space or not self.param_space:
            self.param_space = param_space

    def _ensure_study(self):
        if self.metric is None:
            raise ValueError(
                "OptunaSearch needs a metric (constructor or "
                "TuneConfig.metric) — without one every completed trial "
                "would be reported to optuna as failed")
        if self._study is None:
            optuna = self._optuna
            sampler = self._sampler
            if sampler is None and self._seed is not None:
                sampler = optuna.samplers.TPESampler(seed=self._seed)
            self._study = optuna.create_study(
                direction="maximize" if self.mode == "max" else "minimize",
                sampler=sampler)
            completed = [(cfg, value) for cfg, value, failed in self._history
                         if not failed and value is not None]
            if completed:
                try:
                    dists = self._distributions()
                    for cfg, value in completed:
                        self._study.add_trial(optuna.trial.create_trial(
                            params={k: v for k, v in cfg.items()
                                    if k in dists},
                            distributions=dists, value=value))
                except Exception:
                    # replay is best-effort: a study that forgot history
                    # still suggests valid configs
                    pass
        return self._study

    def _distributions(self):
        import math

        optuna = self._optuna
        dist = {}
        for k, v in self.param_space.items():
            if isinstance(v, LogUniform):
                dist[k] = optuna.distributions.FloatDistribution(
                    math.exp(v.lo), math.exp(v.hi), log=True)
            elif isinstance(v, Uniform):
                dist[k] = optuna.distributions.FloatDistribution(v.lo, v.hi)
            elif isinstance(v, RandInt):
                dist[k] = optuna.distributions.IntDistribution(v.lo, v.hi - 1)
            elif isinstance(v, (Choice, GridSearch)):
                dist[k] = optuna.distributions.CategoricalDistribution(
                    v.values)
        return dist

    def suggest(self, trial_id):
        study = self._ensure_study()
        t = study.ask()
        import math

        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, LogUniform):
                cfg[k] = t.suggest_float(k, math.exp(v.lo), math.exp(v.hi),
                                         log=True)
            elif isinstance(v, Uniform):
                cfg[k] = t.suggest_float(k, v.lo, v.hi)
            elif isinstance(v, RandInt):
                cfg[k] = t.suggest_int(k, v.lo, v.hi - 1)
            elif isinstance(v, (Choice, GridSearch)):
                cfg[k] = t.suggest_categorical(k, v.values)
            else:
                cfg[k] = v
        self._trials[trial_id] = t
        self._cfgs[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        t = self._trials.pop(trial_id, None)
        cfg = self._cfgs.pop(trial_id, None)
        if t is None:
            return
        study = self._ensure_study()
        if error or not result or self.metric not in result:
            study.tell(t, state=self._optuna.trial.TrialState.FAIL)
            if cfg is not None:
                self._history.append((cfg, None, True))
        else:
            val = float(result[self.metric])
            study.tell(t, val)
            if cfg is not None:
                self._history.append((cfg, val, False))


HyperOptSearch = _gated_searcher("HyperOptSearch", "hyperopt")
TuneBOHB = _gated_searcher("TuneBOHB", "hpbandster")
AxSearch = _gated_searcher("AxSearch", "ax-platform")
