"""Trial schedulers.

Port of ``ray_tpu/tune/schedulers.py``, unchanged (host code). Reference:
python/ray/tune/schedulers/ — FIFOScheduler (no-op) and ASHA
(async_hyperband.py): asynchronous successive halving on reported metrics;
a trial that falls below the rung's top-1/reduction_factor quantile at a
milestone is stopped.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE


class ASHAScheduler:
    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        # rung milestones: grace * rf^k up to max_t
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(t)
            t *= reduction_factor
        self.rungs: Dict[int, Dict[str, float]] = defaultdict(dict)

    def on_result(self, trial_id: str, result: dict) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        val = float(metric) if self.mode == "max" else -float(metric)
        # Re-check on EVERY report against the highest crossed milestone
        # (ref: async_hyperband.py _Bracket.on_result) — a trial that was
        # first to record at a rung must still be halted once
        # later-arriving peers push the cutoff above it; checking only at
        # the first crossing lets a leading loser run to max_t.
        for ms in reversed(self.milestones):
            if t < ms:
                continue
            rung = self.rungs[ms]
            # record once, at the milestone crossing — overwriting with
            # later (bigger-budget) values would make rung comparisons
            # budget-unfair to trials arriving at the milestone on time
            if trial_id not in rung:
                rung[trial_id] = val
            peers = sorted(rung.values(), reverse=True)
            k = max(1, len(peers) // self.rf)
            cutoff = peers[k - 1]
            if len(peers) >= self.rf and rung[trial_id] < cutoff:
                return STOP
            break  # only the top crossed rung gates continuation
        return CONTINUE


class MedianStoppingRule:
    """Stop a trial whose best result so far is worse than the median of the
    running-average results of other trials at the same point in time
    (ref: schedulers/median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: dict) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        val = float(metric) if self.mode == "max" else -float(metric)
        self._avgs[trial_id].append(val)
        if t < self.grace or len(self._avgs) < self.min_samples:
            return CONTINUE
        others = [sum(v) / len(v) for tid, v in self._avgs.items()
                  if tid != trial_id and v]
        if len(others) < self.min_samples - 1:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        best = max(self._avgs[trial_id])
        return STOP if best < median else CONTINUE


class HyperBandScheduler:
    """Bracketed successive halving (ref: schedulers/hyperband.py). Trials
    are assigned round-robin to brackets with different grace periods; each
    bracket runs ASHA-style halving at its own milestones."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 81, reduction_factor: int = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        # bracket s runs from grace rf^s with halving every rf
        import math

        s_max = int(math.log(max_t) / math.log(reduction_factor))
        self.brackets = []
        for s in range(s_max + 1):
            self.brackets.append(ASHAScheduler(
                time_attr=time_attr, metric=metric, mode=mode, max_t=max_t,
                grace_period=reduction_factor ** s,
                reduction_factor=reduction_factor))
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def on_result(self, trial_id: str, result: dict) -> str:
        if trial_id not in self._assignment:
            self._assignment[trial_id] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) % len(self.brackets)
        b = self.brackets[self._assignment[trial_id]]
        b.metric = b.metric or self.metric
        return b.on_result(trial_id, result)


class PopulationBasedTraining:
    """PBT (ref: schedulers/pbt.py): at every perturbation interval, a trial
    in the bottom quantile clones the checkpoint of a random top-quantile
    trial (exploit) and perturbs its hyperparameters (explore). The
    controller acts on the ("EXPLOIT", source_trial_id, new_config) decision
    by restarting the trial actor from the source checkpoint."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25, seed: int = 0):
        import random as _random

        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = _random.Random(seed)
        self._latest: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = defaultdict(int)
        self._configs: Dict[str, dict] = {}

    def _explore(self, config: dict) -> dict:
        """Perturb mutation params by 0.8x/1.2x or resample (ref:
        pbt.py explore())."""
        from ray_tpu_torch.tune.search import Sampler

        new = dict(config)
        for key, spec in self.mutations.items():
            if self.rng.random() < self.resample_prob or key not in new:
                if isinstance(spec, Sampler):
                    new[key] = spec.sample(self.rng)
                elif isinstance(spec, list):
                    new[key] = self.rng.choice(spec)
                elif callable(spec):
                    new[key] = spec()
            elif isinstance(new[key], (int, float)) and not isinstance(
                    new[key], bool):
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                new[key] = type(new[key])(new[key] * factor)
            elif isinstance(spec, list):
                # categorical: shift to a neighboring value
                try:
                    i = spec.index(new[key])
                    new[key] = spec[max(0, min(len(spec) - 1,
                                               i + self.rng.choice([-1, 1])))]
                except ValueError:
                    new[key] = self.rng.choice(spec)
        return new

    def on_result(self, trial_id: str, result: dict):
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        val = float(metric) if self.mode == "max" else -float(metric)
        self._latest[trial_id] = val
        self._configs[trial_id] = result.get("config",
                                             self._configs.get(trial_id, {}))
        if t - self._last_perturb[trial_id] < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        pop = sorted(self._latest.items(), key=lambda kv: -kv[1])
        n = len(pop)
        if n < 4:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        top = [tid for tid, _ in pop[:k]]
        bottom = {tid for tid, _ in pop[-k:]}
        if trial_id in bottom and trial_id not in top:
            source = self.rng.choice(top)
            new_config = self._explore(self._configs.get(source, {}))
            return ("EXPLOIT", source, new_config)
        return CONTINUE
