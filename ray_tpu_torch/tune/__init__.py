"""ray_tpu_torch.tune: hyperparameter search over trial actors.

Port of ``ray_tpu/tune`` (host code: no tensor math of its own; importing
it loads no torch). Reference: python/ray/tune/ — Tuner.fit (tuner.py:320) → TuneController
event loop (execution/tune_controller.py:49,267) over Trainable actors,
search algorithms (search/basic_variant.py grid/random), trial schedulers
(schedulers/async_hyperband.py ASHA), trial FSM (experiment/trial.py).

    from ray_tpu_torch import tune

    def objective(config):
        for step in range(10):
            tune.report({"score": step * config["lr"]})

    results = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.1, 0.01])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    best = results.get_best_result()

A trial that wants the card asks for it:
``TuneConfig(resources_per_trial={"CPU": 1, "GPU": 1})`` (the unit
``num_gpus=`` counts); there is no CPU fallback for such a trial.
"""

from ray_tpu_torch.tune.search import (AxSearch, BasicVariantGenerator,
                                 ConcurrencyLimiter, HyperOptSearch,
                                 OptunaSearch, TuneBOHB,
                                 BayesOptSearch, RandomSearch, Searcher,
                                 TPESearcher, choice,
                                 grid_search, loguniform, randint, uniform)
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                     HyperBandScheduler, MedianStoppingRule,
                                     PopulationBasedTraining)
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig, Tuner,
                                get_checkpoint, get_trial_context, report)
from ray_tpu_torch.tune.loggers import (CSVLoggerCallback, JsonLoggerCallback,
                                  LoggerCallback, MLflowLoggerCallback,
                                  TBXLoggerCallback, WandbLoggerCallback)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TrialResult", "report",
    "get_checkpoint", "get_trial_context", "grid_search", "choice",
    "uniform", "loguniform", "randint", "ASHAScheduler", "FIFOScheduler",
    "HyperBandScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "Searcher", "BasicVariantGenerator", "RandomSearch", "TPESearcher",
    "BayesOptSearch",
    "ConcurrencyLimiter",
    "OptunaSearch", "HyperOptSearch", "TuneBOHB", "AxSearch",
    "LoggerCallback", "CSVLoggerCallback", "JsonLoggerCallback",
    "TBXLoggerCallback", "MLflowLoggerCallback", "WandbLoggerCallback",
]
