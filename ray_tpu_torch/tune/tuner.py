"""Tuner + trial controller.

Port of ``ray_tpu/tune/tuner.py`` over the port's runtime (trial actors
are ``ray_tpu_torch`` actors; a trial that asks for ``{"GPU": 1}`` in
``TuneConfig.resources_per_trial`` is placed only where a card is free,
and its actor's exit frees the card for the next). Reference:
tune/tuner.py:320 Tuner.fit → execution/tune_controller.py event
loop (step:267, actor scheduling :596): trials run as actors; the controller
polls reported results, feeds the scheduler, stops losers, and starts queued
trials as resources free up. Experiment state is snapshotted to the run dir
(ref: tune/execution/experiment_state.py).

Unlike the reference, a trial is launched only when the cluster can hold
its ``resources_per_trial`` (the reference starts every queued trial's
actor at once, and reports one that waits more than its poll timeout for
resources as lost, leaving that actor to start later unpolled). A trial
whose actor has not started yet is pending, never lost; the actor of a
trial finished as lost is killed.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.status import GetTimeoutError
from ray_tpu_torch.tune.schedulers import STOP, FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants


# ---- in-trial reporting API -------------------------------------------------

class _TrialContext:
    def __init__(self, trial_id: str, config: dict,
                 start_checkpoint: Any = None):
        self.trial_id = trial_id
        self.config = config
        self.reports: List[dict] = []
        self.lock = threading.Lock()
        self.iteration = 0
        self.stop_requested = False
        self.start_checkpoint = start_checkpoint
        self.latest_checkpoint: Any = None
        self.checkpoint_version = 0


_trial_ctx: Optional[_TrialContext] = None


def _set_trial_ctx(ctx: Optional[_TrialContext]) -> None:
    # NOTE: must be a module function called by reference. The @remote actor
    # class below ships to workers pickled BY VALUE (the module attribute is
    # the ActorClass wrapper, so cloudpickle cannot pickle the raw class by
    # reference), which gives its methods a COPY of these globals — a bare
    # `global` assignment inside a method would write to the copy while
    # tune.report reads the real module.
    global _trial_ctx
    _trial_ctx = ctx


def get_trial_context() -> Optional[_TrialContext]:
    return _trial_ctx


class TrialStopped(Exception):
    """Raised inside a trial when the scheduler has stopped it."""


def report(metrics: Dict[str, Any], checkpoint: Any = None) -> None:
    """ref: tune report / session.report — also the scheduler's stop
    injection point: raises TrialStopped if the controller killed us.
    `checkpoint` (any picklable payload, e.g. a params dict) enables
    PBT exploit transfer and restore."""
    ctx = _trial_ctx
    if ctx is None:
        raise RuntimeError("tune.report called outside a trial")
    ctx.iteration += 1
    entry = dict(metrics)
    entry.setdefault("training_iteration", ctx.iteration)
    entry["_ts"] = time.time()
    with ctx.lock:
        ctx.reports.append(entry)
        if checkpoint is not None:
            ctx.latest_checkpoint = checkpoint
            ctx.checkpoint_version += 1
    if ctx.stop_requested:
        raise TrialStopped()


def get_checkpoint() -> Any:
    """Checkpoint handed to this trial at start (PBT exploit or restore);
    None on a fresh start. ref: train.get_checkpoint in function trainables."""
    ctx = _trial_ctx
    if ctx is None:
        raise RuntimeError("tune.get_checkpoint called outside a trial")
    return ctx.start_checkpoint


@ray_tpu_torch.remote
class _TrialActor:
    def __init__(self, trial_id: str, config: dict,
                 start_checkpoint: Any = None):
        self.ctx = _TrialContext(trial_id, config, start_checkpoint)
        self.error: Optional[str] = None
        self.done = False
        self.final: Any = None

    def run(self, fn: Callable) -> Any:
        _set_trial_ctx(self.ctx)
        try:
            self.final = fn(self.ctx.config)
            if isinstance(self.final, dict):
                with self.ctx.lock:
                    entry = dict(self.final)
                    entry.setdefault("training_iteration",
                                     self.ctx.iteration + 1)
                    self.ctx.reports.append(entry)
            return self.final
        except TrialStopped:
            return None
        except BaseException:
            import traceback

            self.error = traceback.format_exc()
            raise
        finally:
            self.done = True

    def poll(self, after: int, ckpt_seen: int = -1) -> dict:
        with self.ctx.lock:
            new = self.ctx.reports[after:]
            out = {"reports": new, "done": self.done, "error": self.error,
                   "ckpt_version": self.ctx.checkpoint_version}
            if self.ctx.checkpoint_version > ckpt_seen >= 0:
                out["checkpoint"] = self.ctx.latest_checkpoint
        return out

    def request_stop(self):
        self.ctx.stop_requested = True
        return True


# ---- results ----------------------------------------------------------------

@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[dict] = field(default_factory=list)
    error: Optional[str] = None
    stopped_early: bool = False


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric configured")

        def last_value(r: TrialResult):
            if metric in r.metrics:
                return r.metrics[metric]
            for entry in reversed(r.metrics_history):
                if metric in entry:
                    return entry[metric]
            return None

        valid = [(r, last_value(r)) for r in self._results]
        valid = [(r, v) for r, v in valid if v is not None]
        if not valid:
            raise ValueError(f"no trial reported metric {metric!r}")
        best = (max if mode == "max" else min)(valid, key=lambda rv: rv[1])
        return best[0]

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([{**r.config, **r.metrics,
                              "trial_id": r.trial_id} for r in self._results])

    @property
    def errors(self) -> List[TrialResult]:
        return [r for r in self._results if r.error]


# how long the controller waits on a started trial's poll before it
# finishes the trial as lost
POLL_TIMEOUT_S = 30.0
# how long it waits, each tick, on the first poll of a trial whose actor
# has not started (still waiting for its resources, or in __init__)
PENDING_POLL_S = 0.05


def _can_hold(need: Dict[str, float], waiting: int) -> bool:
    """Whether the cluster can place one more trial asking `need` while
    `waiting` launched trials (asking the same) are not placed yet: the
    cluster's free resources less theirs hold `need`, and some node's
    free resources hold it. A trial that no node could ever hold is
    launched alone (a node may be added for it) and waits as pending."""
    from ray_tpu_torch.core import runtime as _rt

    per_node = list(_rt.get_runtime().gcs_call(
        "get_available_resources").values())
    free: Dict[str, float] = {}
    for q in per_node:
        for k, v in q.items():
            free[k] = free.get(k, 0.0) + v

    def holds(avail, k_waiting):
        return all(avail.get(k, 0.0) - k_waiting * v >= v - 1e-9
                   for k, v in need.items())

    if holds(free, waiting) and any(holds(q, 0) for q in per_node):
        return True
    total = ray_tpu_torch.cluster_resources()
    return waiting == 0 and not holds(total, 0)


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    search_alg: Any = None  # a tune.search.Searcher (ask/tell); None = basic variants
    seed: int = 0
    resources_per_trial: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: Optional[dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config
        #: experiment ledger: trial_id -> {config, status, metrics, error,
        #: stopped_early, has_ckpt}; mirrored to experiment_state.json after
        #: every transition so a killed driver can be restored
        self._exp: Dict[str, dict] = {}
        self._restored = False

    # ---- experiment-state persistence (ref: tune/tuner.py:180 restore +
    #      tune/execution/experiment_state.py snapshots) ------------------

    @classmethod
    def restore(cls, path: str, trainable: Optional[Callable] = None,
                *, resume_errored: bool = False) -> "Tuner":
        """Recover a sweep whose driver died (ref: Tuner.restore,
        python/ray/tune/tuner.py:180). `path` is the run dir
        (storage_path/name). Completed trials keep their results;
        queued/running trials are re-launched, running ones from their
        last persisted checkpoint. Pass `trainable` when the original one
        doesn't pickle; `resume_errored` also re-runs failed trials."""
        import pickle

        with open(os.path.join(path, "tuner.pkl"), "rb") as f:
            meta = pickle.load(f)
        if trainable is None:
            try:
                import cloudpickle

                with open(os.path.join(path, "trainable.pkl"), "rb") as f:
                    trainable = cloudpickle.load(f)
            except Exception as e:
                raise ValueError(
                    "the original trainable could not be recovered from "
                    f"{path} ({e}); pass Tuner.restore(path, "
                    "trainable=...)") from e
        tuner = cls(trainable, param_space=meta["param_space"] or {},
                    tune_config=meta["tune_config"] or TuneConfig(),
                    run_config=meta["run_config"])
        with open(os.path.join(path, "experiment_state.json")) as f:
            tuner._exp = json.load(f)["trials"]
        # configs round-trip through pickle, not JSON — json.dump(default=
        # str) stringifies non-JSON values (np dtypes, tuples) and a
        # restored trial must see exactly what the original saw
        cfgs = os.path.join(path, "configs.pkl")
        if os.path.exists(cfgs):
            with open(cfgs, "rb") as f:
                side = pickle.load(f)
            if "configs" not in side:               # pre-r3 format
                side = {"configs": side, "metrics": {}}
            for tid, cfg in side["configs"].items():
                if tid in tuner._exp:
                    tuner._exp[tid]["config"] = cfg
            for tid, mets in side["metrics"].items():
                if tid in tuner._exp:
                    tuner._exp[tid]["metrics"] = mets
        ctrl = os.path.join(path, "controller.pkl")
        if os.path.exists(ctrl):  # searcher/scheduler mid-sweep state
            try:
                with open(ctrl, "rb") as f:
                    st = pickle.load(f)
                if st.get("searcher") is not None:
                    tuner.tune_config.search_alg = st["searcher"]
                if st.get("scheduler") is not None:
                    tuner.tune_config.scheduler = st["scheduler"]
            except Exception:
                pass  # fall back to fresh searcher over remaining trials
        if resume_errored:
            for rec in tuner._exp.values():
                if rec["status"] == "done" and rec.get("error"):
                    rec.update(status="queued", error=None, metrics={})
        tuner._restored = True
        # restore() must point at the same run dir
        if tuner.run_config is None or not getattr(
                tuner.run_config, "storage_path", None):
            from ray_tpu_torch.train.config import RunConfig

            # abspath: dirname of a bare relative run dir is "" which
            # would silently disable all persistence for the restored run
            apath = os.path.abspath(path.rstrip("/"))
            tuner.run_config = RunConfig(
                name=os.path.basename(apath),
                storage_path=os.path.dirname(apath))
        return tuner

    def _snapshot(self, run_dir: Optional[str]) -> None:
        import pickle

        if not run_dir:
            return
        tmp = os.path.join(run_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump({"trials": self._exp}, f, indent=2, default=str)
        os.replace(tmp, os.path.join(run_dir, "experiment_state.json"))
        # exact (typed) configs AND metrics ride a pickle sidecar — the
        # json (default=str) stringifies np/jnp scalars, and a restored
        # trial must see exactly what the original saw; the json stays
        # human-readable for status polling
        tmp2 = os.path.join(run_dir, ".configs.tmp")

        def picklable(tree: dict) -> dict:
            # drop only the offending entries — one unpicklable metric
            # value must not discard every typed config
            out = {}
            for tid, val in tree.items():
                try:
                    pickle.dumps(val)
                    out[tid] = val
                except Exception:
                    pass
            return out

        try:
            with open(tmp2, "wb") as f:
                pickle.dump({"configs": picklable(
                    {tid: rec["config"] for tid, rec in self._exp.items()}),
                    "metrics": picklable(
                    {tid: rec["metrics"] for tid, rec in self._exp.items()})},
                    f)
            os.replace(tmp2, os.path.join(run_dir, "configs.pkl"))
        except Exception:
            pass  # sidecar is best-effort: restore falls back to json

    def _save_meta(self, run_dir: Optional[str]) -> None:
        import pickle

        if not run_dir:
            return
        try:
            # by-value for __main__/script functions, same as task export
            from ray_tpu_torch.core.runtime import _dumps_function

            blob = _dumps_function(self.trainable)
            with open(os.path.join(run_dir, "trainable.pkl"), "wb") as f:
                f.write(blob)
        except Exception:
            pass  # restore() will require an explicit trainable
        meta = {}
        for key, val in (("param_space", self.param_space),
                         ("tune_config", self.tune_config),
                         ("run_config", self.run_config)):
            try:
                pickle.dumps(val)
                meta[key] = val
            except Exception:
                # unpicklable scheduler/callback/etc: the run proceeds,
                # restore degrades to defaults for this piece
                meta[key] = None
        with open(os.path.join(run_dir, "tuner.pkl"), "wb") as f:
            pickle.dump(meta, f)

    def _save_controller(self, run_dir: Optional[str], searcher,
                         scheduler) -> None:
        import pickle

        if not run_dir:
            return
        try:
            blob = pickle.dumps({"searcher": searcher,
                                 "scheduler": scheduler})
        except Exception:
            return  # unpicklable searcher: restore falls back to fresh
        tmp = os.path.join(run_dir, ".controller.tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(run_dir, "controller.pkl"))

    def _ckpt_file(self, run_dir: str, tid: str) -> str:
        return os.path.join(run_dir, f"ckpt_{tid}.pkl")

    def _persist_trial_ckpt(self, run_dir: Optional[str], tid: str,
                            payload: Any) -> None:
        import pickle

        if not run_dir:
            return
        tmp = self._ckpt_file(run_dir, tid) + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)
            os.replace(tmp, self._ckpt_file(run_dir, tid))
            if not self._exp[tid].get("has_ckpt"):
                self._exp[tid]["has_ckpt"] = True
                self._snapshot(run_dir)
        except Exception:
            pass  # unpicklable payload: restore starts the trial fresh

    def _load_trial_ckpt(self, run_dir: Optional[str], tid: str) -> Any:
        import pickle

        if not run_dir:
            return None
        try:
            with open(self._ckpt_file(run_dir, tid), "rb") as f:
                return pickle.load(f)
        except Exception:
            return None

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        if getattr(scheduler, "metric", None) is None and hasattr(scheduler, "metric"):
            scheduler.metric = tc.metric
        searcher = tc.search_alg
        run_dir = self._run_dir()
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._save_meta(run_dir)
        results: Dict[str, TrialResult] = {}
        if searcher is not None:
            # also on restore: the searcher may be a fresh instance (no
            # controller.pkl yet) that never saw the space; adapters keep
            # their own space when the incoming one is empty
            searcher.set_search_properties(tc.metric, tc.mode,
                                           self.param_space)
            total = tc.num_samples
            pending: List = []  # searcher asked on demand
        else:
            if not self._restored:
                variants = generate_variants(self.param_space,
                                             tc.num_samples, tc.seed)
                self._exp = {f"trial_{i:05d}": {"config": cfg,
                                                "status": "queued",
                                                "metrics": {}, "error": None,
                                                "stopped_early": False,
                                                "has_ckpt": False}
                             for i, cfg in enumerate(variants)}
                self._snapshot(run_dir)
            total = len(self._exp)
            pending = [(tid, rec["config"])
                       for tid, rec in sorted(self._exp.items())
                       if rec["status"] != "done"]
        if self._restored:
            # completed trials keep their recorded results (never re-run);
            # queued/running ones re-enter the queue, running-with-ckpt
            # resume from their persisted checkpoint payload
            for tid, rec in sorted(self._exp.items()):
                if rec["status"] == "done":
                    results[tid] = TrialResult(
                        tid, rec["config"], metrics=rec["metrics"],
                        error=rec["error"],
                        stopped_early=rec.get("stopped_early", False))
                elif searcher is not None:
                    pending.append((tid, rec["config"]))
        max_conc = tc.max_concurrent_trials or max(1, total)
        # with an explicit queue the launch budget is the queue itself
        launched = len(self._exp) if searcher is not None else total
        running: Dict[str, dict] = {}
        # logger callbacks (ref: RunConfig.callbacks → tune/logger/*)
        callbacks = list(getattr(self.run_config, "callbacks", None) or [])
        if callbacks:
            cb_dir = self._run_dir() or os.path.join(
                os.path.expanduser("~/ray_tpu_torch_results"),
                f"tune_{int(time.time())}")
            os.makedirs(cb_dir, exist_ok=True)
            for cb in callbacks:
                cb.setup(cb_dir)
        started: set = set()

        def launch(trial_id: str, cfg: dict, start_checkpoint=None):
            if trial_id not in started:
                started.add(trial_id)
                for cb in callbacks:
                    cb.on_trial_start(trial_id, cfg)
            rec = self._exp.setdefault(
                trial_id, {"config": cfg, "status": "queued", "metrics": {},
                           "error": None, "stopped_early": False,
                           "has_ckpt": False})
            if start_checkpoint is None and rec.get("has_ckpt"):
                # driver restored mid-sweep: trial resumes from its last
                # persisted checkpoint payload
                start_checkpoint = self._load_trial_ckpt(run_dir, trial_id)
            elif start_checkpoint is not None:
                # PBT exploit hands this trial the SOURCE's checkpoint: it
                # must land in ckpt_<tid>.pkl now, or a driver crash before
                # the first post-exploit checkpoint restores the stale
                # pre-exploit weights under the new config
                self._persist_trial_ckpt(run_dir, trial_id, start_checkpoint)
            rec["status"] = "running"
            rec["config"] = cfg
            self._snapshot(run_dir)
            actor = _TrialActor.options(
                resources=dict(tc.resources_per_trial),
                max_concurrency=2).remote(trial_id, cfg, start_checkpoint)
            run_ref = actor.run.remote(self.trainable)
            prev = running.get(trial_id)
            running[trial_id] = {"actor": actor, "run_ref": run_ref,
                                 "started": False, "poll_ref": None,
                                 "seen": 0, "ckpt_seen": 0,
                                 "checkpoint": prev["checkpoint"] if prev else None,
                                 "result": prev["result"] if prev
                                 else TrialResult(trial_id, cfg)}
            running[trial_id]["result"].config = cfg

        def finish(tid: str, res: TrialResult, error: bool):
            results[tid] = res
            self._exp[tid].update(status="done", metrics=res.metrics,
                                  error=res.error,
                                  stopped_early=res.stopped_early)
            self._snapshot(run_dir)
            for cb in callbacks:
                cb.on_trial_complete(tid, res)
            if searcher is not None:
                searcher.on_trial_complete(
                    tid, {**res.metrics, "config": res.config}, error=error)
            self._save_controller(run_dir, searcher, scheduler)

        # ---- controller loop (ref: tune_controller.step:267) ----
        while pending or running or launched < total:
            # fill free slots: from the explicit queue or the searcher
            need = {k: float(v) for k, v in tc.resources_per_trial.items()}
            while len(running) < max_conc:
                if (pending or (searcher is not None and launched < total)) \
                        and not _can_hold(need, sum(
                            not st["started"] for st in running.values())):
                    break   # no room: the next trial waits in the queue
                if pending:
                    tid, cfg = pending.pop(0)
                    launch(tid, cfg)
                elif searcher is not None and launched < total:
                    tid = f"trial_{launched:05d}"
                    cfg = searcher.suggest(tid)
                    if cfg is None:
                        total = launched  # searcher exhausted
                        break
                    if cfg == "PENDING":
                        break  # concurrency-limited; retry next tick
                    launch(tid, cfg)
                    launched += 1
                else:
                    break
            time.sleep(0.05)
            for tid in list(running):
                st = running[tid]
                if st["poll_ref"] is None:
                    st["poll_ref"] = st["actor"].poll.remote(
                        st["seen"], st["ckpt_seen"])
                try:
                    poll = ray_tpu_torch.get(
                        st["poll_ref"], timeout=POLL_TIMEOUT_S
                        if st["started"] else PENDING_POLL_S)
                except GetTimeoutError as e:
                    if not st["started"]:
                        continue   # pending: its actor is not up yet
                    lost = e
                except Exception as e:
                    lost = e
                else:
                    lost = None
                if lost is not None:
                    res = st["result"]
                    res.error = f"trial actor lost: {lost}"
                    try:
                        ray_tpu_torch.kill(st["actor"])
                    except Exception:
                        pass
                    del running[tid]
                    finish(tid, res, error=True)
                    continue
                st["started"] = True
                st["poll_ref"] = None
                if "checkpoint" in poll:
                    st["checkpoint"] = poll["checkpoint"]
                    st["ckpt_seen"] = poll["ckpt_version"]
                    self._persist_trial_ckpt(run_dir, tid,
                                             poll["checkpoint"])
                res = st["result"]
                exploit = None
                for r in poll["reports"]:
                    r = {**r, "config": res.config}
                    res.metrics_history.append(r)
                    res.metrics = r
                    for cb in callbacks:
                        cb.on_trial_result(tid, r)
                    decision = scheduler.on_result(tid, r)
                    if decision == STOP and not poll["done"]:
                        try:
                            # advisory stop; a get() here could block the
                            # whole tuner loop behind one hung trial
                            # raylint: disable=leaked-object-ref -- advisory
                            st["actor"].request_stop.remote()
                        except Exception:
                            pass
                        res.stopped_early = True
                    elif isinstance(decision, tuple) and decision[0] == "EXPLOIT":
                        exploit = decision
                st["seen"] += len(poll["reports"])
                if exploit is not None and not poll["done"]:
                    # PBT: restart this trial from the source's checkpoint
                    # with the explored config (ref: pbt.py _exploit).
                    _, source_tid, new_config = exploit
                    src = running.get(source_tid)
                    src_ckpt = src["checkpoint"] if src else None
                    if src_ckpt is not None:
                        try:
                            ray_tpu_torch.kill(st["actor"])
                        except Exception:
                            pass
                        launch(tid, new_config, start_checkpoint=src_ckpt)
                        continue
                if poll["done"]:
                    if poll["error"] and "TrialStopped" not in poll["error"]:
                        res.error = poll["error"]
                    try:
                        ray_tpu_torch.kill(st["actor"])
                    except Exception:
                        pass
                    del running[tid]
                    finish(tid, res, error=bool(res.error))
        ordered = [results[tid] for tid in sorted(results)]
        for cb in callbacks:
            cb.on_experiment_end(ordered)
        return ResultGrid(ordered, tc.metric, tc.mode)

    def _run_dir(self) -> Optional[str]:
        if self.run_config is not None:
            base = getattr(self.run_config, "storage_path", None)
            name = getattr(self.run_config, "name", None)
            if base and name:
                return os.path.join(base, name)
        return None
