"""DataParallelTrainer: fit() orchestration with failure recovery.

Port of ``ray_tpu/train/trainer.py`` (reference: python/ray/train/
data_parallel_trainer.py:58 + base_trainer.py:570 fit + backend_executor.py
failure handling, get_with_failure_handling:564, _restart:625) over the
port's runtime. The JAX package's ``JaxTrainer`` is ``DataParallelTrainer``
here, upstream's name for the class: its default backend is
``ProcessGroupBackend`` (one ``torch.distributed`` group over the gang),
and parallelism comes from ScalingConfig.mesh/rules. ``TorchTrainer`` and
``TensorflowTrainer`` subclass it with their own backends, as in the
reference.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.status import (ActorDiedError, ActorUnavailableError,
                                       TaskError)
from ray_tpu_torch.train import session, storage
from ray_tpu_torch.train.backend import TensorflowBackend, TorchBackend
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[dict] = field(default_factory=list)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    # remediation audit trail when ScalingConfig.elastic drove the run
    # (run_tag, world size per generation, remediation events); None for
    # fixed-size runs — see train/elastic.py
    elastic: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class DataParallelTrainer:
    """Runs ``train_loop_per_worker`` on a gang of workers and collects
    what they report (the JAX package's ``JaxTrainer``; upstream's
    ``DataParallelTrainer``). Its backend defaults to
    ``ProcessGroupBackend``."""

    #: collective bootstrap, overridable per subclass
    #  (ref: DataParallelTrainer's backend_config, data_parallel_trainer.py:58)
    backend_cls: type = None

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 backend=None):
        from ray_tpu_torch.train.backend import ProcessGroupBackend

        self.loop = train_loop_per_worker
        self.config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from = resume_from_checkpoint
        self.backend = backend or (self.backend_cls() if self.backend_cls
                                   else ProcessGroupBackend())

    def _run_dir(self) -> str:
        base = self.run_config.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
        name = self.run_config.name or f"run_{int(time.time())}"
        if storage.is_uri(base):
            # remote run dir: CheckpointManager stages locally and mirrors
            # to the URI (ref: air RunConfig.storage_path cloud URIs)
            return storage.join_uri(base, name)
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    def fit(self) -> Result:
        if self.scaling.elastic is not None:
            # self-healing gang: health-plane-driven shrink/refill/grow
            # state machine instead of the whole-group retry loop below
            from ray_tpu_torch.train.elastic import ElasticCoordinator

            return ElasticCoordinator(self).fit()
        run_dir = self._run_dir()
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        checkpoint = self.resume_from
        result = Result()
        while True:
            try:
                return self._fit_once(run_dir, checkpoint, result)
            except _WORKER_LOST as e:
                attempt += 1
                # resume from the newest checkpoint any attempt produced
                ck = (Checkpoint(result.metrics["_checkpoint"],
                                 uri=result.metrics.get("_checkpoint_uri"))
                      if result.metrics.get("_checkpoint") else checkpoint)
                checkpoint = _latest_checkpoint(run_dir) or ck
                if max_failures >= 0 and attempt > max_failures:
                    result.error = f"worker group failed: {e}"
                    return result

    def _fit_once(self, run_dir: str, checkpoint: Optional[Checkpoint],
                  result: Result) -> Result:
        group = WorkerGroup(self.scaling.num_workers,
                            self.scaling.worker_resources())
        attempt = uuid.uuid4().hex
        seen = 0
        try:
            # dataset shards: one DataIterator per rank (ref: session.py:901)
            shards: List[Dict[str, Any]] = _split_datasets(
                self.datasets, self.scaling.num_workers)
            coordinator = None
            if self.scaling.num_workers > 1 or self.backend.needs_coordinator:
                if getattr(self.backend, "needs_worker_addresses", False):
                    # TF_CONFIG-style backends need the FULL cluster spec:
                    # one reserved host:port per rank (each worker holds
                    # its reservation until its own setup() releases it)
                    infos = ray_tpu_torch.get(
                        [w.host_info.remote() for w in group.workers])
                    self.backend.worker_addresses = [
                        f"{i['hostname']}:{i['free_port']}" for i in infos]
                    coordinator = self.backend.worker_addresses[0]
                else:
                    info = ray_tpu_torch.get(group.workers[0].host_info.remote())
                    coordinator = f"{info['hostname']}:{info['free_port']}"
            setup_refs = [
                w.setup.remote(self.config, run_dir, self.scaling, checkpoint,
                               shards[i], coordinator,
                               self.run_config.checkpoint_config.num_to_keep,
                               self.backend, attempt=attempt)
                for i, w in enumerate(group.workers)]
            ray_tpu_torch.get(setup_refs)
            run_refs = [w.run.remote(self.loop, self.config)
                        for w in group.workers]
            hang_timeout = self.run_config.failure_config.hang_timeout_s
            startup_grace = self.run_config.failure_config.startup_grace_s
            last_progress = time.time()
            got_report = False
            while True:
                poll = ray_tpu_torch.get(group.workers[0].poll.remote(seen))
                for r in poll["reports"]:
                    result.metrics_history.append(r)
                    result.metrics = r
                if poll["reports"]:
                    last_progress = time.time()
                    got_report = True
                seen += len(poll["reports"])
                if poll["error"]:
                    result.error = poll["error"]
                    break
                if poll["finished"]:
                    break
                # The no-progress clock effectively starts at the first
                # report: until then the worker is cold-starting (spawn +
                # torch import + first step — repeated in full by every
                # restarted attempt), so the deadline is the startup
                # grace, not the steady-state report gap.
                limit = (hang_timeout if got_report
                         else max(hang_timeout or 0.0, startup_grace))
                if (hang_timeout is not None
                        and time.time() - last_progress > limit):
                    # stuck step (a wedged collective, a hung card): a
                    # live-but-hung worker never raises, so the death-based retry path would wait
                    # forever — kill the group and surface a crash so
                    # fit()'s restart-from-checkpoint loop takes over
                    group.shutdown()
                    raise ray_tpu_torch.exceptions.WorkerCrashedError(
                        f"train hang watchdog: no "
                        f"{'progress report' if got_report else 'first report'}"
                        f" for {limit}s (SURVEY hung-chip semantics: "
                        f"the group restarts from the last checkpoint)")
                ready, _ = ray_tpu_torch.wait(run_refs, num_returns=len(run_refs),
                                        timeout=0.25)
                if len(ready) == len(run_refs):
                    # drain any last reports
                    poll = ray_tpu_torch.get(group.workers[0].poll.remote(seen))
                    for r in poll["reports"]:
                        result.metrics_history.append(r)
                        result.metrics = r
                    break
            # surface user exceptions (TaskError) from any worker
            for ref in run_refs:
                try:
                    ray_tpu_torch.get(ref, timeout=30)
                except TaskError as e:
                    result.error = str(e)
                    break
            if result.metrics.get("_checkpoint"):
                result.checkpoint = Checkpoint(
                    result.metrics["_checkpoint"],
                    uri=result.metrics.get("_checkpoint_uri"))
            else:
                result.checkpoint = _latest_checkpoint(run_dir)
            return result
        except _WORKER_LOST:
            # the reports rank 0 made after the last poll died with it;
            # those up to its newest checkpoint, which the restart resumes
            # from, were saved with that checkpoint
            for r in session.unpolled_reports(_latest_checkpoint(run_dir),
                                              attempt, seen):
                result.metrics_history.append(r)
                result.metrics = r
            raise
        finally:
            group.shutdown()


class TorchTrainer(DataParallelTrainer):
    """Reference-parity torch trainer (ref: train/torch/torch_trainer.py):
    same orchestration, TorchBackend's gloo process group for every gang
    size. User loops use torch.distributed +
    ray_tpu_torch.train.prepare_model unchanged."""

    backend_cls = TorchBackend


class TensorflowTrainer(DataParallelTrainer):
    """Reference-parity TF trainer (ref: train/tensorflow/
    tensorflow_trainer.py + config.py:21,40): same orchestration,
    TF_CONFIG rendezvous exported per worker; user loops build
    tf.distribute.MultiWorkerMirroredStrategy unchanged."""

    backend_cls = TensorflowBackend


#: what ends an attempt and restarts the gang from its last checkpoint
_WORKER_LOST = (ActorDiedError, ActorUnavailableError,
                ray_tpu_torch.exceptions.WorkerCrashedError,
                ray_tpu_torch.exceptions.NodeDiedError)


def _latest_checkpoint(run_dir: str) -> Optional[Checkpoint]:
    from ray_tpu_torch.train.checkpoint import CheckpointManager

    return CheckpointManager(run_dir).latest()


def _split_datasets(datasets: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
    for name, ds in datasets.items():
        if hasattr(ds, "streaming_split"):
            its = ds.streaming_split(n)
            for i in range(n):
                shards[i][name] = its[i]
        else:
            for i in range(n):
                shards[i][name] = ds
    return shards
