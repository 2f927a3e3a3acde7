"""Self-healing elastic training: the health plane closes its loop.

Port of ``ray_tpu/train/elastic.py`` over the port's runtime, collectives
and chaos plane. Each rebuild replaces every worker process, so the old
``torch.distributed`` group dies with its ranks and the new gang's backend
starts a fresh one on a new rendezvous; the host collective group re-forms
under a generation-suffixed name; ``session.get_mesh()`` in each new worker
rebinds the process-default mesh (``presets.rebind_default_mesh``).

Both halves of the DETECTION story exist elsewhere — collectives raise
typed ``CollectiveError`` naming suspect ranks, the health plane emits
``StallEvent``s from per-rank progress beacons, and actor death surfaces
as ``ActorDiedError`` — but until this module nothing *reacted*: a dead
or lagging worker killed the whole ``fit()``. The ElasticCoordinator
subscribes to those events for one gang and drives a remediation state
machine with no operator in the loop:

    monitor ──suspect──▶ quarantine ──▶ shrink/refill ──▶ re-form
       ▲                 (hold slot)     (gang demand     collectives
       │                                  on shortfall)   (@g<N> name)
       └───────── resume from latest DCP checkpoint ◀── rebuild mesh

Event sources folded by the monitor, every ``poll_interval_s``:

* **actor death** — every rank is polled (not just rank 0); a poll that
  raises a death error marks that rank suspect, bundle freed for reuse.
* **CollectiveError suspect ranks** — a failed ``run()`` whose TaskError
  cause is a CollectiveError contributes ``cause.suspect_ranks``;
  suspects quarantined (their slot held, refill lands elsewhere).
* **StallEvents** — the GCS health report's ``train:r<N>`` stalls are
  matched to this gang via the run tag the session stamps into its
  beacon context; a stalled rank is quarantined. A stall of this gang's
  collective group without a named rank forces a full-gang rebuild.
* **straggler verdicts** — per-rank EWMA over the ``compute_s`` metric
  when loops report one (the honest signal in a synchronous gang, where
  everyone's *report cadence* collapses to the straggler's), else over
  inter-report cadence; a rank beyond ``straggler_k`` x the median of
  its peers is demoted and its slot quarantined.

The reverse direction: a gang below target reports its shortfall as
gang demand through the GCS (the same reporter-keyed, staleness-aged
``report_load`` shape the serve controller uses — PAPER.md L2's
infeasible-queue → autoscaler reporting), and every
``grow_check_interval_s`` probes cluster capacity; when a worker-sized
hole appears it rebuilds the gang larger, resuming from the latest
checkpoint. Remediations are reported to the GCS as ``remediation``
health events (timeline instants + ``cli doctor`` context).

Re-meshing rides ``ray_tpu_torch.parallel.presets``: ``session.get_mesh()``
in each (re)spawned worker rebinds the process-default mesh, so user steps
decorated with ``sharded_jit`` rebuild against the new topology with
sharding config at one site.
"""

from __future__ import annotations

import os
import statistics
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

import ray_tpu_torch
from ray_tpu_torch.collective.errors import CollectiveError
from ray_tpu_torch.core.status import (ActorDiedError, ActorUnavailableError,
                                       NodeDiedError, TaskError,
                                       WorkerCrashedError)
from ray_tpu_torch.train import session
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.worker_group import WorkerGroup

_DEATH_ERRORS = (ActorDiedError, ActorUnavailableError, WorkerCrashedError,
                 NodeDiedError)


def _cluster_cfg():
    from ray_tpu_torch.core import runtime as _rt
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    rt = _rt.current_runtime_or_none()
    return rt.cfg if rt is not None else GLOBAL_CONFIG


# --------------------------------------------------------------------------
# decision logic (pure; unit-testable without a cluster)
# --------------------------------------------------------------------------

class RemediationPolicy:
    """Folds one attempt's health signals into suspect ranks + reasons.

    Reasons drive the quarantine decision downstream: a ``died`` rank's
    bundle is freed for reuse (the process is gone; the slot is fine),
    while ``straggler``/``stall``/``collective`` slots are quarantined —
    still reserved, never refilled, so the replacement cannot land back
    on the suspect host/process."""

    def __init__(self, world: int, *, run_tag: str = "",
                 collective_group: Optional[str] = None,
                 straggler_k: float = 3.0,
                 straggler_min_reports: int = 4,
                 quarantine_stragglers: bool = True):
        self.world = world
        self.run_tag = run_tag
        self.collective_group = collective_group
        self.straggler_k = float(straggler_k)
        self.straggler_min_reports = int(straggler_min_reports)
        self.quarantine_stragglers = quarantine_stragglers
        self.suspects: Dict[int, str] = {}     # rank -> reason
        self.gang_stall = False                # unattributed: rebuild all
        # rank -> (ewma_seconds, n_observations, last_report_ts)
        self._cadence: Dict[int, Tuple[float, int, float]] = {}

    # -- event intake ------------------------------------------------------

    def observe_death(self, rank: int) -> None:
        self.suspects.setdefault(rank, "died")

    def observe_task_error(self, exc: BaseException) -> str:
        """Classify a failed run(): 'remediate' for infrastructure
        failures (collective suspects folded in), 'user_error' for
        anything the loop itself raised."""
        cause = exc.cause if isinstance(exc, TaskError) else exc
        if isinstance(cause, CollectiveError):
            ranks = getattr(cause, "suspect_ranks", None) or []
            for r in ranks:
                if 0 <= int(r) < self.world:
                    self.suspects.setdefault(int(r), "collective")
            if not ranks:
                self.gang_stall = True      # timeout with no attribution
            return "remediate"
        if isinstance(cause, _DEATH_ERRORS):
            self.gang_stall = True
            return "remediate"
        return "user_error"

    def observe_health_events(self, events: List[dict],
                              after_ts: float) -> None:
        """Fold GCS health events: per-rank train beacon stalls matched
        by run tag, plus unattributed stalls of this gang's collective
        group."""
        for ev in events:
            if ev.get("kind") != "stall" or float(ev.get("ts", 0)) < after_ts:
                continue
            comp = str(ev.get("component", ""))
            ctx = ev.get("context") or {}
            if (comp.startswith("train:r")
                    and ctx.get("run") == self.run_tag and self.run_tag):
                try:
                    rank = int(comp[len("train:r"):])
                except ValueError:
                    continue
                if 0 <= rank < self.world:
                    self.suspects.setdefault(rank, "stall")
            elif (self.collective_group
                    and comp.startswith(
                        f"collective:{self.collective_group}:r")):
                # the stalled component is the WAITING rank (the victim);
                # without a named culprit the whole gang rebuilds
                self.gang_stall = True

    def observe_report(self, rank: int, ts: float,
                       compute_s: Optional[float] = None) -> None:
        """One session.report() from `rank`. Prefers the loop-reported
        per-step compute time; falls back to inter-report cadence (only
        meaningful for uncoupled gangs — a synchronous collective drags
        every rank's cadence down to the straggler's)."""
        ewma, n, last = self._cadence.get(rank, (0.0, 0, 0.0))
        sample = None
        if compute_s is not None:
            sample = float(compute_s)
        elif n > 0:
            sample = max(0.0, ts - last)
        if sample is not None:
            ewma = sample if n <= 1 else 0.5 * ewma + 0.5 * sample
        self._cadence[rank] = (ewma, n + 1, ts)

    # -- verdicts ------------------------------------------------------------

    def straggler_verdict(self) -> Optional[int]:
        """The single worst rank whose EWMA exceeds straggler_k x the
        median of its peers, once every live rank has warmed up; None
        while healthy."""
        if not self.quarantine_stragglers or self.world < 2:
            return None
        live = [r for r in range(self.world) if r not in self.suspects]
        stats = {r: self._cadence.get(r) for r in live}
        if any(s is None or s[1] < self.straggler_min_reports
               for s in stats.values()):
            return None
        worst, worst_ratio = None, 0.0
        for r in live:
            peers = [stats[p][0] for p in live if p != r and stats[p][0] > 0]
            if not peers:
                continue
            base = statistics.median(peers)
            if base <= 0:
                continue
            ratio = stats[r][0] / base
            if ratio > self.straggler_k and ratio > worst_ratio:
                worst, worst_ratio = r, ratio
        return worst

    def flag_straggler(self, rank: int) -> None:
        self.suspects.setdefault(rank, "straggler")

    def wants_remediation(self) -> bool:
        return bool(self.suspects) or self.gang_stall

    def summary(self) -> dict:
        return {"suspects": {r: why for r, why in
                             sorted(self.suspects.items())},
                "gang_stall": self.gang_stall}


# --------------------------------------------------------------------------
# the coordinator
# --------------------------------------------------------------------------

class ElasticCoordinator:
    """Runs a DataParallelTrainer's fit() as a remediation loop (see
    module docstring). Constructed by ``DataParallelTrainer.fit()``
    whenever ``ScalingConfig.elastic`` is set."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.el = trainer.scaling.elastic
        cfg = _cluster_cfg()
        e = self.el
        # every elastic_* cluster knob is the default the per-run
        # ElasticConfig override falls back to
        self.poll_interval = (e.poll_interval_s
                              if e.poll_interval_s is not None
                              else cfg.elastic_poll_interval_s)
        self.health_poll_interval = (
            e.health_poll_interval_s if e.health_poll_interval_s is not None
            else cfg.elastic_health_poll_interval_s)
        self.straggler_k = (e.straggler_k if e.straggler_k is not None
                            else cfg.elastic_straggler_k)
        self.straggler_min_reports = (
            e.straggler_min_reports if e.straggler_min_reports is not None
            else cfg.elastic_straggler_min_reports)
        self.grow_check_interval = (
            e.grow_check_interval_s if e.grow_check_interval_s is not None
            else cfg.elastic_grow_check_interval_s)
        self.reserve_timeout = (e.reserve_timeout_s
                                if e.reserve_timeout_s is not None
                                else cfg.elastic_reserve_timeout_s)
        self.drain_grace = (e.drain_grace_s if e.drain_grace_s is not None
                            else cfg.elastic_drain_grace_s)
        self.target = trainer.scaling.num_workers
        self.max_workers = min(e.max_workers or self.target,
                               max(self.target, e.max_workers or 0))
        self.min_workers = max(1, e.min_workers)
        self.worker_res = trainer.scaling.worker_resources()
        self.run_tag = ""
        self.summary: Dict[str, Any] = {}
        # (the generation's attempt tag, how many rank-0 reports the
        # coordinator has polled in it): what a rebuild recovers after
        self._polled: Tuple[str, int] = ("", 0)
        # Monotonic per-reporter sequence on gang-demand reports: the
        # GCS drops any report whose seq is <= the last one applied, so
        # a delayed/duplicated stale report (network reordering, chaos
        # plane) cannot resurrect demand a newer count=0 cleared.
        self._gang_seq = 0

    # -- GCS plumbing (all best-effort: the gang must survive a GCS blip) --

    def _gcs_call(self, method: str, **kw):
        from ray_tpu_torch.core import runtime as _rt

        rt = _rt.current_runtime_or_none()
        if rt is None:
            return None
        try:
            return rt.gcs_call(method, **kw)
        except Exception:
            return None

    def _emit_event(self, action: str, **fields) -> None:
        ev = {"kind": "remediation", "component": f"train:{self.run_tag}",
              "action": action, "ts": time.time(), **fields}
        self.summary.setdefault("remediations", []).append(ev)
        self._gcs_call("report_remediation", event=ev)

    def _report_gang_demand(self, group: WorkerGroup) -> None:
        """Fold this gang's shortfall into autoscaler-visible unmet
        demand (reporter-keyed + staleness-aged at the GCS, the serve
        report_load shape); count=0 clears the row once whole."""
        shortfall = max(0, min(self.target, self.max_workers)
                        - group.num_workers)
        self._gang_seq += 1
        self._gcs_call("report_gang_demand", name=f"train:{self.run_tag}",
                       reporter=self.run_tag,
                       resources=dict(self.worker_res), count=shortfall,
                       seq=self._gang_seq)

    def _capacity_available(self) -> bool:
        """Cheap pre-gate for a grow attempt: some node's available
        vector fits one worker (the add itself still reserves through a
        PG, so a race here only wastes one short reservation wait)."""
        avail = self._gcs_call("get_available_resources")
        if not avail:
            return False
        for q in avail.values():
            if all(q.get(k, 0.0) >= v for k, v in self.worker_res.items()):
                return True
        return False

    # -- gang construction --------------------------------------------------

    def _build_group(self) -> WorkerGroup:
        """Reserve the target gang, degrading toward min_workers when
        the cluster can't fit it (the shortfall is reported as gang
        demand and the grow path finishes the job later)."""
        n = self.target
        last_err: Optional[BaseException] = None
        while n >= self.min_workers:
            try:
                return WorkerGroup(n, self.worker_res,
                                   pg_timeout_s=self.reserve_timeout)
            except ray_tpu_torch.exceptions.PlacementGroupUnavailableError as e:
                last_err = e
                n -= 1
        raise last_err  # type: ignore[misc]

    # -- the remediation loop -------------------------------------------------

    def fit(self):
        from ray_tpu_torch.train.trainer import Result, _latest_checkpoint

        trainer = self.trainer
        run_dir = trainer._run_dir()
        self.run_tag = (f"{os.path.basename(run_dir.rstrip('/'))}"
                        f"-{uuid.uuid4().hex[:6]}")
        result = Result()
        self.summary = {"run_tag": self.run_tag, "remediations": [],
                        "world_sizes": [], "generations": 0}
        result.elastic = self.summary
        checkpoint: Optional[Checkpoint] = trainer.resume_from
        group = self._build_group()
        self._report_gang_demand(group)
        if group.num_workers < self.target:
            self._emit_event("degraded_start", world=group.num_workers,
                             target=self.target)
        generation = 0
        remediations = 0
        try:
            while True:
                generation += 1
                self.summary["generations"] = generation
                self.summary["world_sizes"].append(group.num_workers)
                col_group = None
                if self.el.host_collective:
                    from ray_tpu_torch import collective as col

                    col_group = col.reform_collective_group(
                        f"elastic:{self.run_tag}", generation)
                verdict, data = self._run_attempt(
                    group, run_dir, checkpoint, col_group, generation, result)
                if verdict == "finished":
                    if result.metrics.get("_checkpoint"):
                        result.checkpoint = Checkpoint(
                            result.metrics["_checkpoint"],
                            uri=result.metrics.get("_checkpoint_uri"))
                    else:
                        result.checkpoint = _latest_checkpoint(run_dir)
                    return result
                if verdict == "user_error":
                    result.error = data
                    return result
                # verdict in ("remediate", "grow"): rebuild the gang
                remediations += 1
                if remediations > self.el.max_remediations:
                    result.error = (
                        f"elastic: gave up after {self.el.max_remediations} "
                        f"remediations (last: {data.summary() if hasattr(data, 'summary') else data})")
                    return result
                world_before = group.num_workers
                suspects: Dict[int, str] = {}
                if verdict == "remediate":
                    policy: RemediationPolicy = data
                    suspects = {r: why for r, why in policy.suspects.items()
                                if 0 <= r < group.num_workers}
                    # reverse order: each removal re-indexes the tail
                    for r in sorted(suspects, reverse=True):
                        group.remove_workers(
                            [r], quarantine=suspects[r] != "died")
                # survivors respawn as fresh processes: a user loop
                # thread can't be preempted, and its process group and
                # collective state are bound to the dead topology
                group.respawn_workers()
                # resolve the resume checkpoint only AFTER the respawn
                # killed the survivors: until then rank 0 is still
                # saving and evicting (num_to_keep), so a scan can catch
                # every candidate mid-commit or mid-eviction — and a
                # checkpoint picked earlier could be evicted before the
                # next generation loads it. Post-kill the directory is
                # quiescent; a save interrupted by the kill leaves only
                # an uncommitted tmp dir, which _complete() skips.
                latest = _latest_checkpoint(run_dir)
                # rank 0 ran on after the last poll (drain0 returns at
                # its first fresh report) until the respawn killed it:
                # the reports it made up to the checkpoint resumed from
                # were saved with that checkpoint (the plain trainer's
                # R2 record), so the history keeps no gap
                attempt, seen0 = self._polled
                for r in session.unpolled_reports(latest, attempt, seen0):
                    result.metrics_history.append(r)
                    result.metrics = r
                checkpoint = latest or checkpoint
                if self.el.refill or verdict == "grow":
                    want = (min(self.target, self.max_workers)
                            - group.num_workers)
                    if want > 0:
                        group.add_workers(want, timeout=self.reserve_timeout,
                                          partial=True)
                self._report_gang_demand(group)
                self._emit_event(
                    "grow" if verdict == "grow" else "remediate",
                    suspects={str(r): why for r, why in suspects.items()},
                    world_before=world_before, world_after=group.num_workers,
                    quarantined=group.quarantined_count,
                    generation=generation,
                    checkpoint=checkpoint.path if checkpoint else None,
                    checkpoint_procs=(checkpoint.saved_process_count()
                                      if checkpoint else None))
                if group.num_workers < self.min_workers:
                    result.error = (
                        f"elastic: gang at {group.num_workers} worker(s), "
                        f"below min_workers={self.min_workers} and refill "
                        "found no capacity")
                    return result
        finally:
            self._gang_seq += 1
            self._gcs_call("report_gang_demand",
                           name=f"train:{self.run_tag}",
                           reporter=self.run_tag,
                           resources=dict(self.worker_res), count=0,
                           seq=self._gang_seq)
            group.shutdown()

    # -- one generation -------------------------------------------------------

    def _run_attempt(self, group: WorkerGroup, run_dir: str,
                     checkpoint: Optional[Checkpoint],
                     col_group: Optional[str], generation: int,
                     result) -> Tuple[str, Any]:
        """Set up + run one gang incarnation, monitoring every rank.
        Returns (verdict, data): ("finished", None), ("user_error", msg),
        ("remediate", policy), or ("grow", target_world)."""
        from ray_tpu_torch.train.trainer import (_latest_checkpoint,
                                                 _split_datasets)

        trainer = self.trainer
        world = group.num_workers
        policy = RemediationPolicy(
            world, run_tag=self.run_tag, collective_group=col_group,
            straggler_k=self.straggler_k,
            straggler_min_reports=self.straggler_min_reports,
            quarantine_stragglers=self.el.quarantine_stragglers)
        attempt_start = time.time()
        elastic_meta: Dict[str, Any] = {"run_tag": self.run_tag,
                                        "generation": generation}
        if col_group:
            elastic_meta["collective_group"] = col_group
        if self.el.step_deadline_s:
            elastic_meta["step_deadline_s"] = self.el.step_deadline_s
        shards = _split_datasets(trainer.datasets, world)
        # this generation's tag: rank 0 writes the reports not yet polled
        # into each checkpoint it saves (session._save_unacked)
        attempt = f"{self.run_tag}:{generation}"
        seen = [0] * world
        self._polled = (attempt, 0)
        try:
            coordinator = None
            if world > 1 or trainer.backend.needs_coordinator:
                if getattr(trainer.backend, "needs_worker_addresses", False):
                    infos = ray_tpu_torch.get(
                        [w.host_info.remote() for w in group.workers])
                    trainer.backend.worker_addresses = [
                        f"{i['hostname']}:{i['free_port']}" for i in infos]
                    coordinator = trainer.backend.worker_addresses[0]
                else:
                    info = ray_tpu_torch.get(group.workers[0].host_info.remote())
                    coordinator = f"{info['hostname']}:{info['free_port']}"
            ray_tpu_torch.get([
                w.setup.remote(
                    trainer.config, run_dir, trainer.scaling,
                    checkpoint, shards[i], coordinator,
                    trainer.run_config.checkpoint_config.num_to_keep,
                    trainer.backend, elastic_meta, attempt)
                for i, w in enumerate(group.workers)])
            if col_group:
                group.init_host_collective(group_name=col_group)
        except _DEATH_ERRORS:
            # a rank died during bootstrap: rebuild everyone (the dead
            # rank shows up as unreachable in the next incarnation's
            # probe; its bundle is reused since the death freed it)
            policy.gang_stall = True
            return "remediate", policy
        run_refs = [w.run.remote(trainer.loop, trainer.config)
                    for w in group.workers]

        def drain0() -> None:
            # Final polls of rank 0 before this generation is torn down.
            # Two jobs: (1) reports produced after the last monitor poll
            # would vanish when respawn kills the actor — a gap in the
            # loss curve even though the steps ran; (2) a report entry
            # appends only AFTER its checkpoint save commits, so waiting
            # for one fresh report (up to drain_grace_s) guarantees a
            # complete checkpoint exists — without it, a peer death
            # seconds into a run kills rank 0 mid-first-save and the
            # next generation restarts from scratch.
            if not group.workers or 0 in policy.suspects:
                return
            deadline = time.time() + self.drain_grace
            while True:
                try:
                    p = ray_tpu_torch.get(group.workers[0].poll.remote(seen[0]),
                                    timeout=10)
                except Exception:
                    return
                for r in p["reports"]:
                    result.metrics_history.append(r)
                    result.metrics = r
                seen[0] += len(p["reports"])
                self._polled = (attempt, seen[0])
                if p["reports"] or p["finished"] or p["error"] \
                        or time.time() >= deadline:
                    return
                time.sleep(min(0.2, self.poll_interval))

        finished = [False] * world
        hang_timeout = trainer.run_config.failure_config.hang_timeout_s
        startup_grace = trainer.run_config.failure_config.startup_grace_s
        last_progress = time.time()
        got_report = False
        last_health_poll = time.time()
        last_grow_probe = time.time()
        while True:
            now = time.time()
            for i, w in enumerate(group.workers):
                if finished[i] or i in policy.suspects:
                    continue
                try:
                    poll = ray_tpu_torch.get(w.poll.remote(seen[i]), timeout=60)
                except _DEATH_ERRORS:
                    policy.observe_death(i)
                    continue
                for r in poll["reports"]:
                    policy.observe_report(i, float(r.get("_ts", now)),
                                          compute_s=r.get("compute_s"))
                    if i == 0:
                        result.metrics_history.append(r)
                        result.metrics = r
                seen[i] += len(poll["reports"])
                if i == 0:
                    self._polled = (attempt, seen[0])
                if poll["reports"]:
                    last_progress = time.time()
                    got_report = True
                if poll["finished"]:
                    finished[i] = True
                elif poll["error"]:
                    kind = self._classify_run_error(run_refs[i], policy)
                    if kind == "user_error":
                        return "user_error", poll["error"]
                    if not policy.wants_remediation():
                        # classified infrastructure failure but with no
                        # attributable suspect: rebuild the whole gang
                        # rather than re-polling the errored rank forever
                        policy.gang_stall = True
            if all(finished):
                return "finished", None
            if policy.wants_remediation():
                drain0()
                return "remediate", policy
            s = policy.straggler_verdict()
            if s is not None:
                policy.flag_straggler(s)
                drain0()
                return "remediate", policy
            if now - last_health_poll >= self.health_poll_interval:
                last_health_poll = now
                rep = self._gcs_call("health_report")
                if rep:
                    policy.observe_health_events(rep.get("events") or [],
                                                 after_ts=attempt_start)
                    if policy.wants_remediation():
                        drain0()
                        return "remediate", policy
            # trainer-parity hang watchdog: a live-but-hung gang (a
            # stuck step) never raises — rebuild everyone
            limit = (hang_timeout if got_report
                     else max(hang_timeout or 0.0, startup_grace))
            if (hang_timeout is not None
                    and time.time() - last_progress > limit):
                policy.gang_stall = True
                return "remediate", policy
            # grow path: shrunken gang + capacity + a checkpoint to
            # restart from (or no progress worth keeping yet)
            if (self.el.grow
                    and world < min(self.target, self.max_workers)
                    and now - last_grow_probe >= self.grow_check_interval):
                last_grow_probe = now
                self._report_gang_demand(group)
                restartable = (not got_report
                               or _latest_checkpoint(run_dir) is not None)
                if restartable and self._capacity_available():
                    drain0()
                    return "grow", min(self.target, self.max_workers)
            time.sleep(self.poll_interval)

    def _classify_run_error(self, ref, policy: RemediationPolicy) -> str:
        """Resolve a failed run() ref into a policy verdict."""
        try:
            ray_tpu_torch.get(ref, timeout=60)
        except TaskError as e:
            return policy.observe_task_error(e)
        except _DEATH_ERRORS:
            policy.gang_stall = True
            return "remediate"
        except Exception as e:
            return policy.observe_task_error(e)
        return "remediate"
