"""Trainer configuration dataclasses.

Port of ``ray_tpu/train/config.py`` (reference: python/ray/air/config.py,
ScalingConfig / RunConfig / FailureConfig / CheckpointConfig). ScalingConfig
carries the mesh/rules preset as in the JAX package; its accelerator fields
speak of GPUs: ``use_gpu`` and ``gpus_per_worker`` stand where ``use_tpu``
and ``chips_per_worker`` stood, and resolve the resource name through
``cfg.chip_resource`` ("GPU" in the port).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclass
class ElasticConfig:
    """Self-healing gang policy consumed by `ray_tpu_torch.train.elastic`.

    Setting `ScalingConfig.elastic` turns `fit()` into a remediation
    loop: suspect ranks (death, CollectiveError suspects, health-plane
    stalls, report-cadence stragglers) are quarantined, the gang shrinks
    or re-fills between `min_workers` and the target, collective groups
    re-form on a generation-suffixed name, the default mesh rebinds, and
    training resumes from the latest checkpoint — no operator in the
    loop. The reverse direction reports unmet gang demand to the GCS (the
    same `report_load` shape the serve controller uses) and grows the
    gang back toward the target when capacity appears."""

    # Smallest world size the run may continue at. Below this the run
    # fails instead of limping.
    min_workers: int = 1
    # Ceiling for the grow path; None = ScalingConfig.num_workers (the
    # target). Growing past the original request needs an explicit cap.
    max_workers: Optional[int] = None
    # Refill quarantined/dead slots back toward the target on the next
    # rebuild (False = run shrunken until capacity-probe growth, if any).
    refill: bool = True
    # Probe for capacity and grow a shrunken gang back toward the target
    # mid-run (requires a checkpoint to restart from, or zero progress).
    grow: bool = True
    # Demote ranks whose report cadence lags the gang (see the
    # elastic_straggler_* Config knobs); False = only deaths/stalls/
    # collective suspects trigger remediation.
    quarantine_stragglers: bool = True
    # Give up after this many remediations (death spiral guard).
    max_remediations: int = 8
    # Per-rank report-progress beacon deadline override (None = the
    # session default, 600s). Health-plane stall detection for the gang
    # fires after this long without a session.report() on some rank.
    step_deadline_s: Optional[float] = None
    # Bring up a gang-wide host collective group each generation and
    # expose its (generation-suffixed) name via
    # session.get_collective_group(); re-formed on every rebuild.
    host_collective: bool = True
    # Per-run overrides of the cluster elastic_* Config knobs (None =
    # the cluster default): monitor beat, health-plane poll cadence,
    # straggler demotion threshold/warmup, grow probe cadence, and the
    # placement-group wait for elastic reservations.
    poll_interval_s: Optional[float] = None
    health_poll_interval_s: Optional[float] = None
    straggler_k: Optional[float] = None
    straggler_min_reports: Optional[int] = None
    grow_check_interval_s: Optional[float] = None
    reserve_timeout_s: Optional[float] = None
    drain_grace_s: Optional[float] = None


@dataclass
class ScalingConfig:
    num_workers: int = 1                  # worker processes (1 per card)
    # GPU units each worker reserves; None => none is reserved (the worker
    # still computes on CUDA unless its loop asks for "cpu")
    gpus_per_worker: Optional[float] = None
    mesh: Optional[MeshSpec] = None       # None => MeshSpec(dp=-1)
    rules: str = "fsdp"                   # ShardingRules preset name
    use_gpu: bool = True
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    # Self-healing gang policy; None = legacy fixed-size semantics (any
    # failure restarts the whole gang via FailureConfig.max_failures).
    elastic: Optional[ElasticConfig] = None

    def holds_gpu(self) -> bool:
        """Whether each worker reserves a unit of the GPU resource."""
        return bool(self.use_gpu and self.gpus_per_worker)

    def worker_resources(self) -> Dict[str, float]:
        r = dict(self.resources_per_worker)
        r.setdefault("CPU", 1.0)
        if self.holds_gpu():
            r[chip_resource()] = float(self.gpus_per_worker)
        return r


def chip_resource() -> str:
    """The logical chip resource's name, resolved the same way task
    submission does (cfg.chip_resource; "GPU" in the port)."""
    from ray_tpu_torch.core import runtime as _rt
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    rt = _rt.current_runtime_or_none()
    cfg = rt.cfg if rt is not None else GLOBAL_CONFIG
    return cfg.chip_resource


@dataclass
class FailureConfig:
    max_failures: int = 0                 # group restarts from last checkpoint
    # Hang watchdog (SURVEY §7 hard parts: "a single hung chip stalls a
    # whole program; need watchdogs + restart"): if no worker
    # reports progress for this many seconds mid-run, the group is killed
    # and restarted from the last checkpoint like a crash. None = off.
    # Only the gap BETWEEN reports is policed: before an attempt's first
    # report the worker is still cold-starting (process spawn, torch
    # import, first-step warm-up), covered by startup_grace_s below.
    hang_timeout_s: Optional[float] = None
    # Grace window for an attempt's FIRST progress report. Restarted
    # attempts pay the full cold start again, so without this a
    # hang_timeout_s tuned to steady-state step time re-trips the
    # watchdog during every restart's spawn + torch import + warm-up.
    # The effective first-report deadline is max(hang, grace).
    startup_grace_s: float = 120.0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0         # trainer-side auto checkpointing off


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None    # default: ~/ray_tpu_torch_results
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    # ray_tpu_torch.tune LoggerCallback instances (ref: air
    # RunConfig.callbacks → tune/logger/*), called by Tuner.fit
    callbacks: Optional[list] = None
