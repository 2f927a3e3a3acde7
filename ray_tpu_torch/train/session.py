"""Per-worker training session.

Port of ``ray_tpu/train/session.py``. Where the JAX package asks whether
its workers form one multi-host jax runtime (``jax.process_count() > 1``),
the port asks whether they form one ``torch.distributed`` group of more
than one rank; rank 0's checkpoint index crosses with ``dist.broadcast``
and the barriers are ``dist.barrier``. ``get_mesh`` builds the port's
DeviceMesh and binds it as the process default; ``get_device`` is where a
loop computes unless it asks for "cpu".

Reference: python/ray/train/_internal/session.py:84 (_TrainSession;
report:429, get_checkpoint:639, get_dataset_shard:901) and the air session
facade (air/session.py). One module-level context per worker process, set up
by the TrainWorker actor before the user loop runs.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.observability import health as _health
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager

# Step-loop progress beacon deadline: generous — "step" here means
# report() cadence, and big-model steps plus a collective checkpoint
# save can legitimately take minutes.
_STEP_DEADLINE_S = 600.0
#: in a checkpoint rank 0 saves: the reports the trainer had not yet
#: acknowledged, this checkpoint's own the last
_REPORTS_FILE = "reports.pkl"


class TrainContext:
    def __init__(self, *, world_rank: int, world_size: int, config: dict,
                 run_dir: str, scaling, checkpoint: Optional[Checkpoint],
                 datasets: Optional[Dict[str, Any]] = None,
                 num_to_keep: Optional[int] = None,
                 elastic_meta: Optional[dict] = None,
                 attempt: Optional[str] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.config = config
        self.run_dir = run_dir
        self.scaling = scaling
        self.start_checkpoint = checkpoint
        self.datasets = datasets or {}
        # Elastic gang metadata (train/elastic.py): run tag for
        # health-event attribution, the generation-suffixed host
        # collective group name, and the per-rank report beacon deadline.
        self.elastic_meta = elastic_meta or {}
        self.reports: List[dict] = []
        self.report_lock = threading.Lock()
        # the trainer's attempt (None: no attempt to recover reports for)
        # and how many reports it has acknowledged (its polls' `after`)
        self.attempt = attempt
        self.acked = 0
        self.latest_checkpoint: Optional[Checkpoint] = checkpoint
        # Every rank gets a manager over the same run_dir so all ranks
        # resolve the same checkpoint_NNNNNN paths; only rank 0 registers
        # (uploads/evicts). In a multi-rank process group the DCP save is
        # collective — every process must enter from_state (each writes its
        # own shards), so non-zero ranks need the path too.
        self.ckpt_mgr = CheckpointManager(run_dir, num_to_keep)
        self.finished = False
        self._mesh = None


_ctx: Optional[TrainContext] = None


def _step_deadline(ctx: TrainContext) -> float:
    dl = ctx.elastic_meta.get("step_deadline_s")
    return float(dl) if dl else _STEP_DEADLINE_S


def _set_context(ctx: Optional[TrainContext]):
    global _ctx
    if ctx is None and _ctx is not None:
        _health.drop_beacon(f"train:r{_ctx.world_rank}")
    _ctx = ctx
    if ctx is not None:
        # armed for the whole run: a rank that stops reporting past the
        # deadline (wedged collective, dead peer mid-allreduce) flags as
        # a StallEvent naming the rank. The run tag in the context lets
        # an ElasticCoordinator attribute the event to ITS gang.
        _health.beacon(f"train:r{ctx.world_rank}",
                       _step_deadline(ctx)).arm(
            rank=ctx.world_rank, world=ctx.world_size,
            run=ctx.elastic_meta.get("run_tag", ""))


def get_context() -> TrainContext:
    if _ctx is None:
        raise RuntimeError("not inside a ray_tpu_torch.train worker")
    return _ctx


def world_rank() -> int:
    return get_context().world_rank


def world_size() -> int:
    return get_context().world_size


def get_config() -> dict:
    return get_context().config


def _collective() -> bool:
    """Whether the workers form one process group of more than one rank
    (the JAX package's ``jax.process_count() > 1``)."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _broadcast_index(index: int) -> int:
    """Rank 0's checkpoint index on every rank of the default group (on
    the card under NCCL, on the CPU otherwise)."""
    import torch
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([index], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def report(metrics: Dict[str, Any], *, state: Any = None) -> None:
    """Report metrics (streamed to the trainer) and optionally checkpoint a
    tree of tensors `state` (ref: session.report:429).

    Checkpoint contract (same as the reference's distributed checkpointing:
    every train worker must call `train.report` with a checkpoint): when the
    workers form one process group of more than one rank, EVERY rank must
    pass `state` on the same reports — the DCP save and its barriers are
    collective, and a rank that skips them hangs the gang. Workers without
    a common group: rank 0's state is saved, other ranks' is ignored."""
    ctx = get_context()
    entry = dict(metrics)
    entry["_ts"] = time.time()
    entry["_rank"] = ctx.world_rank
    if state is not None:
        # Collective save: when the workers form one process group, EVERY
        # process must call from_state (DCP writes each process's shards
        # + barriers). With independent workers, rank 0 saves alone.
        collective = _collective()
        if ctx.world_rank == 0 or collective:
            if collective:
                import torch.distributed as dist

                # all ranks write into rank 0's checkpoint slot — a
                # replacement rank with a fresh staging dir may disagree
                # on the next index
                # raylint: disable=divergent-collective -- all ranks enter if collective
                idx = _broadcast_index(ctx.ckpt_mgr._index)
                path = ctx.ckpt_mgr.new_dir(index=idx)
            else:
                path = ctx.ckpt_mgr.new_dir()
            if ctx.world_rank == 0:
                entry["_checkpoint"] = os.path.abspath(path)
                if ctx.ckpt_mgr.uri:
                    from ray_tpu_torch.train import storage as _storage

                    entry["_checkpoint_uri"] = _storage.join_uri(
                        ctx.ckpt_mgr.uri, os.path.basename(path))
                _save_unacked(ctx, path, entry)
            # raylint: disable=divergent-collective -- all ranks enter if collective
            ck = Checkpoint.from_state(state, path)
            if ctx.world_rank != 0 and collective:
                # mirror this rank's shard files + evict per num_to_keep
                # on this host; no marker, no remote eviction; synchronous
                # so the barrier below really covers the upload
                ctx.ckpt_mgr.register(path, primary=False)
            if collective:
                # the primary's completion marker must land after every
                # rank's shard upload
                # raylint: disable=divergent-collective -- all ranks enter if collective
                dist.barrier()
            if ctx.world_rank == 0:
                # single-process mode mirrors on a background thread so
                # the train loop isn't stalled for the upload
                ctx.ckpt_mgr.register(path, primary=True,
                                      sync=collective)
                ctx.latest_checkpoint = ck
    with ctx.report_lock:
        ctx.reports.append(entry)
    _health.beacon(f"train:r{ctx.world_rank}", _step_deadline(ctx)).tick()


def _save_unacked(ctx: TrainContext, path: str, entry: dict) -> None:
    """Write into checkpoint `path`, before its tensors, the reports the
    trainer has not acknowledged yet and `entry`, the report that carries
    the checkpoint: a worker that dies before the trainer polls them
    takes them with it, while a restart resumes from this checkpoint."""
    if ctx.attempt is None:
        return
    with ctx.report_lock:
        first = ctx.acked
        unacked = ctx.reports[first:] + [entry]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _REPORTS_FILE), "wb") as f:
        pickle.dump({"attempt": ctx.attempt, "first": first,
                     "reports": unacked}, f)


def unpolled_reports(ck: Optional[Checkpoint], attempt: str,
                     seen: int) -> List[dict]:
    """The reports of trainer attempt `attempt` up to checkpoint `ck` (its
    own the last) beyond the `seen` ones the trainer polled: none where
    there is no `ck`, or it is not that attempt's or cannot be read."""
    if ck is None:
        return []
    try:
        with open(os.path.join(ck.to_directory(), _REPORTS_FILE),
                  "rb") as f:
            saved = pickle.load(f)
    except Exception:
        # no record (an older attempt's checkpoint, another writer) or an
        # unreadable copy: the history keeps its gap, the run goes on
        return []
    if saved["attempt"] != attempt:
        return []
    return saved["reports"][max(0, seen - saved["first"]):]


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from (ref: session.get_checkpoint:639)."""
    return get_context().start_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's split of a dataset passed to the trainer
    (ref: session.get_dataset_shard:901 → StreamSplitDataIterator)."""
    ctx = get_context()
    if name not in ctx.datasets:
        raise KeyError(f"no dataset named {name!r} passed to the trainer")
    return ctx.datasets[name]


def get_device(device=None):
    """The torch device this worker's loop computes on: CUDA unless the
    loop passes "cpu" (``resolve_device``; without CUDA only an explicit
    "cpu" runs, there is no fallback). In a process group of more than
    one rank the device is the group's, the CPU under gloo and CUDA under
    NCCL, so that the step's collectives and its tensors agree: a loop
    that asks for the other is refused."""
    from ray_tpu_torch import resolve_device

    dev = resolve_device(device)
    if _collective():
        import torch.distributed as dist

        backend = dist.get_backend()
        group_dev = "cuda" if backend == "nccl" else "cpu"
        if dev.type != group_dev:
            raise RuntimeError(
                f"this gang's process group is {backend}, whose ranks "
                f"compute on {group_dev!r}; the loop asked for "
                f"{str(dev)!r} (pass {group_dev!r} to get_device)")
    return dev


def get_mesh(device=None):
    """The worker's device mesh per ScalingConfig (cached), on CUDA unless
    `device` is "cpu".

    Also binds the mesh (+ the scaling rules) as the process default for
    `ray_tpu_torch.parallel.presets.sharded_jit` — a function decorated
    with in/out specs resolves its mesh here at call time, so an elastic
    rebuild re-meshes every decorated step by re-running setup, with no
    per-call-site rewiring. The mesh spans the default process group's
    ranks (``rebind_default_mesh``); a worker without one (a gang of one
    under ``ProcessGroupBackend``) starts a one-rank group."""
    ctx = get_context()
    if ctx._mesh is None:
        import torch.distributed as dist

        from ray_tpu_torch.parallel import presets
        from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh

        spec = ctx.scaling.mesh or MeshSpec(dp=-1)
        if dist.is_initialized():
            ctx._mesh = presets.rebind_default_mesh(
                spec=spec, rules=get_rules(), device=device)
        else:
            ctx._mesh = local_mesh(spec, device=device)
            presets.set_default_mesh(ctx._mesh, rules=get_rules(),
                                     spec=spec)
    return ctx._mesh


def get_collective_group() -> Optional[str]:
    """The gang-wide host collective group's CURRENT name, or None.

    Elastic gangs re-form the group under a generation-suffixed name on
    every rebuild (membership is static per incarnation); user loops
    must route collective.* calls through this accessor rather than a
    hard-coded name so they survive a remediation."""
    return get_context().elastic_meta.get("collective_group")


def get_rules():
    from ray_tpu_torch.parallel.sharding import ShardingRules

    return getattr(ShardingRules, get_context().scaling.rules)()
