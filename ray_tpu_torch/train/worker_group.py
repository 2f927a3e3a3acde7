"""WorkerGroup: a gang of training actors under one placement group.

Port of ``ray_tpu/train/worker_group.py`` (reference: python/ray/train/
_internal/worker_group.py:100 and backend_executor.py:45,
_create_placement_group:164, rank assignment:272) over the port's runtime.
The backend hook (``ProcessGroupBackend`` by default) makes worker i rank i
of one ``torch.distributed`` group; host-side exchanges outside the step go
through the port's ``collective``. A worker that holds a unit of the GPU
resource computes on CUDA (``session.get_device()``); so does one without,
unless its loop asks for "cpu", which the workers of a gloo group must.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import TrainContext, _set_context
from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                placement_group, remove_placement_group)


@ray_tpu_torch.remote
class TrainWorker:
    """Hosts the user's train loop; polled by the trainer for reports.

    max_concurrency=2: one thread runs the loop, the other serves polls
    (the reference streams TrainingResults back through the backend executor
    queue, backend_executor.py:457)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.ctx: Optional[TrainContext] = None
        self.error: Optional[str] = None
        self.result: Any = None

    def setup(self, config: dict, run_dir: str, scaling, checkpoint,
              datasets, coordinator: Optional[str] = None,
              num_to_keep=None, backend=None,
              elastic_meta: Optional[dict] = None,
              attempt: Optional[str] = None) -> bool:
        # Collective bootstrap is a pluggable Backend hook
        # (ref: backend_executor.py Backend.on_start); default
        # ProcessGroupBackend.
        from ray_tpu_torch.train.backend import ProcessGroupBackend

        # release the rendezvous-port reservation right before the
        # backend binds it (see host_info)
        res = getattr(self, "_port_reservation", None)
        if res is not None:
            res.close()
            self._port_reservation = None
        self.backend = backend or ProcessGroupBackend()
        self.backend.holds_gpu = bool(scaling is not None
                                      and scaling.holds_gpu())
        self.backend.on_worker_setup(self.rank, self.world_size, coordinator)
        self.ctx = TrainContext(
            world_rank=self.rank, world_size=self.world_size, config=config,
            run_dir=run_dir, scaling=scaling, checkpoint=checkpoint,
            datasets=datasets, num_to_keep=num_to_keep,
            elastic_meta=elastic_meta, attempt=attempt)
        _set_context(self.ctx)
        return True

    def run(self, loop_fn: Callable, config: dict) -> Any:
        try:
            self.result = loop_fn(config) if _accepts_arg(loop_fn) else loop_fn()
            return self.result
        except BaseException as e:
            import traceback

            self.error = traceback.format_exc()
            raise
        finally:
            if self.ctx is not None:
                self.ctx.finished = True
                if self.ctx.ckpt_mgr is not None:
                    try:  # commit pending background checkpoint mirrors
                        self.ctx.ckpt_mgr.flush()
                    except Exception:
                        pass
            try:
                self.backend.on_worker_shutdown()
            except Exception:
                pass

    def poll(self, after: int) -> dict:
        ctx = self.ctx
        reports: List[dict] = []
        if ctx is not None:
            with ctx.report_lock:
                # the caller holds the first `after` reports
                ctx.acked = max(ctx.acked, after)
                reports = ctx.reports[after:]
        return {"reports": reports, "finished": ctx.finished if ctx else False,
                "error": self.error,
                "latest_checkpoint": (ctx.latest_checkpoint.path
                                      if ctx and ctx.latest_checkpoint else None)}

    def set_rank(self, rank: int, world_size: int) -> bool:
        """Rank/world refresh after an elastic resize (the next setup()
        or user-loop restart sees the new topology)."""
        self.rank = rank
        self.world_size = world_size
        if self.ctx is not None:
            self.ctx.world_rank = rank
            self.ctx.world_size = world_size
        return True

    def init_host_collective(self, group_name: str = "train",
                             backend: str = "auto",
                             timeout_s: float = 60.0) -> bool:
        """Join the gang-wide host collective group
        (ray_tpu_torch.collective): rank/world come from the gang, so a
        user loop can immediately call collective.allreduce/barrier for
        host-side exchanges (metric reduction, data-pipeline shuffles)
        without its own rendezvous. Device collectives stay inside the
        step (the process group the backend started)."""
        from ray_tpu_torch import collective as col

        col.init_collective_group(self.world_size, self.rank, group_name,
                                  backend=backend, timeout_s=timeout_s)
        return True

    def destroy_host_collective(self, group_name: str = "train") -> bool:
        from ray_tpu_torch import collective as col

        col.destroy_collective_group(group_name)
        return True

    def host_info(self) -> dict:
        import socket

        # Reserve a rendezvous port and HOLD the socket open until setup()
        # runs in this same process — concurrent trainers (e.g. Tune
        # trials) probing for ports can't be handed this one while the
        # reservation lives, and the close→rebind window is microseconds
        # inside one process instead of a cross-RPC race.
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        self._port_reservation = s
        return {"hostname": socket.gethostname(), "pid": os.getpid(),
                "rank": self.rank, "free_port": port}


def _accepts_arg(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
        return len(sig.parameters) >= 1
    except (TypeError, ValueError):
        return False


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 pg_timeout_s: float = 60.0):
        self.num_workers = num_workers
        self.resources = resources_per_worker
        self.placement_strategy = placement_strategy
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self.pg = placement_group(bundles, strategy=placement_strategy)
        if not self.pg.ready(timeout=pg_timeout_s):
            remove_placement_group(self.pg)
            raise ray_tpu_torch.exceptions.PlacementGroupUnavailableError(
                f"could not reserve {num_workers} x {resources_per_worker}")
        self._extra_pgs: List[Any] = []
        self._worker_pg: Dict[Any, Any] = {}   # worker -> its pg
        # worker index -> (pg, bundle_index); parallel to self.workers so
        # elastic respawn/refill can reuse the exact reservation a dead
        # worker held (ref: BackendExecutor keeps bundle->worker maps)
        self._placements: List[tuple] = []
        # freed reservations a future add_workers may reuse, and
        # quarantined ones it must NOT (suspect rank's slot held hostage
        # so a refill can't land back on the flapping host/process)
        self._free_bundles: List[tuple] = []
        self._quarantined: set = set()          # {(id(pg), bundle_index)}
        self.workers = []
        for rank in range(num_workers):
            self.workers.append(self._spawn(self.pg, rank, rank, num_workers))
            self._placements.append((self.pg, rank))

    def _spawn(self, pg, bundle_index: int, rank: int, world: int):
        w = TrainWorker.options(
            num_cpus=0,
            resources={k: v for k, v in self.resources.items()},
            max_concurrency=2,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg,
                placement_group_bundle_index=bundle_index),
        ).remote(rank, world)
        self._worker_pg[w] = pg
        return w

    def broadcast(self, method: str, *args, **kwargs):
        refs = [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]
        return ray_tpu_torch.get(refs)

    @property
    def quarantined_count(self) -> int:
        """Reserved-but-unusable bundles held by quarantined ranks."""
        return len(self._quarantined)

    def init_host_collective(self, group_name: str = "train",
                             backend: str = "auto",
                             timeout_s: float = 60.0):
        """Bring up a ray_tpu_torch.collective group spanning the gang
        (one rank per worker) for host-side exchanges outside the
        step. Re-run after an elastic resize to rebuild the group on
        the new topology (destroy first — group membership is static)."""
        return self.broadcast("init_host_collective", group_name=group_name,
                              backend=backend, timeout_s=timeout_s)

    def destroy_host_collective(self, group_name: str = "train"):
        # one worker reaps the named helper actors; the rest only drop
        # their local clients (destroy is idempotent across ranks)
        return self.broadcast("destroy_host_collective",
                              group_name=group_name)

    # ---- elasticity (ref: worker_group.py:318 remove_workers /
    #      :333 add_workers; BackendExecutor resizes then re-ranks) ------

    def remove_workers(self, indices: List[int],
                       quarantine: bool = False) -> None:
        """Drop workers by index (dead or drained); ranks are refreshed
        across the survivors. A freed bundle goes back on the reuse list
        unless `quarantine`d — a quarantined slot stays RESERVED but
        unusable, so an elastic refill cannot land a replacement on the
        suspect host/process. A supplemental PG with no live or
        quarantined workers is removed so its bundles return to the
        cluster; bundles of the ORIGINAL PG stay reserved until shutdown
        (placement groups cannot shrink — same contract as the
        reference)."""
        for i in sorted(set(indices), reverse=True):
            w = self.workers.pop(i)
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
            self._worker_pg.pop(w, None)
            pg, bundle = self._placements.pop(i)
            if quarantine:
                self._quarantined.add((id(pg), bundle))
            else:
                self._free_bundles.append((pg, bundle))
        live_pgs = set(map(id, self._worker_pg.values()))
        held_pgs = live_pgs | {pid for (pid, _b) in self._quarantined}
        for pg in list(self._extra_pgs):
            if id(pg) not in held_pgs:
                self._extra_pgs.remove(pg)
                self._free_bundles = [
                    (p, b) for (p, b) in self._free_bundles if p is not pg]
                try:
                    remove_placement_group(pg)
                except Exception:
                    pass
        self.num_workers = len(self.workers)
        self._reassign_ranks()

    def respawn_workers(self, indices: Optional[List[int]] = None) -> None:
        """Replace workers with FRESH actor processes in the same
        bundles. A user loop thread cannot be preempted in place, and a
        surviving rank's process group and collective state are bound to
        the dead topology — replacing the process is the only reliable reset, and
        its reservation is already held so no scheduling round-trip."""
        idxs = list(range(len(self.workers))) if indices is None else indices
        world = len(self.workers)
        for i in idxs:
            old = self.workers[i]
            try:
                ray_tpu_torch.kill(old)
            except Exception:
                pass
            self._worker_pg.pop(old, None)
            pg, bundle = self._placements[i]
            self.workers[i] = self._spawn(pg, bundle, i, world)
        self._reassign_ranks()

    def add_workers(self, n: int, timeout: float = 60.0,
                    partial: bool = False) -> int:
        """Grow the gang by n workers, reusing freed (non-quarantined)
        bundles first; the remainder reserves a supplemental placement
        group with the group's original strategy (the original PG's
        bundle count is fixed). With `partial`, a failed supplemental
        reservation adds however many workers the freed bundles covered
        (possibly 0) instead of raising — the elastic refill path, which
        reports the shortfall as gang demand and retries later. Returns
        the number of workers actually added."""
        placements: List[tuple] = []
        while self._free_bundles and len(placements) < n:
            placements.append(self._free_bundles.pop())
        rest = n - len(placements)
        pg = None
        if rest > 0:
            bundles = [dict(self.resources) for _ in range(rest)]
            pg = placement_group(bundles, strategy=self.placement_strategy)
            if not pg.ready(timeout=timeout):
                try:
                    remove_placement_group(pg)
                except Exception:
                    pass
                if not partial:
                    self._free_bundles.extend(placements)
                    raise ray_tpu_torch.exceptions.PlacementGroupUnavailableError(
                        f"could not reserve {rest} x {self.resources} to "
                        "grow the worker group")
                pg = None
            else:
                self._extra_pgs.append(pg)
                placements.extend((pg, i) for i in range(rest))
        base = len(self.workers)
        world = base + len(placements)
        for i, (p, b) in enumerate(placements):
            self.workers.append(self._spawn(p, b, base + i, world))
            self._placements.append((p, b))
        self.num_workers = len(self.workers)
        self._reassign_ranks()
        return len(placements)

    def _reassign_ranks(self):
        n = len(self.workers)
        ray_tpu_torch.get([w.set_rank.remote(rank, n)
                     for rank, w in enumerate(self.workers)])

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        for pg in ([self.pg] + self._extra_pgs):
            try:
                remove_placement_group(pg)
            except Exception:
                pass
