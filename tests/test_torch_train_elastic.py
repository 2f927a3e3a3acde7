"""Self-healing elastic training (ray_tpu_torch/train/elastic.py): the
health plane closed-loop — chaos kill mid-fit with loss-curve continuity,
straggler demotion with step-time recovery, gang demand on the GCS, and
the parallel/ preset rebinding an elastic rebuild uses.

Port of tests/test_train_elastic.py, aimed at ray_tpu_torch. The mesh
cases run on a one-rank gloo group (the port's mesh spans the ranks of a
process group, not a process's devices); ``sharded_jit`` wraps
``local_map``. The autoscaler is not ported yet (ROADMAP.md queue 1 item
11), so its case checks the rows it reads: gang-tagged unmet demand in
``get_load``, one per missing worker, cleared by a count of 0.

The chaos case waits on its conditions, not on an idle machine. In the
reference's loop the surviving rank ran on while the coordinator rebuilt
the gang, and the coordinator's drain returns at the survivor's first
fresh report: a report made after it, before the kill, was lost while
the checkpoint saved with it was resumed from, a gap in the loss curve
that an idle machine hides (the kill lands within the loop's 50 ms
sleep; a kill that comes 0.5 s late leaves a gap). Here the dying rank
dies only once every other rank has reported the step it dies at, those
ranks then wait to be replaced, and every wait has a limit of its own
(``hold_s`` in the loop, ``reserve_timeout_s`` and ``drain_grace_s`` in
the coordinator, and the test's deadline for the whole fit).
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.train import (Backend, DataParallelTrainer, ElasticConfig,
                                 RunConfig, ScalingConfig)
from ray_tpu_torch.train.config import CheckpointConfig
from ray_tpu_torch.train.elastic import RemediationPolicy
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


# --------------------------------------------------------------------------
# RemediationPolicy: pure decision logic, no cluster
# --------------------------------------------------------------------------

def test_policy_death_and_collective_suspects():
    from ray_tpu_torch.collective.errors import CollectiveError

    p = RemediationPolicy(4, run_tag="r1")
    assert not p.wants_remediation()
    p.observe_death(2)
    assert p.suspects == {2: "died"}

    kind = p.observe_task_error(
        CollectiveError("peer dead", group_name="g", suspect_ranks=[1]))
    assert kind == "remediate"
    assert p.suspects == {2: "died", 1: "collective"}

    # user exception: not the infrastructure's problem
    assert RemediationPolicy(2).observe_task_error(
        ValueError("user bug")) == "user_error"

    # a CollectiveError with NO attributed rank rebuilds the whole gang
    p2 = RemediationPolicy(2)
    assert p2.observe_task_error(CollectiveError("timeout")) == "remediate"
    assert p2.gang_stall and not p2.suspects


def test_policy_stall_events_matched_by_run_tag():
    p = RemediationPolicy(2, run_tag="runA", collective_group="elastic:g@g1")
    events = [
        # other run's stall: ignored
        {"kind": "stall", "component": "train:r1",
         "context": {"run": "runB"}, "ts": 100.0},
        # stale event from before this attempt: ignored
        {"kind": "stall", "component": "train:r0",
         "context": {"run": "runA"}, "ts": 5.0},
        # ours
        {"kind": "stall", "component": "train:r1",
         "context": {"run": "runA"}, "ts": 100.0},
    ]
    p.observe_health_events(events, after_ts=50.0)
    assert p.suspects == {1: "stall"}
    # an unattributed stall of OUR collective group forces a full rebuild
    p.observe_health_events(
        [{"kind": "stall", "component": "collective:elastic:g@g1:r0",
          "context": {}, "ts": 100.0}], after_ts=50.0)
    assert p.gang_stall


def test_policy_straggler_uses_peer_median():
    # 2-rank gang: the median must exclude the candidate, or a 2-rank
    # gang could never flag anyone
    p = RemediationPolicy(2, straggler_k=3.0, straggler_min_reports=4)
    for i in range(5):
        p.observe_report(0, float(i), compute_s=0.05)
        p.observe_report(1, float(i), compute_s=0.60)
    assert p.straggler_verdict() == 1

    # healthy gang: nobody flagged
    q = RemediationPolicy(3, straggler_k=3.0, straggler_min_reports=4)
    for i in range(5):
        for r in range(3):
            q.observe_report(r, float(i), compute_s=0.05)
    assert q.straggler_verdict() is None

    # below min_reports: no verdict yet
    r = RemediationPolicy(2, straggler_k=3.0, straggler_min_reports=10)
    for i in range(5):
        r.observe_report(0, float(i), compute_s=0.05)
        r.observe_report(1, float(i), compute_s=0.60)
    assert r.straggler_verdict() is None


def test_collective_generation_names():
    from ray_tpu_torch import collective as col

    assert col.generation_name("g", 0) == "g"
    assert col.generation_name("g", 3) == "g@g3"


# --------------------------------------------------------------------------
# parallel/ presets: the one-place mesh+spec rebinding elastic rebuilds use
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    """A one-rank gloo default group for the mesh cases, destroyed after
    the test (xdist runs other files in this process)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_preset_builds_mesh_and_rules(one_rank_group):
    from ray_tpu_torch.parallel import get_preset

    preset = get_preset("dp")
    mesh = preset.build(device="cpu")
    assert mesh.size() == 1 and mesh.device_type == "cpu"
    assert "dp" in mesh.mesh_dim_names
    assert preset.rules() is not None
    with pytest.raises(ValueError):
        get_preset("nope")


def test_sharded_jit_recompiles_on_rebind(one_rank_group):
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import (get_preset, rebind_default_mesh,
                                        sharded_jit)
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.presets import default_mesh
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    first = get_preset("dp").bind(device="cpu")

    @sharded_jit(in_specs=(P("dp"),), out_specs=P("dp"))
    def double(x):
        return x * 2

    x = torch.arange(8.0)
    out = double(x)
    assert isinstance(out, DTensor) and out.device_mesh is first
    np.testing.assert_allclose(out.full_tensor().numpy(),
                               np.arange(8.0) * 2)
    assert double.cache_info()["entries"] == 1

    # rebind (what an elastic rebuild does in each new worker): the
    # wrapper rebuilds against the new default mesh with no per-callsite
    # changes
    second = rebind_default_mesh(spec=MeshSpec(dp=1), device="cpu")
    assert default_mesh() is second and second is not first
    out = double(x)
    assert out.device_mesh is second
    np.testing.assert_allclose(out.full_tensor().numpy(),
                               np.arange(8.0) * 2)

    # mismatched spec pair is rejected up front
    with pytest.raises(ValueError):
        sharded_jit(in_specs=(P("dp"),))(lambda x: x)


def test_sharded_jit_plain_jit_without_specs(one_rank_group):
    import torch

    from ray_tpu_torch.parallel import get_preset, sharded_jit

    get_preset("dp").bind(device="cpu")

    @sharded_jit
    def inc(x):
        return x + 1

    assert float(inc(torch.tensor(1.0))) == 2.0


# --------------------------------------------------------------------------
# train loops used by the cluster tests
# --------------------------------------------------------------------------

def _chaos_loop(config):
    """Rank `die_rank` exits hard at `die_at` on the first incarnation,
    once every other rank has reported `die_at` (each leaves a marker
    in `sync_dir`); those ranks then wait to be replaced (at most
    `hold_s`), so the coordinator drains every report they made before
    it rebuilds. The resumed gang (which starts from a checkpoint) runs
    to the end."""
    import os as _os
    import time as _time

    from ray_tpu_torch.train import session

    ck = session.get_checkpoint()
    start = ck.load_state()["step"] if ck else 0
    rank, world = session.world_rank(), session.world_size()
    for step in range(start, config["steps"]):
        session.report({"step": step, "loss": 1.0 / (step + 1.0)},
                       state={"step": step + 1})
        if ck is None and step == config.get("die_at"):
            sync, hold = config["sync_dir"], config["hold_s"]
            if rank != config["die_rank"]:
                open(_os.path.join(sync, f"r{rank}"), "w").close()
                _time.sleep(hold)
                raise RuntimeError(f"not replaced within {hold}s of the "
                                   "death of a peer")
            deadline = _time.time() + hold
            while len(_os.listdir(sync)) < world - 1:
                if _time.time() > deadline:
                    raise RuntimeError(f"the peers did not reach step "
                                       f"{step} within {hold}s")
                _time.sleep(0.02)
            _os._exit(1)
        _time.sleep(0.05)
    return "done"


def _late_kill_loop(config):
    """The reference's chaos loop with the kill made `kill_delay_s` late:
    rank `die_rank` exits hard that long after it reported `die_at`,
    while its peers run on, report and checkpoint every step, one every
    `step_s`."""
    import os as _os
    import time as _time

    from ray_tpu_torch.train import session

    ck = session.get_checkpoint()
    start = ck.load_state()["step"] if ck else 0
    for step in range(start, config["steps"]):
        session.report({"step": step, "loss": 1.0 / (step + 1.0)},
                       state={"step": step + 1})
        if (ck is None and session.world_rank() == config["die_rank"]
                and step == config["die_at"]):
            _time.sleep(config["kill_delay_s"])
            _os._exit(1)
        _time.sleep(config["step_s"])
    return "done"


def _straggler_loop(config):
    """Rank 1 turns slow from `slow_from` on generation 1 only; every
    step is coupled through a host-collective allreduce, so the whole
    gang's step time degrades until the straggler is demoted."""
    import time as _time

    import numpy as np

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.train import session

    ck = session.get_checkpoint()
    start = ck.load_state()["step"] if ck else 0
    gen = session.get_context().elastic_meta.get("generation", 1)
    group = session.get_collective_group()
    for step in range(start, config["steps"]):
        slow = (gen == 1 and session.world_rank() == 1
                and step >= config["slow_from"])
        t0 = _time.time()
        _time.sleep(0.6 if slow else 0.01)
        compute = _time.time() - t0
        if group and session.world_size() > 1:
            col.allreduce(np.ones(2, dtype=np.float32), group)
        session.report({"step": step, "compute_s": compute},
                       state={"step": step + 1})
    return "done"


def _fit_within(trainer, deadline_s):
    """trainer.fit() on a thread, failing the test after deadline_s."""
    import threading

    box = {}
    t = threading.Thread(target=lambda: box.update(result=trainer.fit()),
                         daemon=True)
    t.start()
    t.join(timeout=deadline_s)
    assert not t.is_alive(), f"fit() did not end within {deadline_s}s"
    return box["result"]


# --------------------------------------------------------------------------
# cluster tests
# --------------------------------------------------------------------------

def test_elastic_chaos_kill_resume(ray_start_regular, tmp_path):
    """A worker killed mid-fit → gang shrinks, re-fills into the freed
    slot, collective groups re-form, training resumes from the latest
    checkpoint with a continuous loss curve — no operator in the loop."""
    steps = 8
    sync = tmp_path / "sync"
    sync.mkdir()
    trainer = DataParallelTrainer(
        _chaos_loop,
        train_loop_config={"steps": steps, "die_rank": 1, "die_at": 2,
                           "hold_s": 60.0, "sync_dir": str(sync)},
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False,
            resources_per_worker={"CPU": 0.5},
            elastic=ElasticConfig(min_workers=1,
                                  poll_interval_s=0.1,
                                  reserve_timeout_s=60.0,
                                  drain_grace_s=2.0)),
        run_config=RunConfig(
            name="chaos", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=3)),
        backend=Backend())
    result = _fit_within(trainer, 240.0)
    assert result.ok, result.error
    # loss-curve continuity: every step appears exactly once as a set —
    # duplicates (replay from a checkpoint behind the last report) are
    # legitimate, gaps are not
    got = sorted({r["step"] for r in result.metrics_history})
    assert got == list(range(steps)), got
    assert result.metrics["step"] == steps - 1
    assert result.checkpoint is not None and result.checkpoint.exists()
    # the remediation trail shows the death and the refill back to 2
    assert result.elastic is not None
    assert result.elastic["world_sizes"][0] == 2     # no degraded start
    rems = [e for e in result.elastic["remediations"]
            if e["action"] == "remediate"]
    assert rems and rems[0]["suspects"] == {"1": "died"}
    assert rems[0]["world_before"] == 2 and rems[0]["world_after"] == 2
    assert result.elastic["world_sizes"][-1] == 2
    # the remediation was reported into the GCS health event stream
    from ray_tpu_torch.util import state
    events = state.health_report().get("events", [])
    assert any(e.get("kind") == "remediation"
               and str(e.get("component", "")).startswith("train:chaos")
               for e in events)


def test_elastic_late_kill_keeps_every_report(ray_start_regular, tmp_path):
    """Q1: a kill 0.5 s late, the survivor reporting and checkpointing
    every few ms meanwhile. The coordinator's last poll of rank 0 returns
    at its first fresh report and rank 0 runs on until the rebuild kills
    it; the reports it made up to the checkpoint the next generation
    resumes from come back from that checkpoint's record, so the history
    has every step. (Without that record the reports made between the
    last poll and the kill are lost while their checkpoint is resumed
    from: a gap.)"""
    steps = 800
    trainer = DataParallelTrainer(
        _late_kill_loop,
        train_loop_config={"steps": steps, "die_rank": 1, "die_at": 2,
                           "kill_delay_s": 0.5, "step_s": 0.002},
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False,
            resources_per_worker={"CPU": 0.5},
            elastic=ElasticConfig(min_workers=1,
                                  poll_interval_s=0.1,
                                  reserve_timeout_s=60.0,
                                  drain_grace_s=2.0)),
        run_config=RunConfig(
            name="latekill", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=3)),
        backend=Backend())
    result = _fit_within(trainer, 240.0)
    assert result.ok, result.error
    rems = [e for e in result.elastic["remediations"]
            if e["action"] == "remediate"]
    assert rems and rems[0]["suspects"] == {"1": "died"}
    got = sorted({r["step"] for r in result.metrics_history})
    assert got == list(range(steps)), got


def test_elastic_straggler_demotion(ray_start_regular, tmp_path):
    """A slow rank is demoted (quarantined — its slot is never refilled)
    and the gang's post-demotion step time recovers to within 1.2x of the
    pre-injection steady state."""
    steps, slow_from = 24, 8
    trainer = DataParallelTrainer(
        _straggler_loop,
        train_loop_config={"steps": steps, "slow_from": slow_from},
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False,
            resources_per_worker={"CPU": 0.5},
            elastic=ElasticConfig(min_workers=1, refill=False, grow=False,
                                  poll_interval_s=0.1,
                                  straggler_k=3.0,
                                  straggler_min_reports=4,
                                  reserve_timeout_s=60.0)),
        run_config=RunConfig(
            name="straggler", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=3)),
        backend=Backend())
    result = _fit_within(trainer, 240.0)
    assert result.ok, result.error
    assert result.metrics["step"] == steps - 1
    rems = [e for e in result.elastic["remediations"]
            if e["action"] == "remediate"]
    assert rems and rems[0]["suspects"] == {"1": "straggler"}
    # the suspect's slot is held hostage, not refilled
    assert rems[0]["world_after"] == 1
    assert rems[0]["quarantined"] == 1

    # step-time recovery from rank 0's report timestamps
    hist = [r for r in result.metrics_history if r["_rank"] == 0]
    by_step = {}
    for r in hist:
        by_step[r["step"]] = r["_ts"]   # last occurrence wins

    def gaps(lo, hi):
        return [by_step[s + 1] - by_step[s]
                for s in range(lo, hi) if s in by_step and s + 1 in by_step]
    # skip the first gaps: the peer's first-ever checkpoint save pays the
    # DCP cold start and the allreduce couples that delay into rank 0's
    # early cadence
    pre = gaps(2, slow_from - 1)                 # healthy coupled gang
    slow = gaps(slow_from, slow_from + 2)        # straggler coupled in
    post = gaps(steps - 5, steps - 1)            # after demotion
    assert pre and slow and post
    pre_t = sum(pre) / len(pre)
    assert max(slow) > 3 * pre_t                 # injection really bit
    post_t = sum(post) / len(post)
    assert post_t <= 1.2 * pre_t + 0.05, (pre_t, post_t)


def test_gang_demand_report_load_shape(ray_start_regular):
    """Gang demand rides the GCS load report: reporter-keyed rows fold
    into unmet_demand (one per missing worker, tagged with the gang),
    re-reports replace, count=0 clears."""
    from ray_tpu_torch.core import runtime as rt

    call = rt.get_runtime().gcs_call
    call("report_gang_demand", name="train:tg", reporter="tg",
         resources={"CPU": 1.0}, count=2)
    rows = [d for d in call("get_load")["unmet_demand"]
            if d.get("gang") == "train:tg"]
    assert len(rows) == 2 and rows[0]["resources"] == {"CPU": 1.0}

    call("report_gang_demand", name="train:tg", reporter="tg",
         resources={"CPU": 1.0}, count=1)
    rows = [d for d in call("get_load")["unmet_demand"]
            if d.get("gang") == "train:tg"]
    assert len(rows) == 1                        # replaced, not accumulated

    call("report_gang_demand", name="train:tg", reporter="tg",
         resources={"CPU": 1.0}, count=0)
    assert not [d for d in call("get_load")["unmet_demand"]
                if d.get("gang") == "train:tg"]


def test_pending_pg_records_unmet_demand(ray_start_regular):
    """A PENDING placement group is autoscaler-visible unmet demand
    (one row per unplaced bundle), cleared when the pg is removed."""
    from ray_tpu_torch.core import runtime as rt
    from ray_tpu_torch.util import placement_group, remove_placement_group

    call = rt.get_runtime().gcs_call
    pg = placement_group([{"CPU": 64.0}, {"CPU": 64.0}])
    assert not pg.ready(timeout=0.5)
    rows = [d for d in call("get_load")["unmet_demand"] if d.get("pg")]
    assert len(rows) == 2
    assert rows[0]["resources"] == {"CPU": 64.0}
    remove_placement_group(pg)
    assert not [d for d in call("get_load")["unmet_demand"] if d.get("pg")]


def test_nodelet_infeasible_feeds_demand(ray_start_regular):
    """PAPER L2 shape: a permanently-infeasible lease ask queues on the
    nodelet and ships to the GCS with the next heartbeat, tagged with
    the reporting nodelet."""
    from ray_tpu_torch.core import runtime as rt

    @ray_tpu_torch.remote
    def f():
        return 1

    f.options(num_cpus=100.0).remote()           # parks as infeasible
    call = rt.get_runtime().gcs_call
    deadline = time.time() + 10
    rows = []
    while time.time() < deadline:
        rows = [d for d in call("get_load")["unmet_demand"]
                if str(d.get("source", "")).startswith("nodelet:")]
        if rows:
            break
        time.sleep(0.1)
    assert rows, "nodelet infeasible queue never reached get_load"
    assert rows[0]["resources"]["CPU"] == 100.0


def test_elastic_gang_demand_reaches_get_load(ray_start_regular, tmp_path):
    """What an autoscaler reads of a degraded gang: while a 2-worker
    elastic gang runs at 1 because a blocker holds the cluster,
    ``get_load`` carries one gang-tagged row of the worker's resources,
    and ``StandardAutoscaler.update()`` attributes it to the gang and
    launches a node for it (the reference's
    test_autoscaler_surfaces_gang_demand, over a provider that launches
    nothing real); the row clears when the run ends."""
    import threading

    from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
    from ray_tpu_torch.autoscaler.node_provider import NodeProvider
    from ray_tpu_torch.core import runtime as rt

    class NullProvider(NodeProvider):
        def __init__(self):
            self.created = []

        def non_terminated_nodes(self):
            return []

        def create_node(self, node_type, resources):
            self.created.append((node_type, dict(resources)))
            return f"fake-{len(self.created)}"

        def terminate_node(self, name):
            pass

    @ray_tpu_torch.remote(num_cpus=3.0)
    class Blocker:
        def ping(self):
            return True

    blocker = Blocker.remote()
    ray_tpu_torch.get(blocker.ping.remote())    # 3 of 4 CPUs held
    trainer = DataParallelTrainer(
        _chaos_loop, train_loop_config={"steps": 40},
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False,        # 2 x CPU:1 can't fit
            # no host collective: its helper actors take 0.01 CPU each,
            # and the blocker and the one worker hold all 4
            elastic=ElasticConfig(min_workers=1, grow=False,
                                  host_collective=False,
                                  poll_interval_s=0.1,
                                  reserve_timeout_s=1.0)),
        run_config=RunConfig(name="gdemand", storage_path=str(tmp_path)),
        backend=Backend())
    box = {}
    t = threading.Thread(target=lambda: box.update(result=trainer.fit()),
                         daemon=True)
    t.start()
    call = rt.get_runtime().gcs_call
    try:
        deadline = time.time() + 60
        rows = []
        while time.time() < deadline and not rows:
            rows = [d for d in call("get_load")["unmet_demand"]
                    if str(d.get("gang", "")).startswith("train:gdemand")]
            time.sleep(0.2)
        assert len(rows) == 1, "gang demand never surfaced in get_load"
        assert rows[0]["resources"] == {"CPU": 1.0}
        provider = NullProvider()
        actions = StandardAutoscaler(
            call, provider, node_types={"cpu": {"CPU": 4.0}},
            max_nodes=4).update()
        assert [g for g in actions["gang_demand"]
                if g.startswith("train:gdemand")] == [rows[0]["gang"]]
        assert actions["launched"] == ["fake-1"]
        assert provider.created == [("cpu", {"CPU": 4.0})]
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    result = box["result"]
    assert result.ok, result.error
    assert result.elastic["world_sizes"] == [1]
    assert any(e["action"] == "degraded_start"
               for e in result.elastic["remediations"])
    assert not [d for d in call("get_load")["unmet_demand"]
                if str(d.get("gang", "")).startswith("train:gdemand")]
    ray_tpu_torch.kill(blocker)


@pytest.mark.slow
def test_elastic_degraded_start_then_grow(ray_start_regular, tmp_path):
    """The reverse direction: the gang starts degraded when the cluster
    can't fit the target, reports its shortfall as gang demand, and
    grows back to the target when capacity appears (blocker released)."""
    import threading

    from ray_tpu_torch.core import runtime as rt

    @ray_tpu_torch.remote(num_cpus=3.0)
    class Blocker:
        def ping(self):
            return True

    blocker = Blocker.remote()
    ray_tpu_torch.get(blocker.ping.remote())          # 3 of 4 CPUs held

    trainer = DataParallelTrainer(
        _chaos_loop,                             # no death configured
        train_loop_config={"steps": 60},
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False,        # 2 x CPU:1 can't fit
            elastic=ElasticConfig(min_workers=1,
                                  poll_interval_s=0.1,
                                  grow_check_interval_s=0.4,
                                  reserve_timeout_s=1.0)),
        run_config=RunConfig(
            name="grow", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=3)),
        backend=Backend())

    box = {}

    def run():
        box["result"] = trainer.fit()

    t = threading.Thread(target=run)
    t.start()
    try:
        # the degraded gang advertises its shortfall
        call = rt.get_runtime().gcs_call
        deadline = time.time() + 30
        rows = []
        while time.time() < deadline:
            rows = [d for d in call("get_load")["unmet_demand"]
                    if str(d.get("gang", "")).startswith("train:grow")]
            if rows:
                break
            time.sleep(0.2)
        assert rows, "gang demand never surfaced in get_load"
        # capacity appears: the gang grows back to the target
        ray_tpu_torch.kill(blocker)
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    result = box["result"]
    assert result.ok, result.error
    assert result.elastic["world_sizes"][0] == 1       # degraded start
    assert result.elastic["world_sizes"][-1] == 2      # grown to target
    assert any(e["action"] == "degraded_start"
               for e in result.elastic["remediations"])
    assert any(e["action"] == "grow"
               for e in result.elastic["remediations"])
    assert result.metrics["step"] == 59
