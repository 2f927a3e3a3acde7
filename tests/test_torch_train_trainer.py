"""The end-to-end slice: the port's DataParallelTrainer running a real GPT-2
train loop through the actor/PG machinery, with session.report metrics +
DCP checkpointing + failure restart from checkpoint.

Port of tests/test_train_trainer.py, aimed at ray_tpu_torch: the JAX loop
(``gpt2`` + ``optax.adamw`` under ``jax.jit``) is a loop over the port's
``gpt2.loss_fn`` and ``make_train_step`` on "cpu"; ``JaxTrainer`` is
``DataParallelTrainer`` and ``use_tpu=False`` is ``use_gpu=False``. Added:
the trainer-level parity test (the losses the workers report equal JAX's
loop's within 1e-5 relative) and a check that the restarted attempt
resumes from its checkpoint's exact state.
"""

import os

import numpy as np
import pytest

from ray_tpu_torch.train import (DataParallelTrainer, FailureConfig,
                                 RunConfig, ScalingConfig)
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

# the reported losses against JAX's loop on the same numpy weights and
# tokens: f32 on the CPU, sums of width 64-256 in another order through 2
# layers and 3 AdamW steps (lr 1e-2), ~1e-7 relative apart
PARITY_RTOL = 1e-5


def _loop(config):
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import session

    cfg = gpt2.PRESETS["tiny"].replace(dtype=torch.float32, remat=False)
    if config.get("params") is not None:
        init_fn = lambda g: gpt2.params_from_jax(config["params"], "cpu")  # noqa: E731
    else:
        init_fn = lambda g: gpt2.init_params(g, cfg)  # noqa: E731
    init, _ = ts.make_train_state_init(init_fn, ts.adamw(1e-2),
                                       device=session.get_device("cpu"))
    state = init(0)
    ck = session.get_checkpoint()
    if ck is not None:
        state = ts.load_state_dict(state, ck.load_state())
    if config.get("tokens") is not None:
        tokens = torch.as_tensor(config["tokens"]).long()
    else:
        tokens = torch.randint(0, cfg.vocab_size, (4, 17),
                               generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg))

    for i in range(state.step, config["steps"]):
        state, m = step(state, batch)
        session.report({"loss": float(m["loss"]), "step": i,
                        "resumed": ck is not None},
                       state=ts.state_dict(state))
        if config.get("die_at") == i and ck is None:
            os._exit(1)   # simulate a worker crash on the first attempt
    return {"final_loss": float(m["loss"])}


def test_trainer_e2e(ray_start_regular, tmp_path):
    trainer = DataParallelTrainer(
        _loop, train_loop_config={"steps": 5},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="e2e", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.ok, result.error
    assert result.metrics["step"] == 4
    assert len(result.metrics_history) == 5
    assert result.checkpoint is not None and result.checkpoint.exists()
    # loss decreased over the run
    assert (result.metrics_history[-1]["loss"]
            < result.metrics_history[0]["loss"])
    # the checkpoint holds the state after the last step
    saved = result.checkpoint.load_state()
    assert saved["step"] == 5 and saved["opt"]["state"][0]["step"] == 5


@pytest.mark.slow
def test_trainer_failure_restart(ray_start_regular, tmp_path):
    """Worker dies mid-run; trainer restarts the group from the latest
    checkpoint (ref: backend_executor.py:564,625 + FailureConfig)."""
    trainer = DataParallelTrainer(
        _loop, train_loop_config={"steps": 6, "die_at": 3},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="restart", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)))
    result = trainer.fit()
    assert result.ok, result.error
    assert result.metrics["step"] == 5
    assert result.checkpoint is not None


def test_trainer_restart_resumes_exact_state(ray_start_regular, tmp_path):
    """The restarted attempt loads the step-3 checkpoint and its losses
    equal, bit for bit, those of a run that never died (the plain CPU
    versions have no atomics, so the same state gives the same step)."""
    def fit(name, **extra):
        return DataParallelTrainer(
            _loop, train_loop_config={"steps": 6, **extra},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(
                name=name, storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=1))).fit()

    died, whole = fit("died", die_at=3), fit("whole")
    assert died.ok and whole.ok, (died.error, whole.error)
    assert [m["step"] for m in died.metrics_history
            if not m["resumed"]] == [0, 1, 2, 3]
    resumed = {m["step"]: m["loss"] for m in died.metrics_history
               if m["resumed"]}
    assert sorted(resumed) == [4, 5]
    assert {m["step"]: m["loss"] for m in whole.metrics_history
            if m["step"] in resumed} == resumed


_FIXED_THREADING = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OMP_DYNAMIC",
                    "MKL_DYNAMIC", "MKL_CBWR")


def _threading_loop(config):
    import os

    import torch

    from ray_tpu_torch.train import session

    mkl = [ln.split(":")[1].strip()
           for ln in torch.__config__.parallel_info().splitlines()
           if ln.strip().startswith("mkl_get_max_threads")]
    session.report({"threads": torch.get_num_threads(), "mkl": mkl,
                    "env": {k: os.environ.get(k) for k in _FIXED_THREADING}})
    return {}


def test_train_worker_threading_is_fixed(ray_start_regular, tmp_path):
    """A CPU train worker's process starts with its CPU libraries'
    threading fixed (worker_process_env): as many intra-op threads as the
    worker's CPUs, OpenMP's and MKL's dynamic thread counts off and one MKL code
    path (MKL_CBWR), so that a resumed attempt's step equals the live one
    bit for bit (test_trainer_restart_resumes_exact_state): another MKL
    code path moves the tiny GPT-2's losses in the 6th digit."""
    from ray_tpu_torch.train.worker_group import worker_process_env

    result = DataParallelTrainer(
        _threading_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                     resources_per_worker={"CPU": 2}),
        run_config=RunConfig(name="threads",
                             storage_path=str(tmp_path))).fit()
    assert result.ok, result.error
    assert result.metrics["threads"] == 2
    assert result.metrics["mkl"] in ([], ["2"])
    assert result.metrics["env"] == {
        "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
        "OMP_DYNAMIC": "FALSE", "MKL_DYNAMIC": "FALSE", "MKL_CBWR": "AUTO"}
    assert worker_process_env({"CPU": 0.5})["OMP_NUM_THREADS"] == "1"
    # a worker that reserves a card steps there and keeps a prestarted
    # process
    assert worker_process_env({"CPU": 1.0, "GPU": 1.0}) == {}


def _quick_loop(config):
    """Steps of no work, a checkpoint every fifth, and on the first
    attempt a death right after the `die_after` one: its reports all come
    within a few milliseconds, inside one poll of the trainer."""
    import torch

    from ray_tpu_torch.train import session

    ck = session.get_checkpoint()
    start = int(ck.load_state()["step"]) if ck else 0
    for step in range(start + 1, config["steps"] + 1):
        m = {"step": step, "resumed": ck is not None}
        if step % 5:
            session.report(m)
            continue
        session.report(m, state={"step": torch.tensor(step)})
        if ck is None and step == config["die_after"]:
            os._exit(1)


def test_trainer_death_keeps_reports_to_its_checkpoint(ray_start_regular,
                                                       tmp_path):
    """A worker that dies before the trainer polled its last reports: the
    ones up to the checkpoint the restart resumes from (steps 1-10) still
    reach metrics_history, from that checkpoint's record, each once and
    in order before the resumed attempt's 11-15."""
    result = DataParallelTrainer(
        _quick_loop, train_loop_config={"steps": 15, "die_after": 10},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="quick", storage_path=str(tmp_path),
                             failure_config=FailureConfig(
                                 max_failures=1))).fit()
    assert result.ok, result.error
    assert [(m["step"], m["resumed"]) for m in result.metrics_history] == (
        [(s, False) for s in range(1, 11)]
        + [(s, True) for s in range(11, 16)])
    assert result.metrics["step"] == 15


def test_process_group_backend_refuses_a_gpu_gang():
    """Workers that each hold a GPU unit would need NCCL and a card pinned
    to each: a gang of two is refused before any group starts; a single
    worker starts none and passes."""
    from ray_tpu_torch.train.backend import ProcessGroupBackend

    b = ProcessGroupBackend()
    b.holds_gpu = True
    with pytest.raises(RuntimeError, match="item 14"):
        b.on_worker_setup(0, 2, "localhost:1")
    b.on_worker_setup(0, 1, "localhost:1")


def test_trainer_user_error_surfaces(ray_start_regular, tmp_path):
    def bad_loop(config):
        raise ValueError("user bug")

    trainer = DataParallelTrainer(
        bad_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="err", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert not result.ok
    assert "user bug" in result.error


def test_worker_group_elastic_resize(ray_start_regular):
    """Elastic add/remove with rank reassignment (ref:
    worker_group.py:318,333 + BackendExecutor resize-and-rerank)."""
    from ray_tpu_torch.train.worker_group import WorkerGroup

    wg = WorkerGroup(num_workers=2, resources_per_worker={"CPU": 0.5})
    try:
        infos = wg.broadcast("host_info")
        assert sorted(i["rank"] for i in infos) == [0, 1]

        wg.remove_workers([0])
        assert wg.num_workers == 1
        assert wg.broadcast("host_info")[0]["rank"] == 0  # re-ranked

        wg.add_workers(2)
        assert wg.num_workers == 3
        infos = wg.broadcast("host_info")
        assert sorted(i["rank"] for i in infos) == [0, 1, 2]
    finally:
        wg.shutdown()


@pytest.mark.slow
def test_hang_watchdog_restarts_from_checkpoint(ray_start_regular, tmp_path):
    """SURVEY §7 hard parts: a live-but-hung worker (a stuck step) never
    dies on its own — the hang watchdog kills the group and fit()
    restarts from the last checkpoint."""
    import time as _time

    from ray_tpu_torch import train
    from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                            RunConfig, ScalingConfig)

    marker = tmp_path / "hung_once"

    def loop(config):
        from ray_tpu_torch.train import session

        ck = session.get_checkpoint()
        start = ck.load_state()["step"] if ck else 0
        for step in range(start, 4):
            session.report({"step": step}, state={"step": step + 1})
            if step == 1 and not marker.exists():
                marker.write_text("x")
                _time.sleep(600)       # the hung card: alive, no progress

    trainer = train.DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="hang", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1, hang_timeout_s=3.0),
            checkpoint_config=CheckpointConfig(num_to_keep=2)))
    result = trainer.fit()
    assert result.ok, result.error
    assert result.metrics["step"] == 3
    assert marker.exists()            # first attempt really hung


def test_trainer_losses_match_jax(ray_start_regular, tmp_path):
    """The trainer-level parity test: the tiny GPT-2 loop's losses as the
    port's DataParallelTrainer reports them (weights sent to the worker as
    numpy in train_loop_config, applied there by ``params_from_jax``)
    against JAX's loop (``gpt2.loss_fn`` + ``optax.adamw(1e-2)`` under
    ``jax.jit``) computed in this process on the same weights and tokens,
    within PARITY_RTOL."""
    jax = pytest.importorskip("jax")
    import optax

    from test_torch_support import jax_reference, jax_tree_to_np

    steps = 3
    with jax_reference() as ref:
        cfg = ref.gpt2.PRESETS["tiny"].replace(dtype=jax.numpy.float32,
                                               remat=False)
        params = ref.gpt2.init_params(jax.random.PRNGKey(0), cfg)
        tokens = np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (4, 17), 0, cfg.vocab_size))
        opt = optax.adamw(1e-2)
        opt_state = opt.init(params)
        batch = {"tokens": tokens}

        @jax.jit
        def step(params, opt_state):
            loss, g = jax.value_and_grad(ref.gpt2.loss_fn)(params, batch,
                                                           cfg)
            up, opt_state = opt.update(g, opt_state, params)
            return optax.apply_updates(params, up), opt_state, loss

        np_params = jax_tree_to_np(params)
        jax_losses = []
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state)
            jax_losses.append(float(loss))

    result = DataParallelTrainer(
        _loop, train_loop_config={"steps": steps, "params": np_params,
                                  "tokens": tokens},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="parity",
                             storage_path=str(tmp_path))).fit()
    assert result.ok, result.error
    ours = [m["loss"] for m in result.metrics_history]
    assert len(ours) == steps
    np.testing.assert_allclose(ours, jax_losses, rtol=PARITY_RTOL, atol=0)
    assert ours[-1] < ours[0]
