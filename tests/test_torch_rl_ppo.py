"""PPO on the port (ray_tpu_torch/rl/ppo.py), mirroring tests/test_rl_ppo.py:
the rollout fleet + learner improves CartPole return. Also:

- a trainer asked for CUDA (the default) without it raises before it
  starts a worker; no trainer falls back to the CPU;
- the rollout actors run with the card hidden (``CPU_WORKER_ENV``);
- ``ray_tpu_torch.rl`` imports no ``jax``, ``optax`` or ``ray_tpu``;
- ``cuda``: PPO's update on the card against the CPU (f32, TF32 off).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_support import REPO, require_cuda
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

import ray_tpu_torch
from ray_tpu_torch import rl
from ray_tpu_torch.rl import core, ppo


def test_ppo_cartpole_improves(ray_start_regular):
    trainer = rl.PPOTrainer(rl.PPOConfig(
        env="CartPole-v1", num_rollout_workers=2,
        rollout_fragment_length=256, num_epochs=4, minibatch_size=128,
        lr=1e-3, seed=0, device="cpu"))
    first = None
    last = None
    for i in range(6):
        metrics = trainer.train()
        if first is None and metrics["episodes_total"] > 0:
            first = metrics["episode_return_mean"]
        last = metrics["episode_return_mean"]
        assert metrics["timesteps_this_iter"] == 512
        assert metrics["sample_time_s"] > 0 and metrics["learn_time_s"] > 0
    trainer.stop()
    assert last is not None and first is not None
    # CartPole random policy ~20; a learning PPO should move well past it
    assert last > first or last > 50, (first, last)


TRAINERS = {
    "PPO": (rl.PPOConfig, rl.PPOTrainer),
    "PG": (rl.PGConfig, rl.PGTrainer),
    "A2C": (rl.A2CConfig, rl.A2CTrainer),
    "A3C": (rl.A3CConfig, rl.A3CTrainer),
    "IMPALA": (rl.ImpalaConfig, rl.ImpalaTrainer),
    "APPO": (rl.APPOConfig, rl.APPOTrainer),
    "DDPPO": (rl.DDPPOConfig, rl.DDPPOTrainer),
    "MultiAgentPPO": (rl.MultiAgentPPOConfig, rl.MultiAgentPPOTrainer),
    "ExternalPPO": (lambda: rl.ExternalPPOConfig(obs_dim=4, n_actions=2),
                    rl.ExternalPPOTrainer),
    "Learner": (lambda: rl.LearnerSpec(
        init_fn=lambda g: {"w": torch.zeros(2)}, loss_fn=None),
        rl.Learner),
}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_learner_without_cuda_raises(name):
    """device=None means CUDA: without it every learner raises (before
    any worker starts: no cluster runs here) instead of training on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    cfg_cls, trainer_cls = TRAINERS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer_cls(cfg_cls())


def test_rollout_actors_hide_the_card(ray_start_regular):
    tr = rl.PPOTrainer(rl.PPOConfig(num_rollout_workers=2,
                                    rollout_fragment_length=16,
                                    device="cpu"))
    try:
        where = ray_tpu_torch.get([w.placement.remote()
                                   for w in tr.workers])
        assert core.CPU_WORKER_ENV["process_env_vars"][
            "CUDA_VISIBLE_DEVICES"] == ""
        for p in where:
            assert p["CUDA_VISIBLE_DEVICES"] == ""
            assert p["cuda_available"] is False
        assert all(t.device.type == "cpu"
                   for t in core.tree_leaves(tr.params))
    finally:
        tr.stop()


def test_rl_imports_no_jax_or_reference():
    """Importing the RL package (every module) in a fresh interpreter
    loads no jax, optax or ray_tpu module; no source line imports them."""
    mods = ", ".join(sorted(p.stem for p in Path(
        REPO, "ray_tpu_torch", "rl").glob("*.py") if p.stem != "__init__"))
    assert "maml" in mods and "slateq" in mods
    code = ("import sys; import ray_tpu_torch.rl; "
            f"from ray_tpu_torch.rl import {mods}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'ray_tpu', 'jaxlib')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for path in sorted(Path(REPO, "ray_tpu_torch", "rl").glob("*.py")):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "optax", "ray_tpu"), \
                    (path.name, s)


@pytest.mark.cuda
def test_ppo_update_card_matches_cpu():
    """One epoch of PPO minibatch updates (the Nature CNN at 42x42x2, 4
    minibatches of 64) from the same params and batch on the card and on
    the CPU, f32 with TF32 off: the loss terms within 1e-4, every param
    within 2 lr per update and all but 1e-2 of each leaf within 1e-5."""
    require_cuda()
    rng = np.random.default_rng(0)
    n = 256
    batch = {"obs": rng.uniform(0, 1, (n, 42, 42, 2)).astype(np.float32),
             "actions": rng.integers(0, 3, n).astype(np.int32),
             "logp": np.full(n, np.log(1 / 3), np.float32),
             "adv": rng.standard_normal(n).astype(np.float32),
             "returns": rng.standard_normal(n).astype(np.float32)}
    cfg = rl.PPOConfig(cnn_hidden=64)
    p0 = ppo.init_any_policy(torch.Generator().manual_seed(0), (42, 42, 2),
                             3, cfg)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            update = ppo.make_ppo_update(cfg, core.Adam(cfg.lr))
            params, _, aux = ppo.run_ppo_epochs(
                update, core.to_device(p0, dev), None, **batch,
                num_epochs=1, minibatch_size=64, seed=0)
            out[dev] = (core.to_host(params), ppo.read_aux(aux))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    (pc, ac), (ph, ah) = out["cuda"], out["cpu"]
    for k in ah:
        assert abs(ac[k] - ah[k]) <= 1e-4 * max(abs(ah[k]), 1.0), k
    for a, b in zip(core.tree_leaves(pc), core.tree_leaves(ph)):
        d = (a - b).abs()
        assert float(d.max()) <= 2 * 4 * cfg.lr
        assert float((d > 1e-5).float().mean()) <= 1e-2
