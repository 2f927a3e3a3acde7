"""Pixel RL on the port, mirroring tests/test_rl_vision.py: the NatureCNN
policy (ray_tpu_torch/rl/vision.py), pixel connectors, PPO/IMPALA/APPO/
DDPPO on the procedural pixel env (BASELINE.json target 5's pipeline;
ref: rllib/models/torch/visionnet.py:22 +
rllib/env/wrappers/atari_wrappers.py). Learners on the CPU
(``device="cpu"``); the card's run is chip_smoke.py's ``rl`` phase."""

import numpy as np
import pytest
import torch

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch.rl.connectors import (FrameStack, GrayscaleObs,
                                         ResizeObs, ScaleObs)
from ray_tpu_torch.rl.core import tree_leaves, value_and_grad
from ray_tpu_torch.rl.pixel_env import PixelCatcher, atari_connectors
from ray_tpu_torch.rl.vision import (conv_out_hw, init_vision_policy,
                                     vision_forward)

PIXEL_ENV = "ray_tpu_torch.rl.pixel_env:PixelCatcher"


def test_pixel_connectors():
    rgb = np.zeros((84, 84, 3), np.float32)
    rgb[:, :, 0] = 255.0
    g = GrayscaleObs()(rgb)
    assert g.shape == (84, 84, 1)
    assert np.allclose(g[0, 0, 0], 255 * 0.299)
    r = ResizeObs(42, 42)(g)
    assert r.shape == (42, 42, 1)
    s = ScaleObs(1 / 255.0)(r)
    assert float(s.max()) <= 1.0
    fs = FrameStack(4)
    fs.on_episode_start()
    stacked = fs(s)
    assert stacked.shape == (42, 42, 4)
    # zero-padded history then the real frame in the last slot
    assert np.allclose(stacked[..., :3], 0.0)
    assert np.allclose(stacked[..., 3], s[..., 0])


def test_resize_non_divisible():
    x = np.arange(10 * 9, dtype=np.float32).reshape(10, 9)
    out = ResizeObs(4, 4)(x)
    assert out.shape == (4, 4)
    assert np.isfinite(out).all()


def test_vision_net_shapes_and_grads():
    params = init_vision_policy(torch.Generator().manual_seed(0),
                                (42, 42, 4), 6)
    assert conv_out_hw(42, 42) == (1, 1)
    obs = torch.rand((5, 42, 42, 4), generator=torch.Generator()
                     .manual_seed(1))
    logits, value = vision_forward(params, obs)
    assert logits.shape == (5, 6) and value.shape == (5,)
    assert torch.isfinite(logits).all()

    def loss(p, _):
        lg, v = vision_forward(p, obs)
        return (lg ** 2).mean() + (v ** 2).mean(), {}

    _, grads = value_and_grad(loss, params, None)
    gnorm = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    assert len(grads) == len(tree_leaves(params))


def test_vision_net_rejects_tiny_obs():
    with pytest.raises(ValueError, match="too small"):
        init_vision_policy(torch.Generator().manual_seed(0), (8, 8, 1), 3)


def test_pixel_env_mechanics():
    env = PixelCatcher(seed=0, balls_per_episode=2)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (84, 84, 3) and obs.dtype == np.uint8
    # frame shows the ball and the paddle
    assert obs.max() == 255
    assert (obs[-3:] > 0).any()
    done, rewards = False, []
    while not done:
        obs, r, done, trunc, _ = env.step(1)
        rewards.append(r)
    catches = [r for r in rewards if abs(r) >= 1.0]
    assert len(catches) == 2            # one terminal reward per ball


@pytest.mark.slow
def test_ppo_cnn_learns_pixel_catcher(ray_start_regular):
    """The headline check: PPO with the NatureCNN improves reward on a
    pixel env, learner + CPU rollout actors."""
    from ray_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

    cfg = PPOConfig(
        env=PIXEL_ENV,
        env_config={"dense_reward": True, "balls_per_episode": 6},
        obs_connectors=atari_connectors(stack=2, out_size=42),
        num_rollout_workers=2, rollout_fragment_length=256,
        num_epochs=4, minibatch_size=128, lr=1e-3, seed=0, device="cpu")
    tr = PPOTrainer(cfg)
    assert "conv" in tr.params          # auto-selected the CNN
    try:
        early, late = None, None
        for i in range(18):
            r = tr.train()
            if early is None and r["episodes_total"] >= 4:
                early = r["episode_return_mean"]
            late = r["episode_return_mean"]
        assert early is not None
        assert late > early + 1.0, (early, late)
    finally:
        tr.stop()


@pytest.mark.slow
def test_impala_cnn_pixel(ray_start_regular):
    """IMPALA's decoupled learner consumes pixel batches through the same
    CNN dispatch; short run — asserts the async loop turns over and the
    return trend is not degrading."""
    from ray_tpu_torch.rl.impala import ImpalaConfig, ImpalaTrainer

    cfg = ImpalaConfig(
        env=PIXEL_ENV,
        env_config={"dense_reward": True, "balls_per_episode": 4},
        obs_connectors=atari_connectors(stack=2, out_size=42),
        num_rollout_workers=2, rollout_fragment_length=128,
        batches_per_iter=2, lr=8e-4, seed=0, device="cpu")
    tr = ImpalaTrainer(cfg)
    assert "conv" in tr.params
    w0 = tr.params["conv"][0]["w"].clone()
    try:
        for _ in range(4):
            r = tr.train()
            assert r["batches_consumed"] > 0
            assert np.isfinite(r["total_loss"])
            assert np.isfinite(r["vf_loss"])
        # the V-trace learner actually updated the conv stack
        w1 = tr.params["conv"][0]["w"]
        assert float((w1 - w0).abs().max()) > 0
    finally:
        tr.stop()


def test_appo_ddppo_cnn_pixel(ray_start_regular):
    """APPO and DDPPO also get the CNN via init_any_policy (the comment in
    ppo.policy_forward promises the whole family)."""
    from ray_tpu_torch.rl.appo import APPOConfig, APPOTrainer
    from ray_tpu_torch.rl.ddppo import DDPPOConfig, DDPPOTrainer

    acfg = APPOConfig(env=PIXEL_ENV, env_config={"balls_per_episode": 2},
                      obs_connectors=atari_connectors(stack=2, out_size=42),
                      num_rollout_workers=1, rollout_fragment_length=64,
                      batches_per_iter=1, device="cpu")
    at = APPOTrainer(acfg)
    assert "conv" in at.params
    try:
        r = at.train()
        assert r["batches_consumed"] >= 1
    finally:
        at.stop()

    dcfg = DDPPOConfig(env=PIXEL_ENV, env_config={"balls_per_episode": 2},
                       obs_connectors=atari_connectors(stack=2, out_size=42),
                       num_rollout_workers=1, rollout_fragment_length=64,
                       num_sgd_iter=2, minibatch_size=32, device="cpu")
    dt = DDPPOTrainer(dcfg)
    assert "conv" in dt.params
    try:
        r = dt.train()
        assert np.isfinite(r["loss"])
    finally:
        dt.stop()
