"""TD3: twin-delayed deep deterministic policy gradient.

Port of ``ray_tpu/rl/td3.py`` (reference: rllib/algorithms/td3/ (twin
critics, target policy smoothing, delayed actor updates over the DDPG
base ddpg/ddpg.py)). Continuous control; CPU rollout actors with Gaussian
exploration noise (numpy, as the reference's), the nets, their targets and
both Adam states on the learner's device.

The reference draws the target-smoothing noise inside its jitted update
from ``jax.random.PRNGKey(iteration * 99991 + u)``. Here the update takes
that noise as a tensor (standard normal, the actions' shape): the trainer
draws it from a ``torch.Generator`` seeded with the same integer
(``_noise``), and a test can feed the reference's own draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   EnvSampler, ReplayBuffer, clone_tree,
                                   minibatch_to_device, mlp_forward,
                                   mlp_init, polyak_, probe_env_spec,
                                   standard_normal, to_device, to_host,
                                   value_and_grad)
from ray_tpu_torch.rl.ppo import read_aux


def init_td3_nets(gen: torch.Generator, obs_dim: int, act_dim: int,
                  hidden: int):
    actor = mlp_init(gen, [obs_dim, hidden, hidden, act_dim],
                     out_scale=0.01)
    q1 = mlp_init(gen, [obs_dim + act_dim, hidden, hidden, 1])
    q2 = mlp_init(gen, [obs_dim + act_dim, hidden, hidden, 1])
    return {"actor": actor, "q1": q1, "q2": q2}


def policy_action(actor, obs, act_high: float):
    return torch.tanh(mlp_forward(actor, obs)) * act_high


def q_value(q, obs, act):
    return mlp_forward(q, torch.cat([obs, act], -1))[..., 0]


@ray_tpu_torch.remote
class _TD3Worker(EnvSampler):
    def __init__(self, env_name: str, seed: int,
                 env_config: Optional[dict] = None):
        super().__init__(env_name, seed, env_config)
        self.act_high = float(np.asarray(
            self.env.action_space.high).reshape(-1)[0])
        self.rng = np.random.default_rng(seed)

    @torch.inference_mode()
    def sample(self, actor, num_steps: int, random_actions: bool,
               expl_noise: float):
        """`actor`: the actor's CPU tensors."""
        def select(obs):
            if random_actions:
                return self.env.action_space.sample()
            a = policy_action(actor, torch.as_tensor(
                np.asarray(obs, np.float32))[None], self.act_high)
            action = a[0].numpy()
            return np.clip(
                action + self.rng.normal(
                    0, expl_noise * self.act_high, action.shape),
                -self.act_high, self.act_high).astype(np.float32)

        return self.sample_transitions(select, num_steps)


@dataclass
class TD3Config:
    env: str = "Pendulum-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 1
    rollout_fragment_length: int = 100
    replay_capacity: int = 100_000
    learning_starts: int = 500
    train_batch_size: int = 128
    updates_per_iter: int = 32
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    policy_delay: int = 2            # delayed actor updates (TD3 trick #2)
    target_noise: float = 0.2        # target policy smoothing (trick #3)
    target_noise_clip: float = 0.5
    exploration_noise: float = 0.1
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_td3_update(cfg: TD3Config, act_high: float, actor_opt, critic_opt):
    """``update(nets, target, actor_os, critic_os, mb, noise, do_actor)``:
    the twin critics' step on the smoothed target (`noise` a standard
    normal draw of the actions' shape), then, when `do_actor`, the
    deterministic actor's step against the updated q1 and polyak of every
    net. Leaves updated in place; the losses stay on the device."""
    def critic_loss(qs, target, mb, noise):
        with torch.no_grad():
            noise = torch.clamp(noise * cfg.target_noise,
                                -cfg.target_noise_clip,
                                cfg.target_noise_clip)
            a_next = torch.clamp(
                policy_action(target["actor"], mb["next_obs"], act_high)
                + noise * act_high, -act_high, act_high)
            tq = torch.minimum(
                q_value(target["q1"], mb["next_obs"], a_next),
                q_value(target["q2"], mb["next_obs"], a_next))
            backup = mb["rewards"] + cfg.gamma * (1 - mb["dones"]) * tq
        l1 = torch.square(q_value(qs["q1"], mb["obs"], mb["actions"])
                          - backup).mean()
        l2 = torch.square(q_value(qs["q2"], mb["obs"], mb["actions"])
                          - backup).mean()
        return l1 + l2, {}

    def actor_loss(actor, nets, mb):
        a = policy_action(actor, mb["obs"], act_high)
        return -q_value(nets["q1"], mb["obs"], a).mean(), {}

    def update(nets, target, actor_os, critic_os, mb, noise,
               do_actor: bool):
        qs = {"q1": nets["q1"], "q2": nets["q2"]}
        (closs, _), cgrads = value_and_grad(critic_loss, qs, target, mb,
                                            noise)
        critic_opt.step(qs, cgrads, critic_os)
        if do_actor:
            (aloss, _), agrads = value_and_grad(actor_loss, nets["actor"],
                                                nets, mb)
            actor_opt.step(nets["actor"], agrads, actor_os)
            polyak_(target, nets, cfg.tau)
        else:
            aloss = torch.zeros((), device=closs.device, dtype=closs.dtype)
        return nets, target, actor_os, critic_os, {
            "critic_loss": closs, "actor_loss": aloss}

    return update


class TD3Trainer(Algorithm):
    """ref: rllib/algorithms/td3/td3.py (DDPG base + TD3 tricks)."""

    def _setup(self, cfg: TD3Config):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, _n, act_dim, act_high = probe_env_spec(
            cfg.env, cfg.env_config)
        assert act_dim is not None, "TD3 needs a continuous action space"
        self.act_high = act_high or 1.0
        self.nets = to_device(init_td3_nets(
            torch.Generator().manual_seed(cfg.seed), obs_dim, act_dim,
            cfg.hidden), self.device)
        self.target = clone_tree(self.nets)
        self.actor_opt = Adam(cfg.actor_lr)
        self.critic_opt = Adam(cfg.critic_lr)
        self.actor_os = self.actor_opt.init(self.nets["actor"])
        self.critic_os = self.critic_opt.init(
            {"q1": self.nets["q1"], "q2": self.nets["q2"]})
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _TD3Worker.options(num_cpus=0.5,
                               runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self.num_updates = 0
        self._update = make_td3_update(cfg, self.act_high, self.actor_opt,
                                       self.critic_opt)

    def _noise(self, u: int, shape) -> torch.Tensor:
        """Update u's target-smoothing draw (the reference's
        ``PRNGKey(iteration * 99991 + u)``)."""
        return standard_normal(self.iteration * 99991 + u, shape,
                               self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        actor_host = to_host(self.nets["actor"])
        warmup = self.timesteps < cfg.learning_starts
        refs = [w.sample.remote(actor_host, cfg.rollout_fragment_length,
                                warmup, cfg.exploration_noise)
                for w in self.workers]
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            self.timesteps += len(b["rewards"])

        aux = {}
        if len(self.buffer) >= cfg.learning_starts:
            for u in range(cfg.updates_per_iter):
                mb = minibatch_to_device(
                    self.buffer.sample(cfg.train_batch_size), self.device)
                self.num_updates += 1
                (self.nets, self.target, self.actor_os, self.critic_os,
                 aux) = self._update(
                    self.nets, self.target, self.actor_os, self.critic_os,
                    mb, self._noise(u, mb["actions"].shape),
                    do_actor=self.num_updates % cfg.policy_delay == 0)

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "num_updates": self.num_updates,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "buffer_size": len(self.buffer),
            **read_aux(aux),
        }

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target = clone_tree(self.nets)

