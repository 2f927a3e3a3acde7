"""DDPG: deep deterministic policy gradient (the TD3 base algorithm).

Port of ``ray_tpu/rl/ddpg.py`` (reference: rllib/algorithms/ddpg/
(ddpg.py — deterministic actor, single Q critic, polyak-averaged targets,
Gaussian exploration; TD3 layers its three tricks on top of this, rllib
td3.py)). Shares the continuous-control rollout worker and the actor and
critic functions with ray_tpu_torch.rl.td3; the learner on
``DDPGConfig.device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   ReplayBuffer, clone_tree,
                                   minibatch_to_device, mlp_init, polyak_,
                                   probe_env_spec, to_device, to_host,
                                   value_and_grad)
from ray_tpu_torch.rl.ppo import read_aux
from ray_tpu_torch.rl.td3 import _TD3Worker, policy_action, q_value


def init_ddpg_nets(gen: torch.Generator, obs_dim: int, act_dim: int,
                   hidden: int):
    return {"actor": mlp_init(gen, [obs_dim, hidden, hidden, act_dim],
                              out_scale=0.01),
            "q": mlp_init(gen, [obs_dim + act_dim, hidden, hidden, 1])}


@dataclass
class DDPGConfig:
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
    exploration_noise: float = 0.1
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_ddpg_update(cfg, act_high: float, actor_opt, critic_opt,
                     weighted: bool = False):
    """``update(nets, target, actor_os, critic_os, mb) -> (nets, target,
    actor_os, critic_os, critic_loss, actor_loss, |td|)``: the critic's
    step on the target nets' backup, the actor's against the updated
    critic, polyak of both nets. `weighted` (Ape-X): the critic's squared
    TD errors weighted by ``mb["_weights"]``."""
    def critic_loss(q, target, mb):
        with torch.no_grad():
            a_next = policy_action(target["actor"], mb["next_obs"], act_high)
            tq = q_value(target["q"], mb["next_obs"], a_next)
            backup = mb["rewards"] + cfg.gamma * (1 - mb["dones"]) * tq
        td = q_value(q, mb["obs"], mb["actions"]) - backup
        sq = torch.square(td)
        if weighted:
            sq = mb["_weights"] * sq
        return sq.mean(), {"td": td.abs()}

    def actor_loss(actor, q, mb):
        a = policy_action(actor, mb["obs"], act_high)
        return -q_value(q, mb["obs"], a).mean(), {}

    def update(nets, target, actor_os, critic_os, mb):
        (closs, aux), cgrads = value_and_grad(critic_loss, nets["q"],
                                              target, mb)
        critic_opt.step(nets["q"], cgrads, critic_os)
        (aloss, _), agrads = value_and_grad(actor_loss, nets["actor"],
                                            nets["q"], mb)
        actor_opt.step(nets["actor"], agrads, actor_os)
        polyak_(target, nets, cfg.tau)
        return nets, target, actor_os, critic_os, closs, aloss, aux["td"]

    return update


class DDPGTrainer(Algorithm):
    """ref: rllib/algorithms/ddpg/ddpg.py — actor and critic updated every
    step (no TD3 delay), single Q target, polyak on both nets."""

    def _setup(self, cfg: DDPGConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, _n, act_dim, act_high = probe_env_spec(
            cfg.env, cfg.env_config)
        assert act_dim is not None, "DDPG needs a continuous action space"
        self.act_high = act_high or 1.0
        self.nets = to_device(init_ddpg_nets(
            torch.Generator().manual_seed(cfg.seed), obs_dim, act_dim,
            cfg.hidden), self.device)
        self.target = clone_tree(self.nets)
        self.actor_opt = Adam(cfg.actor_lr)
        self.critic_opt = Adam(cfg.critic_lr)
        self.actor_os = self.actor_opt.init(self.nets["actor"])
        self.critic_os = self.critic_opt.init(self.nets["q"])
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _TD3Worker.options(num_cpus=0.5,
                               runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self.num_updates = 0
        self._update = make_ddpg_update(cfg, self.act_high, self.actor_opt,
                                        self.critic_opt)

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
            for _ in range(cfg.updates_per_iter):
                mb = minibatch_to_device(
                    self.buffer.sample(cfg.train_batch_size), self.device)
                self.num_updates += 1
                (self.nets, self.target, self.actor_os, self.critic_os,
                 closs, aloss, _) = self._update(
                    self.nets, self.target, self.actor_os, self.critic_os,
                    mb)
                aux = {"critic_loss": closs, "actor_loss": aloss}

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
