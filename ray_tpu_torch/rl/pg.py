"""PG: vanilla policy gradient (REINFORCE).

Port of ``ray_tpu/rl/pg.py`` (reference: rllib/algorithms/pg (pre-exile)
— Monte-Carlo reward-to-go returns, no critic, one gradient step per
sampled batch). The simplest on-policy baseline in the zoo; reuses PPO's
discrete policy net and rollout workers (the value head exists in the
shared net but carries no loss here, matching PG's critic-free
objective).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   make_update, probe_env_spec,
                                   reward_to_go, rollout_result, to_device,
                                   to_host)
from ray_tpu_torch.rl.ppo import (RolloutWorker, batch_to_device, entropy,
                                  init_policy, log_softmax_taken,
                                  policy_forward, read_aux)


@dataclass
class PGConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 100
    lr: float = 4e-3
    gamma: float = 0.99
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def pg_loss(params, mb):
    logits, _values = policy_forward(params, mb["obs"])
    logp_all, logp = log_softmax_taken(logits, mb["actions"])
    loss = -(logp * mb["returns"]).mean()
    return loss, {"entropy": entropy(logp_all)}


class PGTrainer(Algorithm):
    """ref: pg.py training_step — sample, compute returns, one policy
    gradient step on -logp * R."""

    def _setup(self, cfg: PGConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, _a, _h = probe_env_spec(cfg.env, cfg.env_config)
        if n_actions is None:
            raise ValueError("PG here supports discrete actions")
        self.params = to_device(init_policy(
            torch.Generator().manual_seed(cfg.seed), obs_dim, n_actions,
            cfg.hidden), self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = None
        self.workers = [
            RolloutWorker.options(num_cpus=0.5,
                                  runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._update = make_update(pg_loss, self.opt)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        params_host = to_host(self.params)
        batches = ray_tpu_torch.get([
            w.sample.remote(params_host, cfg.rollout_fragment_length)
            for w in self.workers])
        obs, actions, rets = [], [], []
        for b in batches:
            obs.append(b["obs"])
            actions.append(b["actions"])
            rets.append(reward_to_go(b, cfg.gamma))
        ret = np.concatenate(rets)
        ret = (ret - ret.mean()) / (ret.std() + 1e-8)
        mb = batch_to_device({"obs": np.concatenate(obs),
                              "actions": np.concatenate(actions),
                              "returns": ret}, self.device)
        self.timesteps += len(ret)
        self.params, self.opt_state, aux = self._update(
            self.params, self.opt_state, mb)
        aux["loss"] = aux.pop("total_loss")
        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        return rollout_result(self.timesteps, stats, read_aux(aux))

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
