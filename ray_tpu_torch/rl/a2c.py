"""A2C: synchronous advantage actor-critic.

Port of ``ray_tpu/rl/a2c.py`` (reference: rllib_contrib a2c
(rllib/algorithms/a2c before its exile to rllib_contrib/) — synchronous
rollouts from a worker fleet, a single policy-gradient update per batch
with a value baseline and entropy bonus). Reuses PPO's discrete policy
net, rollout worker, and GAE; optax's clip-then-RMSProp chain is
``core.RMSProp(grad_clip=...)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Algorithm, RMSProp,
                                   make_update, probe_env_spec,
                                   rollout_result, to_device, to_host)
from ray_tpu_torch.rl.ppo import (RolloutWorker, batch_to_device,
                                  compute_gae, entropy, init_policy,
                                  log_softmax_taken, policy_forward,
                                  read_aux)


@dataclass
class A2CConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 100
    lr: float = 7e-4
    gamma: float = 0.99
    lam: float = 1.0                 # A2C default: plain n-step returns
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 0.5
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_a2c_loss(vf_coeff: float, entropy_coeff: float):
    """The advantage actor-critic loss shared by A2C (sync) and A3C
    (async): policy gradient + value regression - entropy bonus."""
    def loss_fn(params, mb):
        logits, values = policy_forward(params, mb["obs"])
        logp_all, logp = log_softmax_taken(logits, mb["actions"])
        pg_loss = -(logp * mb["adv"]).mean()
        vf_loss = torch.square(values - mb["returns"]).mean()
        ent = entropy(logp_all)
        total = pg_loss + vf_coeff * vf_loss - entropy_coeff * ent
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent}

    return loss_fn


def a2c_optimizer(cfg) -> RMSProp:
    """optax.chain(clip_by_global_norm(grad_clip), rmsprop(lr, decay=0.99,
    eps=1e-5)), shared by A2C and A3C."""
    return RMSProp(cfg.lr, decay=0.99, eps=1e-5, grad_clip=cfg.grad_clip)


class A2CTrainer(Algorithm):
    """ref: rllib_contrib a2c training_step — one synchronous gradient
    step per collected batch (no minibatch epochs, unlike PPO)."""

    def _setup(self, cfg: A2CConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, _a, _h = probe_env_spec(cfg.env, cfg.env_config)
        if n_actions is None:
            raise ValueError("A2C here supports discrete actions")
        self.params = to_device(init_policy(
            torch.Generator().manual_seed(cfg.seed), obs_dim, n_actions,
            cfg.hidden), self.device)
        self.opt = a2c_optimizer(cfg)
        self.opt_state = None
        self.workers = [
            RolloutWorker.options(num_cpus=0.5,
                                  runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._update = make_update(
            make_a2c_loss(cfg.vf_coeff, cfg.entropy_coeff), self.opt)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        params_host = to_host(self.params)
        batches = ray_tpu_torch.get([
            w.sample.remote(params_host, cfg.rollout_fragment_length)
            for w in self.workers])
        obs, actions, advs, rets = [], [], [], []
        for b in batches:
            adv, ret = compute_gae(b, cfg.gamma, cfg.lam)
            obs.append(b["obs"])
            actions.append(b["actions"])
            advs.append(adv)
            rets.append(ret)
        adv = np.concatenate(advs)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        mb = batch_to_device({"obs": np.concatenate(obs),
                              "actions": np.concatenate(actions),
                              "adv": adv, "returns": np.concatenate(rets)},
                             self.device)
        self.timesteps += len(adv)
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
