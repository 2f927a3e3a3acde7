"""A3C: asynchronous advantage actor-critic.

Port of ``ray_tpu/rl/a3c.py`` (reference: rllib_contrib a3c
(rllib/algorithms/a3c before exile) — the asynchronous counterpart of
A2C: each worker computes GRADIENTS on its own rollout against a
(possibly stale) snapshot of the parameters, and the learner applies them
as they arrive, first come first served, instead of synchronizing a
fleet-wide batch). Each A3CWorker actor holds its env and computes the
A2C loss's gradient on the CPU; the learner drives an async loop with
ray_tpu_torch.wait(num_returns=1), applying each gradient on its device
in the order they land and immediately re-dispatching that worker with
fresh weights (the Hogwild schedule with a centralized apply: the card
is the parameter server).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.a2c import a2c_optimizer, make_a2c_loss
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Algorithm,
                                   probe_env_spec, rollout_result,
                                   to_device, to_host, tree_leaves,
                                   tree_unflatten_like, value_and_grad)
from ray_tpu_torch.rl.ppo import (RolloutWorker, batch_to_device,
                                  compute_gae, init_policy, read_aux)


@dataclass
class A3CConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 64
    grads_per_step: int = 4          # async applies per training_step
    lr: float = 7e-4
    gamma: float = 0.99
    lam: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 0.5
    grad_timeout_s: float = 300.0    # per-wait bound on a worker gradient
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


@ray_tpu_torch.remote(num_cpus=0.5)
class A3CWorker:
    """Env + local gradient computation (ref: a3c worker loop). Reuses
    the PPO rollout machinery; the gradient of the A2C loss is computed
    worker-side, on the CPU, so only grads travel to the learner."""

    def __init__(self, env: str, seed: int, env_config: dict,
                 cfg_dict: dict):
        self.inner = RolloutWorker._cls(env, seed, env_config)
        self.cfg = cfg_dict
        self._loss = make_a2c_loss(cfg_dict["vf_coeff"],
                                   cfg_dict["entropy_coeff"])

    def sample_grad(self, params, n_steps: int):
        """(gradient tree, aux floats, steps) of one fragment."""
        b = self.inner.sample(params, n_steps)
        adv, ret = compute_gae(b, self.cfg["gamma"], self.cfg["lam"])
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        mb = batch_to_device({"obs": b["obs"], "actions": b["actions"],
                              "adv": adv.astype(np.float32),
                              "returns": ret.astype(np.float32)}, "cpu")
        (loss, aux), grads = value_and_grad(self._loss, params, mb)
        return (tree_unflatten_like(params, grads),
                read_aux({"loss": loss, **aux}), len(adv))

    def episode_stats(self):
        return self.inner.episode_stats()


class A3CTrainer(Algorithm):
    def _setup(self, cfg: A3CConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, _a, _h = probe_env_spec(cfg.env, cfg.env_config)
        if n_actions is None:
            raise ValueError("A3C here supports discrete actions")
        self.params = to_device(init_policy(
            torch.Generator().manual_seed(cfg.seed), obs_dim, n_actions,
            cfg.hidden), self.device)
        self.opt = a2c_optimizer(cfg)
        self.opt_state = None
        cfg_dict = {"gamma": cfg.gamma, "lam": cfg.lam,
                    "vf_coeff": cfg.vf_coeff,
                    "entropy_coeff": cfg.entropy_coeff}
        self.workers = [
            A3CWorker.options(runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config, cfg_dict)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        # persistent in-flight map: leftover gradients carry over to the
        # next step (abandoning them would waste the worker's rollout AND
        # queue the next dispatch behind it)
        self._inflight = {}

    def _apply(self, grads):
        if self.opt_state is None:
            self.opt_state = self.opt.init(self.params)
        self.opt.step(self.params,
                      [g.to(self.device) for g in tree_leaves(grads)],
                      self.opt_state)

    def training_step(self) -> Dict[str, Any]:
        """The async loop: keep one gradient task in flight per worker,
        apply WHICHEVER lands first and re-dispatch that worker with the
        fresh weights (others keep computing on stale params — that
        staleness is A3C). The in-flight map persists across steps, so
        no rollout compute is ever discarded."""
        cfg = self.config
        dispatched = {id(w) for _r, w in self._inflight.values()}
        for w in self.workers:
            if id(w) not in dispatched:
                ref = w.sample_grad.remote(to_host(self.params),
                                           cfg.rollout_fragment_length)
                self._inflight[ref.binary()] = (ref, w)
        aux_last = {}
        for _ in range(cfg.grads_per_step):
            ready, _ = ray_tpu_torch.wait(
                [r for r, _w in self._inflight.values()],
                num_returns=1, timeout=cfg.grad_timeout_s)
            if not ready:
                raise TimeoutError(
                    f"no worker gradient within {cfg.grad_timeout_s}s "
                    "(env too slow? raise A3CConfig.grad_timeout_s)")
            ref = ready[0]
            _, w = self._inflight.pop(ref.binary())
            grads, aux_last, n = ray_tpu_torch.get(ref)
            self._apply(grads)
            self.timesteps += n
            new_ref = w.sample_grad.remote(to_host(self.params),
                                           cfg.rollout_fragment_length)
            self._inflight[new_ref.binary()] = (new_ref, w)
        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        return rollout_result(self.timesteps, stats, aux_last)

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
