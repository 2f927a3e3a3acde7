"""DDPPO: decentralized distributed PPO.

Port of ``ray_tpu/rl/ddppo.py`` (reference: rllib/algorithms/ddppo/
ddppo.py — PPO where experience NEVER leaves the rollout worker: each
worker samples its own fragment, computes the clipped-surrogate gradient
locally, and only GRADIENTS cross the wire, averaged across the fleet
each SGD iteration). The workers compute on the CPU. Without a collective
backend the driver averages the fleet's gradients on its device (the
star topology); with one, the workers allreduce them over a
``ray_tpu_torch.collective`` host group and only rank 0's mean reaches
the driver.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   to_device, to_host, tree_leaves,
                                   tree_map, tree_unflatten_like,
                                   value_and_grad)
from ray_tpu_torch.rl.ppo import (RolloutWorker, batch_to_device,
                                  compute_gae, make_ppo_loss, read_aux)


@ray_tpu_torch.remote(num_cpus=0.5)
class _DDPPOWorker:
    """Sample locally, keep the batch, emit per-SGD-iteration gradients
    (ref: ddppo.py worker loop — `sample_and_update` without the torch
    process group)."""

    def __init__(self, env: str, seed: int, env_config: dict,
                 cfg_dict: dict, connectors=None):
        self.inner = RolloutWorker._cls(env, seed, env_config,
                                        connectors=connectors)
        self.cfg = cfg_dict
        self.rng = np.random.default_rng(seed)
        self.batch = None
        self._loss = make_ppo_loss(cfg_dict["clip"], cfg_dict["vf_coeff"],
                                   cfg_dict["entropy_coeff"])

    def sample(self, params, n_steps: int) -> int:
        """Collect a fragment and precompute advantages; the batch stays
        resident on this worker."""
        b = self.inner.sample(params, n_steps)
        adv, ret = compute_gae(b, self.cfg["gamma"], self.cfg["lam"])
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        self.batch = batch_to_device(
            {"obs": b["obs"], "actions": b["actions"], "logp": b["logp"],
             "adv": adv.astype(np.float32),
             "returns": ret.astype(np.float32)}, "cpu")
        return len(adv)

    def grad(self, params):
        """One minibatch gradient on the resident batch: (gradient tree of
        CPU tensors, aux floats)."""
        n = len(self.batch["adv"])
        mbs = min(self.cfg["minibatch_size"], n)
        idx = torch.from_numpy(self.rng.permutation(n)[:mbs])
        mb = {k: v[idx] for k, v in self.batch.items()}
        (loss, aux), grads = value_and_grad(self._loss, params, mb)
        return (tree_unflatten_like(params, grads),
                read_aux({"loss": loss, **aux}))

    def init_collective(self, rank: int, world: int, backend: str,
                        group: str = "ddppo_grads") -> bool:
        """Join the fleet-wide gradient-allreduce group (the reference's
        torch.distributed process group, as a ray_tpu_torch.collective
        host group — gradients cross rank-to-rank, not through the
        driver)."""
        from ray_tpu_torch import collective as col

        self._col_group = group
        self._col_rank = rank
        self._col_world = world
        col.init_collective_group(world, rank, group, backend=backend)
        return True

    def grad_reduced(self, params):
        """One minibatch gradient, allreduced across the fleet in place.

        Returns (mean_grads, aux) on rank 0 and (None, aux) elsewhere —
        the driver applies rank 0's result, so the full gradient tree
        crosses the driver wire once instead of num_workers times."""
        from ray_tpu_torch import collective as col

        grads, aux = self.grad(params)
        total = col.allreduce(tree_map(lambda g: g.numpy(), grads),
                              self._col_group)
        if self._col_rank != 0:
            return None, aux
        world = self._col_world
        return tree_map(lambda g: torch.from_numpy(np.asarray(g / world)),
                        total), aux

    def episode_stats(self):
        return self.inner.episode_stats()


@dataclass
class DDPPOConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 128
    num_sgd_iter: int = 8            # allreduced gradient steps per iter
    minibatch_size: int = 64         # per worker
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    # connector factories + network choice, same semantics as PPOConfig.
    # Connector state here is per-worker only (experience never leaves the
    # worker, so there is no central merge point by design).
    obs_connectors: Any = None
    network: str = "auto"
    cnn_hidden: int = 512
    seed: int = 0
    # Host-collective gradient exchange (ray_tpu_torch.collective backend
    # name: "auto"/"gather"/"ring"/"hier"). None keeps the star topology
    # (driver-side mean). With a backend set, gradients allreduce
    # rank-to-rank and only rank 0 ships the mean to the driver —
    # driver ingress drops from num_workers x |grads| to 1 x |grads|.
    collective_backend: Optional[str] = None
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class DDPPOTrainer(Algorithm):
    """ref: ddppo.py training_step — the driver never sees a sample:
    workers hold their fragments, each SGD iteration is a fleet-wide
    gradient mean applied once and rebroadcast."""

    def _setup(self, cfg: DDPPOConfig):
        from ray_tpu_torch.rl.core import probe_connected_spec
        from ray_tpu_torch.rl.ppo import init_any_policy

        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_shape, n_actions = probe_connected_spec(
            cfg.env, cfg.env_config, cfg.obs_connectors, cfg.seed)
        self.params = to_device(init_any_policy(
            torch.Generator().manual_seed(cfg.seed), obs_shape, n_actions,
            cfg), self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = None
        cfg_dict = {"gamma": cfg.gamma, "lam": cfg.lam, "clip": cfg.clip,
                    "vf_coeff": cfg.vf_coeff,
                    "entropy_coeff": cfg.entropy_coeff,
                    "minibatch_size": cfg.minibatch_size}
        self.workers = [
            _DDPPOWorker.options(runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config, cfg_dict,
                cfg.obs_connectors)
            for i in range(cfg.num_rollout_workers)]
        if cfg.collective_backend:
            world = cfg.num_rollout_workers
            ray_tpu_torch.get(
                [w.init_collective.remote(i, world, cfg.collective_backend)
                 for i, w in enumerate(self.workers)], timeout=240)
        self.timesteps = 0

    def _apply(self, grads_list):
        """The mean of the workers' gradients, one Adam step."""
        if self.opt_state is None:
            self.opt_state = self.opt.init(self.params)
        per_leaf = zip(*[[g.to(self.device) for g in tree_leaves(gs)]
                         for gs in grads_list])
        mean = [sum(g) / len(g) for g in per_leaf]
        self.opt.step(self.params, mean, self.opt_state)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        params_host = to_host(self.params)
        ns = ray_tpu_torch.get([w.sample.remote(params_host,
                                                cfg.rollout_fragment_length)
                                for w in self.workers])
        self.timesteps += sum(ns)

        aux = {}
        for _ in range(cfg.num_sgd_iter):
            if cfg.collective_backend:
                # fleet-side allreduce: driver receives ONE gradient tree
                # (rank 0's mean) instead of num_workers of them
                results = ray_tpu_torch.get(
                    [w.grad_reduced.remote(params_host)
                     for w in self.workers])
                grads_list = [results[0][0]]
            else:
                results = ray_tpu_torch.get([w.grad.remote(params_host)
                                             for w in self.workers])
                grads_list = [g for g, _ in results]
            aux = results[0][1]
            self._apply(grads_list)
            params_host = to_host(self.params)

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            **aux,
        }

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
