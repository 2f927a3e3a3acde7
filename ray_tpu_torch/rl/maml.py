"""MAML: model-agnostic meta-learning for RL.

Port of ``ray_tpu/rl/maml.py`` (reference: rllib/algorithms/maml/
(maml.py — Finn et al. 2017: sample a batch of TASKS; per task, collect
pre-adaptation rollouts, take an inner policy-gradient step, collect
post-adaptation rollouts; the meta-update differentiates the
post-adaptation objective THROUGH the inner step)). The task family is
the reference's 2-D point navigation with per-task goals
(``PointGoalEnv``, ``sample_goal``: numpy on CPU actors).

The inner step is differentiable: ``inner_adapt`` takes
``torch.autograd.grad(pg_loss(p, pre), p, create_graph=True)`` and
returns ``p - inner_lr * g``, so the meta-gradient flows through the
inner gradient (second order), as ``jax.grad`` of a function holding
``jax.grad`` does in the reference. The policy and its Adam state live on
the learner's device (CUDA unless ``MAMLConfig.device`` is "cpu").
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   minibatch_to_device, mlp_forward,
                                   mlp_init, placement, to_device,
                                   to_host, tree_leaves,
                                   tree_unflatten_like, value_and_grad)


# --- task env: point navigation ---------------------------------------------


class PointGoalEnv:
    """Agent on the 2-D plane; action = velocity in [-1,1]^2 (scaled by
    0.1); reward = -distance to the task's goal. The goal is the task."""

    H = 20                      # horizon
    OBS_DIM = 2
    ACT_DIM = 2

    def __init__(self, goal: np.ndarray):
        self.goal = np.asarray(goal, np.float32)
        self.pos = np.zeros(2, np.float32)
        self.t = 0

    def reset(self):
        self.pos = np.zeros(2, np.float32)
        self.t = 0
        return self.pos.copy()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1, 1)
        self.pos = self.pos + 0.1 * a
        self.t += 1
        rew = -float(np.linalg.norm(self.pos - self.goal))
        return self.pos.copy(), rew, self.t >= self.H


def sample_goal(rng) -> np.ndarray:
    ang = rng.uniform(0, 2 * np.pi)
    r = rng.uniform(0.5, 1.0)
    return np.asarray([r * np.cos(ang), r * np.sin(ang)], np.float32)


# --- Gaussian policy ---------------------------------------------------------


def init_maml_policy(gen: torch.Generator, hidden: int):
    return {"net": mlp_init(gen, [PointGoalEnv.OBS_DIM, hidden, hidden,
                                  PointGoalEnv.ACT_DIM], out_scale=0.01),
            "log_std": torch.full((PointGoalEnv.ACT_DIM,), -0.5)}


def policy_mean(params, obs):
    return mlp_forward(params["net"], obs)


def gaussian_logp(params, obs, acts):
    mu = policy_mean(params, obs)
    # clamp's gradient is 1 inside [-3, 1] and 0 outside, as jnp.clip's
    log_std = torch.clamp(params["log_std"], -3.0, 1.0)
    return (-0.5 * torch.square((acts - mu) / torch.exp(log_std))
            - log_std - 0.5 * np.log(2 * np.pi)).sum(-1)


def pg_loss(params, batch):
    """REINFORCE with reward-to-go advantages (the MAML paper's inner
    objective; adv normalized per batch)."""
    logp = gaussian_logp(params, batch["obs"], batch["actions"])
    return -(logp * batch["adv"]).mean()


def inner_adapt(params, batch, inner_lr: float):
    """One inner gradient step, ``params - inner_lr * grad pg_loss``.

    On params whose leaves require grad (inside the meta-loss) the step is
    differentiable: the gradient of what is computed from the result flows
    back through the inner gradient too (second order, ``jax.grad``
    through ``jax.grad``). On plain tensors (a worker's or ``adapt``'s
    use) it is a numeric step, and the result is detached."""
    leaves = tree_leaves(params)
    numeric = not leaves[0].requires_grad
    if numeric:
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_unflatten_like(params, leaves)
    with torch.enable_grad():
        grads = torch.autograd.grad(pg_loss(params, batch), leaves,
                                    create_graph=not numeric)
        new = [p - inner_lr * g for p, g in zip(leaves, grads)]
    if numeric:
        new = [x.detach() for x in new]
    return tree_unflatten_like(params, new)


def make_meta_update(opt, inner_lr: float):
    """``meta_update(params, opt_state, pres, posts) -> (params, opt_state,
    loss)``: one Adam step on the post-adaptation loss averaged over the
    tasks, differentiated through each task's inner step (the params
    updated in place, the loss on the device)."""
    def total(p, pres, posts):
        losses = [pg_loss(inner_adapt(p, pre, inner_lr), post)
                  for pre, post in zip(pres, posts)]
        return sum(losses) / len(losses), {}

    def meta_update(params, opt_state, pres, posts):
        if opt_state is None:
            opt_state = opt.init(params)
        (loss, _), grads = value_and_grad(total, params, pres, posts)
        opt.step(params, grads, opt_state)
        return params, opt_state, loss

    return meta_update


# --- rollout worker ----------------------------------------------------------


@torch.inference_mode()
def _rollout(env: PointGoalEnv, params, episodes: int, gamma: float, rng):
    """`params`: the policy's CPU tensors."""
    obs_l, act_l, rew_l = [], [], []
    returns = []
    std = np.exp(np.clip(params["log_std"].numpy(), -3, 1))
    for _ in range(episodes):
        obs = env.reset()
        ep_rews = []
        for _ in range(env.H):
            mu = policy_mean(params, torch.from_numpy(obs)[None])[0].numpy()
            a = (mu + std * rng.standard_normal(env.ACT_DIM)).astype(
                np.float32)
            nobs, rew, done = env.step(a)
            obs_l.append(obs)
            act_l.append(a)
            ep_rews.append(rew)
            obs = nobs
        # reward-to-go within the episode
        rtg = np.asarray(ep_rews, np.float32)
        for t in range(len(rtg) - 2, -1, -1):
            rtg[t] += gamma * rtg[t + 1]
        rew_l.append(rtg)
        returns.append(float(np.sum(ep_rews)))
    adv = np.concatenate(rew_l)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    return {"obs": np.stack(obs_l).astype(np.float32),
            "actions": np.stack(act_l),
            "adv": adv.astype(np.float32)}, float(np.mean(returns))


def _as_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@ray_tpu_torch.remote
class _MAMLWorker:
    """One task per call: sample a goal, collect pre-adaptation data,
    adapt locally (numerically), collect post-adaptation data. The
    learner re-plays the adaptation differentiably inside the meta-loss."""

    def __init__(self, seed: int, inner_lr: float, gamma: float,
                 episodes_per_task: int):
        self.rng = np.random.default_rng(seed)
        self.inner_lr = inner_lr
        self.gamma = gamma
        self.episodes = episodes_per_task

    def sample_task(self, params) -> Tuple[dict, dict, float, float]:
        env = PointGoalEnv(sample_goal(self.rng))
        pre, ret_pre = _rollout(env, params, self.episodes, self.gamma,
                                self.rng)
        adapted = inner_adapt(params, _as_tensors(pre), self.inner_lr)
        post, ret_post = _rollout(env, adapted, self.episodes, self.gamma,
                                  self.rng)
        return pre, post, ret_pre, ret_post

    def placement(self):
        return placement()


# --- trainer -----------------------------------------------------------------


@dataclass
class MAMLConfig:
    num_rollout_workers: int = 2     # == tasks per meta-batch
    episodes_per_task: int = 4
    inner_lr: float = 0.1
    meta_lr: float = 1e-3
    gamma: float = 0.99
    hidden: int = 32
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class MAMLTrainer(Algorithm):
    """ref: maml.py training_step — fan tasks out, meta-gradient of the
    post-adaptation loss through the inner step, averaged over tasks."""

    def _setup(self, cfg: MAMLConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self.params = to_device(init_maml_policy(
            torch.Generator().manual_seed(cfg.seed), cfg.hidden),
            self.device)
        self.opt = Adam(cfg.meta_lr)
        self.opt_state = self.opt.init(self.params)
        self.workers = [
            _MAMLWorker.options(num_cpus=0.5,
                                runtime_env=CPU_WORKER_ENV).remote(
                cfg.seed + i * 1000, cfg.inner_lr, cfg.gamma,
                cfg.episodes_per_task)
            for i in range(cfg.num_rollout_workers)]
        self.tasks_total = 0
        self._meta_update = make_meta_update(self.opt, cfg.inner_lr)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        params_host = to_host(self.params)
        results = ray_tpu_torch.get([w.sample_task.remote(params_host)
                                     for w in self.workers])
        t1 = time.time()
        pres = [minibatch_to_device(pre, self.device)
                for pre, _, _, _ in results]
        posts = [minibatch_to_device(post, self.device)
                 for _, post, _, _ in results]
        self.params, self.opt_state, loss = self._meta_update(
            self.params, self.opt_state, pres, posts)
        loss = float(loss)                  # waits for the device
        t2 = time.time()
        self.tasks_total += len(results)
        return {
            "tasks_total": self.tasks_total,
            "meta_loss": loss,
            "pre_adapt_return_mean": float(np.mean(
                [r[2] for r in results])),
            "post_adapt_return_mean": float(np.mean(
                [r[3] for r in results])),
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def adapt(self, goal, episodes: int = 4) -> Tuple[dict, float, float]:
        """Adapt to a NEW task with one inner step; returns (adapted
        params, pre-return, post-return) — the deployment-time API (on the
        CPU, no graph kept)."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + 999)
        env = PointGoalEnv(np.asarray(goal, np.float32))
        params_host = to_host(self.params)
        pre, ret_pre = _rollout(env, params_host, episodes, cfg.gamma, rng)
        adapted = inner_adapt(params_host, _as_tensors(pre), cfg.inner_lr)
        _, ret_post = _rollout(env, adapted, episodes, cfg.gamma, rng)
        return adapted, ret_pre, ret_post

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
