"""Contextual bandits: LinUCB and Linear Thompson Sampling.

Port of ``ray_tpu/rl/bandit.py``: numpy, as the reference is, so a copy
(no learner, no device).

Reference: rllib/algorithms/bandit/ (bandit.py BanditLinUCB/BanditLinTS;
exact incremental ridge-regression arms in bandit_torch_model.py
DiscreteLinearModel). Closed-form per-arm posteriors — no gradient
learner; the "training step" is env interaction + rank-1 updates, so this
runs in the calling process, like rllib's single-worker bandit
configs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


class LinearDiscreteBanditEnv:
    """Test-friendly contextual bandit (ref: rllib
    examples/env/bandit_envs_discrete.py): reward = theta_a . x + noise,
    one-step episodes, gymnasium-shaped API."""

    def __init__(self, num_arms: int = 4, context_dim: int = 8,
                 noise: float = 0.01, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.theta = self.rng.standard_normal((num_arms, context_dim))
        self.theta /= np.linalg.norm(self.theta, axis=1, keepdims=True)
        self.num_arms, self.context_dim, self.noise = (
            num_arms, context_dim, noise)
        self._ctx = None

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self._ctx = self.rng.standard_normal(self.context_dim).astype(
            np.float32)
        return self._ctx, {}

    def step(self, action: int):
        rew = float(self.theta[action] @ self._ctx
                    + self.rng.normal(0, self.noise))
        best = float(np.max(self.theta @ self._ctx))
        info = {"regret": best - float(self.theta[action] @ self._ctx)}
        return self._ctx, rew, True, False, info


class _LinearArm:
    """One arm's ridge posterior, Sherman–Morrison incremental inverse."""

    def __init__(self, dim: int, lam: float):
        self.A_inv = np.eye(dim, dtype=np.float64) / lam
        self.b = np.zeros(dim, np.float64)

    @property
    def theta(self) -> np.ndarray:
        return self.A_inv @ self.b

    def update(self, x: np.ndarray, r: float):
        Ax = self.A_inv @ x
        self.A_inv -= np.outer(Ax, Ax) / (1.0 + x @ Ax)
        self.b += r * x


@dataclass
class BanditConfig:
    env: Any = None                  # factory or instance; default test env
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_arms: int = 4
    context_dim: int = 8
    steps_per_iter: int = 100
    alpha: float = 1.0               # LinUCB exploration width
    ts_scale: float = 1.0            # LinTS posterior scale v
    ridge_lambda: float = 1.0
    seed: int = 0


class _BanditBase:
    def __init__(self, config: BanditConfig):
        self.config = config
        env = config.env
        if env is None:
            kw = {"num_arms": config.num_arms,
                  "context_dim": config.context_dim, "seed": config.seed}
            kw.update(config.env_config)   # env_config wins, no dup kwarg
            env = LinearDiscreteBanditEnv(**kw)
        elif callable(env):
            env = env(config.env_config)
        self.env = env
        # size the arm set from the ENV when it says (a custom env's arm
        # count must win over the config default, else arms go unplayed)
        self.num_arms = int(getattr(env, "num_arms", config.num_arms))
        self.context_dim = int(getattr(env, "context_dim",
                                       config.context_dim))
        self.arms = [
            _LinearArm(self.context_dim, config.ridge_lambda)
            for _ in range(self.num_arms)]
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.timesteps = 0
        self.cum_regret = 0.0

    def _select(self, x: np.ndarray) -> int:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        rewards = []
        for _ in range(cfg.steps_per_iter):
            x, _ = self.env.reset()
            x = np.asarray(x, np.float64)
            a = self._select(x)
            _, rew, _, _, info = self.env.step(a)
            self.arms[a].update(x, rew)
            rewards.append(rew)
            self.cum_regret += float(info.get("regret", 0.0))
            self.timesteps += 1
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(rewards)),
            "cumulative_regret": self.cum_regret,
        }

    def save(self):
        return {"arms": [(a.A_inv.copy(), a.b.copy()) for a in self.arms],
                "iteration": self.iteration}

    def restore(self, ckpt):
        for arm, (A_inv, b) in zip(self.arms, ckpt["arms"]):
            arm.A_inv, arm.b = A_inv, b
        self.iteration = ckpt.get("iteration", 0)

    def stop(self):
        pass


class LinUCBTrainer(_BanditBase):
    """UCB over per-arm ridge posteriors: argmax theta.x + alpha*sqrt(
    x^T A^-1 x) (ref: bandit_torch_model.py predict + partial_fit)."""

    def _select(self, x: np.ndarray) -> int:
        scores = [arm.theta @ x
                  + self.config.alpha * np.sqrt(x @ arm.A_inv @ x)
                  for arm in self.arms]
        return int(np.argmax(scores))


class LinTSTrainer(_BanditBase):
    """Thompson sampling: theta ~ N(A^-1 b, v^2 A^-1) per arm, play the
    argmax draw (ref: bandit.py BanditLinTS)."""

    def _select(self, x: np.ndarray) -> int:
        v2 = self.config.ts_scale ** 2
        scores = [
            self.rng.multivariate_normal(arm.theta, v2 * arm.A_inv) @ x
            for arm in self.arms]
        return int(np.argmax(scores))


# Config aliases so the registry has distinct (config, trainer) pairs.
BanditLinUCBConfig = BanditConfig
BanditLinTSConfig = BanditConfig
