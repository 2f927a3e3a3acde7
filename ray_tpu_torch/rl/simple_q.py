"""SimpleQ (vanilla DQN) and RandomAgent baselines.

Port of ``ray_tpu/rl/simple_q.py`` (reference: rllib/algorithms/simple_q/
— the pedagogical Q-learning algorithm DQN builds on: single Q net +
target net, uniform replay, epsilon-greedy, no double-Q / dueling / n-step
/ prioritization — and rllib/algorithms/random_agent/random_agent.py, the
no-learning control baseline used in sanity benchmarks). SimpleQ's
learner is DQN's, on ``SimpleQConfig.device``; RandomAgent has none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.core import CPU_WORKER_ENV, Algorithm, EnvSampler
from ray_tpu_torch.rl.dqn import DQNConfig, DQNTrainer


@dataclass
class SimpleQConfig(DQNConfig):
    # the whole point of SimpleQ is that these stay off
    double_q: bool = False
    dueling: bool = False


class SimpleQTrainer(DQNTrainer):
    """ref: rllib/algorithms/simple_q/simple_q.py training_step — the
    DQN loop with the extensions disabled; shares the sampler fleet and
    the TD update with DQNTrainer."""

    def _setup(self, cfg: SimpleQConfig):
        assert not cfg.double_q and not cfg.dueling, (
            "SimpleQ is plain Q-learning; use DQNConfig for double/dueling")
        super()._setup(cfg)


@ray_tpu_torch.remote(num_cpus=0.5)
class _RandomWorker(EnvSampler):
    def sample(self, num_steps: int):
        for _ in range(num_steps):
            self.step_env(self.env.action_space.sample())
        return num_steps


@dataclass
class RandomAgentConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = None
    num_rollout_workers: int = 1
    rollout_fragment_length: int = 200
    seed: int = 0


class RandomAgentTrainer(Algorithm):
    """ref: rllib/algorithms/random_agent/random_agent.py — uniform
    random actions, no parameters; reports the same episode metrics so
    it slots into tune sweeps as the floor baseline."""

    def _setup(self, cfg: RandomAgentConfig):
        self.workers = [
            _RandomWorker.options(runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config or {})
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = sum(ray_tpu_torch.get([
            w.sample.remote(cfg.rollout_fragment_length)
            for w in self.workers]))
        self.timesteps += n
        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
        }

    def get_weights(self):
        return {}

    def set_weights(self, weights):
        pass

    def save(self) -> Dict[str, Any]:
        return {"params": {}, "iteration": self.iteration}
