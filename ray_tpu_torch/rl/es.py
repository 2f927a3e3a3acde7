"""Evolution strategies: ES (OpenAI) and ARS on the rollout-actor fleet.

Port of ``ray_tpu/rl/es.py``, numpy as the reference is (no learner, no
device: the update is a vector sum on the host; the evaluation actors run
on the CPU, ``core.CPU_WORKER_ENV``, and build their env through
``core.make_env``, so "module:Class" envs work there too).

Reference: rllib/algorithms/es/ (Salimans et al. 2017 — antithetic
Gaussian perturbations, centered-rank fitness shaping, shared noise
regenerated from seeds so only scalars cross the wire) and
rllib/algorithms/ars/ (Mania et al. 2018 — top-k directions scaled by
the std of their returns). Embarrassingly parallel episode evaluation is
the whole workload, so this is the purest expression of the actor-fleet
pattern: the "gradient" is assembled from scalar returns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Algorithm,
                                   episode_stats_from, make_env,
                                   probe_env_spec)


# --- deterministic flat-vector policy ---------------------------------------


def _layer_shapes(obs_dim: int, out_dim: int, hidden: int):
    sizes = [obs_dim, hidden, hidden, out_dim]
    return [(i, o) for i, o in zip(sizes[:-1], sizes[1:])]


def flat_dim(obs_dim: int, out_dim: int, hidden: int) -> int:
    return sum(i * o + o for i, o in _layer_shapes(obs_dim, out_dim, hidden))


def policy_act(flat: np.ndarray, obs: np.ndarray, obs_dim: int,
               out_dim: int, hidden: int, discrete: bool, act_high: float):
    """Forward the flat parameter vector directly — perturbation math
    stays a single vector add, no tree plumbing."""
    x = obs.astype(np.float32)
    off = 0
    shapes = _layer_shapes(obs_dim, out_dim, hidden)
    for n, (i, o) in enumerate(shapes):
        w = flat[off:off + i * o].reshape(i, o)
        off += i * o
        b = flat[off:off + o]
        off += o
        x = x @ w + b
        if n < len(shapes) - 1:
            x = np.tanh(x)
    if discrete:
        return int(np.argmax(x))
    return np.clip(np.tanh(x) * act_high, -act_high, act_high)


@ray_tpu_torch.remote
class _ESWorker:
    """Evaluates antithetic perturbation pairs; noise is regenerated from
    the seed on both ends so only (seed, return) scalars travel
    (ref: es.py SharedNoiseTable — same trick, seed-keyed)."""

    def __init__(self, env_name: str, env_config, obs_dim, out_dim, hidden,
                 discrete, act_high, max_episode_steps: int):
        self.env = make_env(env_name, env_config)
        self.spec = (obs_dim, out_dim, hidden, discrete, act_high)
        self.max_steps = max_episode_steps
        self.completed: List[float] = []
        self._steps = 0

    def _episode(self, flat: np.ndarray, seed: int) -> float:
        obs, _ = self.env.reset(seed=seed)
        total = 0.0
        for _ in range(self.max_steps):
            a = policy_act(flat, np.asarray(obs).reshape(-1), *self.spec)
            obs, rew, term, trunc, _ = self.env.step(a)
            total += float(rew)
            self._steps += 1
            if term or trunc:
                break
        self.completed.append(total)
        return total

    def evaluate(self, flat: np.ndarray, seeds: List[int], sigma: float):
        self._steps = 0
        r_pos, r_neg = [], []
        for s in seeds:
            eps = np.random.default_rng(s).standard_normal(
                len(flat)).astype(np.float32)
            r_pos.append(self._episode(flat + sigma * eps, s))
            r_neg.append(self._episode(flat - sigma * eps, s))
        return {"seeds": seeds, "r_pos": np.asarray(r_pos, np.float32),
                "r_neg": np.asarray(r_neg, np.float32),
                "steps": self._steps}

    def episode_stats(self):
        return episode_stats_from(self.completed)


def _noise(seed: int, dim: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: returns -> ranks in [-0.5, 0.5] (ref: es.py
    compute_centered_ranks)."""
    ranks = np.empty(len(x), np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / (len(x) - 1) - 0.5


@dataclass
class ESConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    episodes_per_iter: int = 16      # antithetic PAIRS per iteration
    sigma: float = 0.1               # perturbation stddev
    lr: float = 0.02
    l2_coeff: float = 0.005
    max_episode_steps: int = 500
    hidden: int = 32
    seed: int = 0


class _EvolutionBase(Algorithm):
    """Shared fleet setup + seed fan-out for ES/ARS."""

    def _setup(self, cfg):
        obs_dim, n_actions, act_dim, act_high = probe_env_spec(
            cfg.env, cfg.env_config)
        self.discrete = n_actions is not None
        out_dim = n_actions if self.discrete else act_dim
        self.dim = flat_dim(obs_dim, out_dim, cfg.hidden)
        rng = np.random.default_rng(cfg.seed)
        self.flat = (rng.standard_normal(self.dim) * 0.05).astype(np.float32)
        self.workers = [
            _ESWorker.options(num_cpus=0.5, runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.env_config, obs_dim, out_dim, cfg.hidden,
                self.discrete, act_high or 1.0, cfg.max_episode_steps)
            for _ in range(cfg.num_rollout_workers)]
        self._seed_counter = cfg.seed * 1_000_003
        self.timesteps = 0

    def _fan_out(self, n_pairs: int, sigma: float):
        """Distribute n_pairs antithetic evaluations over the fleet;
        returns (seeds, r_pos, r_neg) concatenated in seed order."""
        seeds = [self._seed_counter + i for i in range(n_pairs)]
        self._seed_counter += n_pairs
        chunks = np.array_split(np.asarray(seeds), len(self.workers))
        refs = [w.evaluate.remote(self.flat, list(map(int, c)), sigma)
                for w, c in zip(self.workers, chunks) if len(c)]
        out = ray_tpu_torch.get(refs)
        r_pos = np.concatenate([o["r_pos"] for o in out])
        r_neg = np.concatenate([o["r_neg"] for o in out])
        self.timesteps += sum(o["steps"] for o in out)
        return np.asarray(seeds), r_pos, r_neg

    def _result(self, extra: Dict[str, Any]) -> Dict[str, Any]:
        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "timesteps_total": self.timesteps,
            **extra,
        }

    def get_weights(self):
        return self.flat

    def set_weights(self, weights):
        self.flat = np.asarray(weights, np.float32)


class ESTrainer(_EvolutionBase):
    """OpenAI-ES: grad = E[centered_rank(R) * eps / sigma], Adam-free
    plain SGD with L2 pull toward 0 (ref: es.py Worker.do_rollouts +
    optimizers.py)."""

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds, r_pos, r_neg = self._fan_out(cfg.episodes_per_iter, cfg.sigma)
        ranks = _centered_ranks(np.concatenate([r_pos, r_neg]))
        u_pos, u_neg = ranks[:len(r_pos)], ranks[len(r_pos):]
        grad = np.zeros(self.dim, np.float32)
        for s, up, un in zip(seeds, u_pos, u_neg):
            grad += (up - un) * _noise(int(s), self.dim)
        grad /= (2 * len(seeds) * cfg.sigma)
        self.flat = ((1 - cfg.l2_coeff * cfg.lr) * self.flat
                     + cfg.lr * grad)
        return self._result({
            "reward_mean_pos": float(r_pos.mean()),
            "reward_mean_neg": float(r_neg.mean()),
            "grad_norm": float(np.linalg.norm(grad)),
        })


@dataclass
class ARSConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    num_directions: int = 16         # sampled directions per iteration
    top_directions: int = 8          # b best kept for the update
    sigma: float = 0.1
    step_size: float = 0.02
    max_episode_steps: int = 500
    hidden: int = 32
    seed: int = 0


class ARSTrainer(_EvolutionBase):
    """ARS V1-t: keep the top-b directions by max(r+, r-), scale the step
    by the std of their returns (ref: ars.py)."""

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds, r_pos, r_neg = self._fan_out(cfg.num_directions, cfg.sigma)
        scores = np.maximum(r_pos, r_neg)
        top = np.argsort(scores)[-cfg.top_directions:]
        sigma_r = np.concatenate([r_pos[top], r_neg[top]]).std() + 1e-8
        grad = np.zeros(self.dim, np.float32)
        for i in top:
            grad += (r_pos[i] - r_neg[i]) * _noise(int(seeds[i]), self.dim)
        self.flat = self.flat + (
            cfg.step_size / (cfg.top_directions * sigma_r)) * grad
        return self._result({
            "reward_mean_top": float(scores[top].mean()),
            "sigma_r": float(sigma_r),
        })
