"""SlateQ: Q-learning for slate recommendation.

Port of ``ray_tpu/rl/slateq.py`` (reference: rllib/algorithms/slateq/
(slateq.py, slateq_tf_policy.py — Ie et al. 2019: the combinatorial slate
action is made tractable by decomposing Q(s, slate) = sum_i P(click i |
s, slate) * Q(s, i) under a conditional-logit user choice model, so only
per-ITEM Q values are learned; slates are built greedily from
click-weighted item values)). ``SlateRecEnv`` is the reference's numpy
env. Sampling runs on CPU actors (the forward under
``torch.inference_mode()``); the per-item Q-net, its target and the Adam
state live on the learner's device (CUDA unless ``SlateQConfig.device``
is "cpu").

The target's greedy slate is the top k of the click-weighted values, the
lower index first among equal values, as ``jax.lax.top_k`` orders them:
a stable descending sort, where ``torch.topk`` promises no order for
ties.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   ReplayBuffer, clone_tree,
                                   episode_stats_from, minibatch_to_device,
                                   mlp_forward, mlp_init, placement,
                                   to_device, to_host)
from ray_tpu_torch.rl.dqn import make_q_update


class SlateRecEnv:
    """Slate recommendation with a conditional-logit user.

    Each episode: `n_docs` candidate docs with feature vectors and a
    user-interest vector (both visible to the agent — the reference's
    RecSim exposes doc observations and user observations the same way).
    The agent presents a slate of `slate_size` docs; the user clicks doc
    i with probability exp(u.f_i) / (sum_slate exp(u.f_j) + exp(b_null)),
    yielding reward u.f_i and drifting the user toward the clicked doc.
    """

    def __init__(self, n_docs: int = 10, dim: int = 4, slate_size: int = 3,
                 episode_len: int = 20, null_bias: float = 0.5,
                 seed: int = 0):
        self.n_docs = n_docs
        self.dim = dim
        self.slate_size = slate_size
        self.episode_len = episode_len
        self.null_bias = null_bias
        self._rng = np.random.default_rng(seed)
        self.reset()

    def _obs(self):
        return {"user": self.user.copy(), "docs": self.docs.copy()}

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.user = self._rng.normal(0, 1, self.dim).astype(np.float32)
        self.user /= np.linalg.norm(self.user)
        self.docs = self._rng.normal(0, 1, (self.n_docs, self.dim)) \
            .astype(np.float32)
        self.docs /= np.linalg.norm(self.docs, axis=1, keepdims=True)
        self.t = 0
        return self._obs()

    def click_scores(self, slate) -> np.ndarray:
        return np.exp(self.docs[list(slate)] @ self.user)

    def step(self, slate):
        assert len(set(slate)) == self.slate_size
        v = self.click_scores(slate)
        probs = np.concatenate([v, [np.exp(self.null_bias)]])
        probs /= probs.sum()
        choice = self._rng.choice(len(probs), p=probs)
        self.t += 1
        done = self.t >= self.episode_len
        if choice == len(slate):              # no click
            return self._obs(), 0.0, -1, done
        doc = slate[choice]
        rew = float(self.docs[doc] @ self.user)
        # interest drift toward the consumed doc
        self.user = 0.9 * self.user + 0.1 * self.docs[doc]
        self.user /= np.linalg.norm(self.user)
        return self._obs(), rew, int(doc), done


# --- per-item Q network ------------------------------------------------------


def init_slateq_net(gen: torch.Generator, dim: int, hidden: int):
    return mlp_init(gen, [2 * dim, hidden, hidden, 1])


def item_q(net, user, docs):
    """Q(s, i) for every candidate: user [B,D], docs [B,N,D] -> [B,N]."""
    B, N, D = docs.shape
    u = user[:, None, :].expand(B, N, D)
    return mlp_forward(net, torch.cat([u, docs], -1))[..., 0]


def greedy_slate(q: np.ndarray, scores: np.ndarray, k: int) -> List[int]:
    """Greedy slate from click-weighted item values (ref: slateq.py
    slate construction — exact optimization is O(N choose k); top-k of
    v_i * Q_i is the standard greedy surrogate)."""
    return list(np.argsort(-(scores * q))[:k])


def slate_value(q: np.ndarray, scores: np.ndarray, slate: List[int],
                null_bias: float) -> float:
    """E[Q | choice model] over a slate including the no-click option."""
    v = scores[slate]
    denom = v.sum() + np.exp(null_bias)
    return float((v * q[slate]).sum() / denom)


def top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of each row, largest first and
    the lower index first among equal values (``jax.lax.top_k``'s
    order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def make_slateq_loss(gamma: float, slate_size: int, null_bias: float):
    """``loss_fn(net, target, mb) -> (loss, {})``: the squared TD error of
    the clicked item's Q against r + gamma * SlateValue(s', the target's
    greedy slate), averaged over the clicked rows only."""
    null = float(np.exp(null_bias))

    def next_value(target, mb):
        """SlateValue(s', greedy slate under the TARGET net)."""
        q = item_q(target, mb["next_user"], mb["next_docs"])    # [B,N]
        scores = torch.exp(torch.einsum("bnd,bd->bn", mb["next_docs"],
                                        mb["next_user"]))
        idx = top_k_stable(scores * q, slate_size)
        v = scores.gather(-1, idx)
        qs = q.gather(-1, idx)
        return (v * qs).sum(-1) / (v.sum(-1) + null)

    def loss_fn(net, target, mb):
        with torch.no_grad():
            nv = next_value(target, mb)
            tgt = mb["rewards"] + gamma * (1 - mb["dones"]) * nv
        q_all = item_q(net, mb["user"], mb["docs"])
        clicked = mb["clicked"]
        has_click = (clicked >= 0).to(q_all.dtype)
        # no-click rows still need a valid gather index
        safe = clicked.clamp(min=0)
        q_sel = q_all.gather(-1, safe[:, None])[:, 0]
        td = q_sel - tgt
        # only clicked items receive the item-level TD update
        # (ref: slateq SARSA update on the clicked doc)
        return (has_click * torch.square(td)).sum() / \
            torch.clamp(has_click.sum(), min=1.0), {}

    return loss_fn


# --- rollout worker ----------------------------------------------------------


@ray_tpu_torch.remote
class _SlateWorker:
    def __init__(self, env_config: dict, seed: int):
        self.env = SlateRecEnv(**{**env_config, "seed": seed})
        self.rng = np.random.default_rng(seed)
        self.obs = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed: List[float] = []

    @torch.inference_mode()
    def sample(self, net, num_steps: int, epsilon: float):
        """`net`: the Q-net's CPU tensors."""
        k = self.env.slate_size
        cols = {c: [] for c in ("user", "docs", "slate", "clicked",
                                "rewards", "dones", "next_user",
                                "next_docs")}
        for _ in range(num_steps):
            user, docs = self.obs["user"], self.obs["docs"]
            if self.rng.random() < epsilon:
                slate = list(self.rng.choice(self.env.n_docs, k,
                                             replace=False))
            else:
                q = item_q(net, torch.as_tensor(user)[None],
                           torch.as_tensor(docs)[None])[0].numpy()
                scores = np.exp(docs @ user)
                slate = greedy_slate(q, scores, k)
            nobs, rew, clicked, done = self.env.step(slate)
            cols["user"].append(user)
            cols["docs"].append(docs)
            cols["slate"].append(np.asarray(slate, np.int32))
            cols["clicked"].append(clicked)
            cols["rewards"].append(rew)
            cols["dones"].append(float(done))
            cols["next_user"].append(nobs["user"])
            cols["next_docs"].append(nobs["docs"])
            self.episode_return += rew
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                nobs = self.env.reset()
            self.obs = nobs
        out = {c: np.stack(v) for c, v in cols.items()}
        out["clicked"] = np.asarray(cols["clicked"], np.int32)
        out["rewards"] = np.asarray(cols["rewards"], np.float32)
        out["dones"] = np.asarray(cols["dones"], np.float32)
        return out

    def episode_stats(self):
        return episode_stats_from(self.completed)

    def placement(self):
        return placement()


# --- trainer -----------------------------------------------------------------


@dataclass
class SlateQConfig:
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 40
    replay_capacity: int = 20_000
    learning_starts: int = 200
    train_batch_size: int = 64
    updates_per_iter: int = 16
    lr: float = 1e-3
    gamma: float = 0.95
    target_network_update_freq: int = 400  # in sampled env steps
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 5_000
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class SlateQTrainer(Algorithm):
    """ref: rllib/algorithms/slateq/slateq.py training_step — clicked
    transitions TD-train the per-item Q toward
    r + gamma * SlateValue(s', greedy slate'); no-click transitions
    carry no item-level gradient (the null option has no Q head), as in
    the reference's SARSA variant."""

    def _setup(self, cfg: SlateQConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        env = SlateRecEnv(**cfg.env_config)
        self.dim = env.dim
        self.slate_size = env.slate_size
        self.null_bias = env.null_bias
        self.net = to_device(init_slateq_net(
            torch.Generator().manual_seed(cfg.seed), env.dim, cfg.hidden),
            self.device)
        self.target = clone_tree(self.net)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.net)
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _SlateWorker.options(num_cpus=0.5,
                                 runtime_env=CPU_WORKER_ENV).remote(
                cfg.env_config, cfg.seed + i * 1000)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._since_target_sync = 0
        self._update = make_q_update(
            make_slateq_loss(cfg.gamma, self.slate_size, self.null_bias),
            self.opt)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.timesteps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        net_host = to_host(self.net)
        eps = self._epsilon()
        refs = [w.sample.remote(net_host, cfg.rollout_fragment_length, eps)
                for w in self.workers]
        ctr = 0
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            n = len(b["rewards"])
            self.timesteps += n
            self._since_target_sync += n
            ctr += int((b["clicked"] >= 0).sum())
        t1 = time.time()

        loss = float("nan")
        updates = 0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                mb = minibatch_to_device(
                    self.buffer.sample(cfg.train_batch_size), self.device)
                self.net, self.opt_state, loss, _ = self._update(
                    self.net, self.target, self.opt_state, mb)
                updates += 1
            if self._since_target_sync >= cfg.target_network_update_freq:
                self.target = clone_tree(self.net)
                self._since_target_sync = 0
            loss = float(loss)              # waits for the device
        t2 = time.time()

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "clicks_this_iter": ctr,
            "loss": loss,
            "num_updates": updates,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def get_weights(self):
        return self.net

    def set_weights(self, weights):
        self.net = to_device(weights, self.device)
        self.target = clone_tree(self.net)
