"""R2D2: recurrent replay distributed DQN.

Port of ``ray_tpu/rl/r2d2.py`` (reference: rllib/algorithms/r2d2/ (r2d2.py
— recurrent DQN over fixed-length stored-state sequences with burn-in,
double-Q, target network; "Recurrent Experience Replay in Distributed
RL", Kapturowski et al.)). The LSTM is the reference's own cell, not
``nn.LSTM`` (whose weight layout, gate order and biases differ): one fused
``[x, h] @ W`` of ``[2H, 4H]`` (``[in, out]``, so the reference's weights
carry over), gates i, f, g, o, a forget bias of +1. The unroll is a Python
loop over T where the reference has ``lax.scan``; the burn-in prefix runs
under ``torch.no_grad()`` (the reference's ``stop_gradient`` on the carry
it hands on: nothing else of the burn-in reaches the loss). Sequences (not
transitions) are the replay unit; each carries the LSTM state observed
when it was generated ("stored state" strategy). The learner on
``R2D2Config.device``; the rollout actors step the cell on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   EnvSampler, ReplayBuffer, clone_tree,
                                   dense_init, minibatch_to_device,
                                   mlp_forward, mlp_init, probe_env_spec,
                                   to_device, to_host)
from ray_tpu_torch.rl.dqn import make_q_update


# --- recurrent Q network -----------------------------------------------------


def init_rqnet(gen: torch.Generator, obs_dim: int, n_actions: int,
               hidden: int):
    return {
        "enc": mlp_init(gen, [obs_dim, hidden]),
        # one fused LSTM projection: [x, h] -> 4*hidden gates
        "lstm": dense_init(gen, 2 * hidden, 4 * hidden, scale=0.3),
        "q": mlp_init(gen, [hidden, n_actions], out_scale=0.01),
    }


def lstm_step(net, carry, x):
    """One LSTM cell step; carry = (h, c), x = encoded obs [..., H]."""
    h, c = carry
    gates = torch.cat([x, h], -1) @ net["lstm"]["w"] + net["lstm"]["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(i) * torch.tanh(g) + torch.sigmoid(f + 1.0) * c
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def rq_unroll(net, obs_seq, h0, c0):
    """Q values over a [B, T, obs] sequence from initial state.
    Returns (q [B, T, A], (h, c) final)."""
    enc = torch.tanh(mlp_forward(net["enc"], obs_seq))   # [B, T, H]
    carry, hs = (h0, c0), []
    for t in range(enc.shape[1]):
        carry, h = lstm_step(net, carry, enc[:, t])
        hs.append(h)
    return mlp_forward(net["q"], torch.stack(hs, 1)), carry


# --- rollout worker ----------------------------------------------------------


@ray_tpu_torch.remote(num_cpus=0.5)
class _R2D2Worker(EnvSampler):
    """Epsilon-greedy recurrent sampler emitting fixed-length sequences
    with their initial LSTM state (ref: r2d2 sequence collection via
    rollout_fragment_length = replay_sequence_length)."""

    def __init__(self, env_name: str, seed: int, hidden: int,
                 env_config: Optional[dict] = None):
        super().__init__(env_name, seed, env_config)
        self.rng = np.random.default_rng(seed)
        self.hidden = hidden
        self.h = np.zeros(hidden, np.float32)
        self.c = np.zeros(hidden, np.float32)

    @torch.inference_mode()
    def sample(self, net, num_seqs: int, seq_len: int, epsilon: float):
        """`net`: the recurrent Q-net's CPU tensors."""
        seqs = {k: [] for k in ("obs", "actions", "rewards", "dones",
                                "h0", "c0")}
        for _ in range(num_seqs):
            h0, c0 = self.h.copy(), self.c.copy()
            obs_l = [np.asarray(self.obs, np.float32)]
            act_l, rew_l, done_l = [], [], []
            for _ in range(seq_len):
                q, (h, c) = rq_unroll(
                    net, torch.as_tensor(
                        np.asarray(self.obs, np.float32))[None, None],
                    torch.from_numpy(self.h)[None],
                    torch.from_numpy(self.c)[None])
                self.h = h[0].numpy().copy()
                self.c = c[0].numpy().copy()
                if self.rng.random() < epsilon:
                    action = int(self.env.action_space.sample())
                else:
                    action = int(q[0, 0].argmax())
                _prev, rew, term, trunc, nobs = self.step_env(action)
                act_l.append(action)
                rew_l.append(rew)
                done_l.append(float(term))
                obs_l.append(np.asarray(nobs, np.float32))
                if term or trunc:
                    self.h = np.zeros(self.hidden, np.float32)
                    self.c = np.zeros(self.hidden, np.float32)
            seqs["obs"].append(np.stack(obs_l))          # [T+1, obs]
            seqs["actions"].append(np.asarray(act_l, np.int32))
            seqs["rewards"].append(np.asarray(rew_l, np.float32))
            seqs["dones"].append(np.asarray(done_l, np.float32))
            seqs["h0"].append(h0)
            seqs["c0"].append(c0)
        return {k: np.stack(v) for k, v in seqs.items()}


# --- trainer -----------------------------------------------------------------


@dataclass
class R2D2Config:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    seqs_per_worker: int = 4        # sequences sampled per worker per iter
    burn_in: int = 8                # warm-up steps, no gradient
    train_len: int = 16             # TD-loss steps per sequence
    replay_capacity: int = 2_000    # in sequences
    learning_starts: int = 16       # in sequences
    train_batch_size: int = 16      # sequences per update
    updates_per_iter: int = 8
    lr: float = 1e-3
    gamma: float = 0.99
    target_network_update_freq: int = 40   # in sampled sequences
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 10_000
    hidden: int = 32
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_r2d2_loss(burn_in: int, train_len: int, gamma: float):
    B_in, T = burn_in, train_len

    def loss_fn(net, target, mb):
        # burn-in: advance both hidden states without gradient
        h0, c0 = mb["h0"], mb["c0"]
        with torch.no_grad():
            if B_in:
                _, (h, c) = rq_unroll(net, mb["obs"][:, :B_in], h0, c0)
                _, (ht, ct) = rq_unroll(target, mb["obs"][:, :B_in],
                                        h0, c0)
            else:
                h, c, ht, ct = h0, c0, h0, c0
        # training segment needs T+1 obs for the bootstrap value
        seg = mb["obs"][:, B_in:B_in + T + 1]
        q, _ = rq_unroll(net, seg, h, c)               # [B, T+1, A]
        acts = mb["actions"][:, B_in:]
        q_sel = q[:, :T].gather(-1, acts[..., None])[..., 0]
        with torch.no_grad():
            qt, _ = rq_unroll(target, seg, ht, ct)
            a_star = q[:, 1:].argmax(-1)               # double-Q
            q_next = qt[:, 1:].gather(-1, a_star[..., None])[..., 0]
            rew = mb["rewards"][:, B_in:]
            done = mb["dones"][:, B_in:]
            tgt = rew + gamma * (1 - done) * q_next
        return torch.square(q_sel - tgt).mean(), {}

    return loss_fn


class R2D2Trainer(Algorithm):
    """ref: rllib/algorithms/r2d2/r2d2.py training_step — sample
    sequences, replay-train with burn-in, periodic target sync."""

    def _setup(self, cfg: R2D2Config):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, _, _ = probe_env_spec(cfg.env, cfg.env_config)
        assert n_actions is not None, "R2D2 needs a discrete action space"
        self.net = to_device(init_rqnet(
            torch.Generator().manual_seed(cfg.seed), obs_dim, n_actions,
            cfg.hidden), self.device)
        self.target = clone_tree(self.net)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.net)
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        seq_len = cfg.burn_in + cfg.train_len
        self.seq_len = seq_len
        self.workers = [
            _R2D2Worker.options(runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.hidden, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self.seqs_sampled = 0
        self._since_target_sync = 0
        self._update = make_q_update(
            make_r2d2_loss(cfg.burn_in, cfg.train_len, cfg.gamma), self.opt)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.timesteps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        net_host = to_host(self.net)
        eps = self._epsilon()
        refs = [w.sample.remote(net_host, cfg.seqs_per_worker,
                                self.seq_len, eps)
                for w in self.workers]
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            n = len(b["rewards"])
            self.seqs_sampled += n
            self._since_target_sync += n
            self.timesteps += n * self.seq_len

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
            loss = float(loss)

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "loss": loss,
            "num_updates": updates,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
        }

    def get_weights(self):
        return self.net

    def set_weights(self, weights):
        self.net = to_device(weights, self.device)
