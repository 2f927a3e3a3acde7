"""DQN: double Q-learning, dueling heads, target network, replay.

Port of ``ray_tpu/rl/dqn.py`` (reference: rllib/algorithms/dqn/ (config
defaults: double_q, dueling, target_network_update_freq, epsilon
schedule)). Sampling runs on a CPU actor fleet (the forward on the CPU,
under ``torch.inference_mode()``); the Q-net, its target and the Adam
state live on the learner's device (CUDA unless ``DQNConfig.device`` is
"cpu"). Each replay minibatch is copied to the device once; the loss is
read back once, after the iteration's last update.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   EnvSampler, ReplayBuffer, clone_tree,
                                   minibatch_to_device, mlp_forward,
                                   mlp_init, probe_env_spec, to_device,
                                   to_host, value_and_grad)


def init_qnet(gen: torch.Generator, obs_dim: int, n_actions: int,
              hidden: int, dueling: bool):
    net = {"torso": mlp_init(gen, [obs_dim, hidden, hidden])}
    if dueling:
        net["adv"] = mlp_init(gen, [hidden, n_actions], out_scale=0.01)
        net["val"] = mlp_init(gen, [hidden, 1], out_scale=0.01)
    else:
        net["q"] = mlp_init(gen, [hidden, n_actions], out_scale=0.01)
    return net


def q_forward(net, obs):
    h = mlp_forward(net["torso"], obs, final_activation=True)
    if "q" in net:
        return mlp_forward(net["q"], h)
    adv = mlp_forward(net["adv"], h)
    val = mlp_forward(net["val"], h)
    return val + adv - adv.mean(-1, keepdim=True)


def td_error(net, target, mb, gamma: float, double_q: bool):
    """Q(s, a) minus its TD target, the target without gradient. Double-Q
    takes the online net's argmax at s' (the first maximum, as
    ``jnp.argmax``) and the target net's value there."""
    q = q_forward(net, mb["obs"])
    q_sel = q.gather(-1, mb["actions"][:, None])[:, 0]
    with torch.no_grad():
        q_next_t = q_forward(target, mb["next_obs"])
        if double_q:
            a_star = q_forward(net, mb["next_obs"]).argmax(-1)
            q_next = q_next_t.gather(-1, a_star[:, None])[:, 0]
        else:
            q_next = q_next_t.max(-1).values
        target_q = mb["rewards"] + gamma * (1 - mb["dones"]) * q_next
    return q_sel - target_q


def make_dqn_loss(gamma: float, double_q: bool):
    def loss_fn(net, target, mb):
        td = td_error(net, target, mb, gamma, double_q)
        # rllib's default is huber; MSE, as the reference
        return torch.square(td).mean(), {}

    return loss_fn


def make_q_update(loss_fn, opt):
    """``update(net, target, opt_state, mb) -> (net, opt_state, loss,
    aux)``: one Adam step on ``loss_fn(net, target, mb)``, the net's leaves
    updated in place, the loss and aux still on the device."""
    def update(net, target, opt_state, mb):
        if opt_state is None:
            opt_state = opt.init(net)
        (loss, aux), grads = value_and_grad(loss_fn, net, target, mb)
        opt.step(net, grads, opt_state)
        return net, opt_state, loss, aux

    return update


@ray_tpu_torch.remote
class _EpsilonWorker(EnvSampler):
    """Epsilon-greedy sampler (ref: rllib EpsilonGreedy exploration)."""

    def __init__(self, env_name: str, seed: int,
                 env_config: Optional[dict] = None):
        super().__init__(env_name, seed, env_config)
        self.rng = np.random.default_rng(seed)

    @torch.inference_mode()
    def sample(self, net, num_steps: int, epsilon: float):
        """`net`: the Q-net's CPU tensors."""
        obs_b, act_b, rew_b, done_b, nobs_b = [], [], [], [], []
        for _ in range(num_steps):
            if self.rng.random() < epsilon:
                action = int(self.env.action_space.sample())
            else:
                q = q_forward(net, torch.as_tensor(
                    np.asarray(self.obs, np.float32))[None])[0]
                action = int(q.argmax())
            prev, rew, term, _trunc, nobs = self.step_env(action)
            obs_b.append(np.asarray(prev, np.float32))
            act_b.append(action)
            rew_b.append(rew)
            done_b.append(term)
            nobs_b.append(np.asarray(nobs, np.float32))
        return {"obs": np.stack(obs_b),
                "actions": np.asarray(act_b, np.int32),
                "rewards": np.asarray(rew_b, np.float32),
                "dones": np.asarray(done_b, np.float32),
                "next_obs": np.stack(nobs_b)}


@dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 50
    replay_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iter: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    double_q: bool = True
    dueling: bool = True
    target_network_update_freq: int = 500   # in sampled env steps
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 10_000
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class DQNTrainer(Algorithm):
    """ref: rllib/algorithms/dqn/dqn.py training_step — sample, store,
    replay-train, periodically sync target."""

    def _setup(self, cfg: DQNConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, _, _ = probe_env_spec(cfg.env, cfg.env_config)
        assert n_actions is not None, "DQN needs a discrete action space"
        self.net = to_device(init_qnet(
            torch.Generator().manual_seed(cfg.seed), obs_dim, n_actions,
            cfg.hidden, cfg.dueling), self.device)
        self.target = clone_tree(self.net)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.net)
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _EpsilonWorker.options(num_cpus=0.5,
                                   runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._since_target_sync = 0
        self._update = make_q_update(
            make_dqn_loss(cfg.gamma, cfg.double_q), self.opt)

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
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            self.timesteps += len(b["rewards"])
            self._since_target_sync += len(b["rewards"])
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
            "loss": loss,
            "num_updates": updates,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            # rllib's timers: sampling (the fragments into the buffer) and
            # learning (the replay minibatches' copies and updates)
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def get_weights(self):
        return self.net

    def set_weights(self, weights):
        self.net = to_device(weights, self.device)
        self.target = clone_tree(self.net)
