"""QMIX: monotonic value-function factorisation for cooperative MARL.

Port of ``ray_tpu/rl/qmix.py`` (reference: rllib/algorithms/qmix/
(qmix.py, qmix_policy.py — per-agent utility networks + a mixing network
whose non-negative weights are emitted by state-conditioned
hypernetworks, trained end-to-end with TD on the mixed Q_tot; Rashid et
al. 2018) and rllib's TwoStepGame example (rllib/examples/
two_step_game.py), the built-in cooperative env). As in the reference,
the agent networks are feed-forward (rllib defaults to RNN agents) and
the global state for mixing is the concatenation of all agent
observations.

Sampling runs on CPU actors (the forward under
``torch.inference_mode()``); the nets, their target and the Adam state
live on the learner's device (CUDA unless ``QMIXConfig.device`` is
"cpu"). The update steps the nets in place, so the target is a copy
(``clone_tree``) taken at each sync, never an alias.
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
from ray_tpu_torch.rl.multi_agent import (MultiAgentEnv, make_multi_agent_env,
                                          register_multi_agent_env)


class TwoStepGame(MultiAgentEnv):
    """The QMIX paper's coordination test (ref:
    rllib/examples/two_step_game.py): agent a's first action selects
    matrix game 2A (payoff 7 regardless) or 2B (payoff 8 only if both
    agents then pick action 1, else 0/1). Greedy independent learners
    settle for 7; a correctly mixed joint value discovers 8."""

    def __init__(self, seed: int = 0):
        self.possible_agents = ["a", "b"]
        self.obs_dims = {aid: 3 for aid in self.possible_agents}
        self.n_actions = {aid: 2 for aid in self.possible_agents}
        self._stage = 0

    def _obs(self):
        o = np.zeros(3, np.float32)
        o[self._stage] = 1.0
        return {aid: o.copy() for aid in self.possible_agents}

    def reset(self, seed: Optional[int] = None):
        self._stage = 0
        return self._obs(), {}

    def step(self, action_dict):
        done = False
        rew = 0.0
        if self._stage == 0:
            # agent a picks the matrix: 0 -> game 2A, 1 -> game 2B
            self._stage = 1 if action_dict["a"] == 0 else 2
        else:
            done = True
            if self._stage == 1:
                rew = 7.0
            else:
                both = action_dict["a"] == 1 and action_dict["b"] == 1
                none = action_dict["a"] == 0 and action_dict["b"] == 0
                rew = 8.0 if both else (1.0 if none else 0.0)
        obs = self._obs()
        half = rew / 2.0   # team reward split evenly (rllib example)
        rews = {aid: half for aid in self.possible_agents}
        term = {aid: done for aid in self.possible_agents}
        term["__all__"] = done
        trunc = {aid: False for aid in self.possible_agents}
        trunc["__all__"] = False
        return obs, rews, term, trunc, {}


register_multi_agent_env("two_step_game", TwoStepGame)


# --- networks ----------------------------------------------------------------


def init_qmix_nets(gen: torch.Generator, n_agents: int, obs_dim: int,
                   n_actions: int, state_dim: int, hidden: int, embed: int):
    return {
        # one utility net shared across agents (parameter sharing, the
        # rllib default); agents are distinguished by their observations
        "agent": mlp_init(gen, [obs_dim, hidden, n_actions],
                          out_scale=0.01),
        "hyper_w1": mlp_init(gen, [state_dim, hidden, n_agents * embed]),
        "hyper_b1": mlp_init(gen, [state_dim, embed]),
        "hyper_w2": mlp_init(gen, [state_dim, hidden, embed]),
        "hyper_b2": mlp_init(gen, [state_dim, hidden, 1]),
    }


def agent_qs(nets, obs):
    """Per-agent utilities; obs [B, n_agents, obs_dim] -> [B, n_agents, A]."""
    return mlp_forward(nets["agent"], obs)


def mix(nets, qs, state):
    """Monotonic mixer: Q_tot from per-agent chosen Qs [B, n_agents] and
    global state [B, S]. Non-negativity of the mixing weights (abs on the
    hypernet outputs) is what guarantees dQ_tot/dq_i >= 0."""
    B, n = qs.shape
    w1 = torch.abs(mlp_forward(nets["hyper_w1"], state)).reshape(B, n, -1)
    b1 = mlp_forward(nets["hyper_b1"], state)
    hidden = torch.einsum("bn,bne->be", qs, w1) + b1
    hidden = torch.where(hidden > 0, hidden, torch.expm1(hidden))  # ELU
    w2 = torch.abs(mlp_forward(nets["hyper_w2"], state))
    b2 = mlp_forward(nets["hyper_b2"], state)[:, 0]
    return (hidden * w2).sum(-1) + b2


def make_qmix_loss(gamma: float, double_q: bool):
    """``loss_fn(nets, target, mb) -> (loss, {})``: the squared TD error of
    the mixed Q_tot against r + gamma * the target mixer's Q_tot at s'
    (double-Q: the online agents' argmax there, the first maximum as
    ``jnp.argmax``), the target without gradient."""
    def loss_fn(nets, target, mb):
        q = agent_qs(nets, mb["obs"])                        # [B, n, A]
        q_sel = q.gather(-1, mb["actions"][..., None])[..., 0]  # [B, n]
        q_tot = mix(nets, q_sel, mb["state"])
        with torch.no_grad():
            qt_next = agent_qs(target, mb["next_obs"])
            if double_q:
                a_star = agent_qs(nets, mb["next_obs"]).argmax(-1)
            else:
                a_star = qt_next.argmax(-1)
            qn_sel = qt_next.gather(-1, a_star[..., None])[..., 0]
            q_tot_next = mix(target, qn_sel, mb["next_state"])
            tgt = mb["rewards"] + gamma * (1 - mb["dones"]) * q_tot_next
        return torch.square(q_tot - tgt).mean(), {}

    return loss_fn


# --- rollout worker ----------------------------------------------------------


@ray_tpu_torch.remote
class _QMIXWorker:
    """Epsilon-greedy sampler over a dict env, emitting joint transitions
    {obs [T,n,O], state [T,S], actions [T,n], reward, done, next_*}."""

    def __init__(self, env_name, env_config: dict, seed: int):
        self.env = make_multi_agent_env(env_name, env_config or {})
        self.agents = list(self.env.possible_agents)
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed: List[float] = []

    def _stack(self, obs_dict):
        return np.stack([np.asarray(obs_dict[a], np.float32)
                         for a in self.agents])

    @torch.inference_mode()
    def sample(self, nets, num_steps: int, epsilon: float):
        """`nets`: the nets' CPU tensors."""
        cols = {k: [] for k in ("obs", "state", "actions", "rewards",
                                "dones", "next_obs", "next_state")}
        for _ in range(num_steps):
            so = self._stack(self.obs)                    # [n, O]
            q = agent_qs(nets, torch.as_tensor(so)[None])[0].numpy()
            acts = {}
            for i, aid in enumerate(self.agents):
                if self.rng.random() < epsilon:
                    acts[aid] = int(self.rng.integers(
                        self.env.n_actions[aid]))
                else:
                    acts[aid] = int(q[i].argmax())
            nobs, rew, term, trunc, _ = self.env.step(acts)
            done = term.get("__all__", False) or trunc.get("__all__", False)
            sn = self._stack(nobs)
            cols["obs"].append(so)
            cols["state"].append(so.reshape(-1))
            cols["actions"].append(
                np.asarray([acts[a] for a in self.agents], np.int32))
            cols["rewards"].append(float(sum(rew.values())))
            cols["dones"].append(float(done))
            cols["next_obs"].append(sn)
            cols["next_state"].append(sn.reshape(-1))
            self.episode_return += float(sum(rew.values()))
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                nobs, _ = self.env.reset()
            self.obs = nobs
        return {k: np.stack(v).astype(np.float32)
                if k not in ("actions", "obs", "next_obs")
                else np.stack(v) for k, v in cols.items()}

    def episode_stats(self):
        return episode_stats_from(self.completed)

    def placement(self):
        return placement()


# --- trainer -----------------------------------------------------------------


@dataclass
class QMIXConfig:
    env: Any = "two_step_game"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 32
    replay_capacity: int = 5_000
    learning_starts: int = 64
    train_batch_size: int = 32
    updates_per_iter: int = 16
    lr: float = 5e-3
    gamma: float = 0.99
    double_q: bool = True
    target_network_update_freq: int = 200  # in sampled env steps
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 3_000
    hidden: int = 32
    mixing_embed: int = 16
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class QMIXTrainer(Algorithm):
    """ref: rllib/algorithms/qmix/qmix.py training_step — sample joint
    transitions, TD-train the factored Q_tot, periodic target sync."""

    def _setup(self, cfg: QMIXConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        probe = make_multi_agent_env(cfg.env, cfg.env_config)
        self.agents = list(probe.possible_agents)
        n = len(self.agents)
        obs_dim = probe.obs_dims[self.agents[0]]
        n_actions = probe.n_actions[self.agents[0]]
        assert all(probe.obs_dims[a] == obs_dim and
                   probe.n_actions[a] == n_actions for a in self.agents), \
            "QMIX parameter sharing needs homogeneous agent spaces"
        self.nets = to_device(init_qmix_nets(
            torch.Generator().manual_seed(cfg.seed), n, obs_dim, n_actions,
            n * obs_dim, cfg.hidden, cfg.mixing_embed), self.device)
        self.target = clone_tree(self.nets)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.nets)
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _QMIXWorker.options(num_cpus=0.5,
                                runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.env_config, cfg.seed + i * 1000)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._since_target_sync = 0
        self._update = make_q_update(
            make_qmix_loss(cfg.gamma, cfg.double_q), self.opt)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.timesteps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        nets_host = to_host(self.nets)
        eps = self._epsilon()
        refs = [w.sample.remote(nets_host, cfg.rollout_fragment_length,
                                eps)
                for w in self.workers]
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            n = len(b["rewards"])
            self.timesteps += n
            self._since_target_sync += n
        t1 = time.time()

        loss = float("nan")
        updates = 0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                mb = minibatch_to_device(
                    self.buffer.sample(cfg.train_batch_size), self.device)
                self.nets, self.opt_state, loss, _ = self._update(
                    self.nets, self.target, self.opt_state, mb)
                updates += 1
            if self._since_target_sync >= cfg.target_network_update_freq:
                self.target = clone_tree(self.nets)
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
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target = clone_tree(self.nets)
