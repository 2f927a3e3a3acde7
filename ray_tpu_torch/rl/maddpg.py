"""MADDPG: multi-agent DDPG with centralized critics.

Port of ``ray_tpu/rl/maddpg.py`` (reference: rllib/algorithms/maddpg/
(maddpg.py — "Multi-Agent Actor-Critic for Mixed Cooperative-Competitive
Environments", Lowe et al.: each agent has a decentralized deterministic
actor pi_i(o_i) and a CENTRALIZED critic Q_i(o_1..o_n, a_1..a_n) that
sees every agent's observation and action during training; execution
uses only the local actor)). ``LineSpreadEnv`` is the reference's 1-D
cooperative-spread env. Continuous multi-agent envs extend the
MultiAgentEnv protocol with `act_dims: Dict[str, int]` (actions in
[-1, 1]^d).

Sampling runs on CPU actors (the forward under
``torch.inference_mode()``); the nets, the targets and the 2n Adam states
live on the learner's device (CUDA unless ``MADDPGConfig.device`` is
"cpu"). The update goes agent by agent, in place: critic i steps first,
then actor i ascends the UPDATED critic i with the other agents' logged
actions; the targets are polyak-averaged toward every net at the end.
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
                                   polyak_, to_device, to_host,
                                   value_and_grad)
from ray_tpu_torch.rl.multi_agent import (MultiAgentEnv, make_multi_agent_env,
                                          register_multi_agent_env)


class LineSpreadEnv(MultiAgentEnv):
    """Cooperative spread on a line: two agents move on [-2, 2]; two
    fixed targets; team reward is -sum over targets of the distance to
    the closest agent (maximised by the agents splitting up, one per
    target — the credit-assignment structure MPE simple_spread tests)."""

    def __init__(self, episode_len: int = 25, seed: int = 0):
        self.possible_agents = ["a", "b"]
        # obs: [own_pos, other_pos, target0, target1]
        self.obs_dims = {aid: 4 for aid in self.possible_agents}
        self.n_actions = {}                  # continuous env
        self.act_dims = {aid: 1 for aid in self.possible_agents}
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def _obs(self):
        out = {}
        for i, aid in enumerate(self.possible_agents):
            other = self.pos[1 - i]
            out[aid] = np.asarray(
                [self.pos[i], other, self.targets[0], self.targets[1]],
                np.float32)
        return out

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self.pos = self._rng.uniform(-1, 1, 2)
        self.targets = self._rng.uniform(-1.5, 1.5, 2)
        return self._obs(), {}

    def step(self, action_dict):
        self._t += 1
        for i, aid in enumerate(self.possible_agents):
            v = float(np.clip(np.asarray(action_dict[aid]).reshape(-1)[0],
                              -1, 1))
            self.pos[i] = float(np.clip(self.pos[i] + 0.25 * v, -2, 2))
        cover = sum(min(abs(t - p) for p in self.pos)
                    for t in self.targets)
        rew = -float(cover)
        done = self._t >= self.episode_len
        half = rew / 2.0
        rews = {aid: half for aid in self.possible_agents}
        term = {aid: done for aid in self.possible_agents}
        term["__all__"] = done
        trunc = {aid: False for aid in self.possible_agents}
        trunc["__all__"] = False
        return self._obs(), rews, term, trunc, {}


register_multi_agent_env("line_spread", LineSpreadEnv)


# --- networks ----------------------------------------------------------------


def init_maddpg_nets(gen: torch.Generator, n_agents: int,
                     obs_dims: List[int], act_dims: List[int], hidden: int):
    joint = sum(obs_dims) + sum(act_dims)
    nets = {"actors": [], "critics": []}
    for i in range(n_agents):
        nets["actors"].append(mlp_init(
            gen, [obs_dims[i], hidden, hidden, act_dims[i]],
            out_scale=0.01))
        nets["critics"].append(mlp_init(gen, [joint, hidden, hidden, 1]))
    return nets


def actor_action(actor, obs):
    return torch.tanh(mlp_forward(actor, obs))


def critic_value(critic, joint_obs, joint_act):
    return mlp_forward(critic, torch.cat([joint_obs, joint_act], -1))[..., 0]


def _split(joint, dims):
    outs, off = [], 0
    for d in dims:
        outs.append(joint[:, off:off + d])
        off += d
    return outs


def make_maddpg_update(obs_dims: List[int], act_dims: List[int],
                       gamma: float, tau: float, actor_opt, critic_opt):
    """``update(nets, target, actor_os, critic_os, mb) -> (nets, target,
    actor_os, critic_os, critic_loss, actor_loss)`` (the losses averaged
    over the agents, on the device): for each agent i in turn, one Adam
    step of critic i on its TD error against the target critic at the
    target actors' joint next action, then one of actor i on -Q_i(o,
    (a_1.., pi_i(o_i), ..a_n)) under the critic just updated; then every
    target leaf moves by ``polyak_(tau)``. Everything in place."""
    n = len(obs_dims)

    def update(nets, target, actor_os, critic_os, mb):
        obs_i = _split(mb["obs"], obs_dims)
        act_i = _split(mb["actions"], act_dims)
        with torch.no_grad():
            nobs_i = _split(mb["next_obs"], obs_dims)
            # target joint next action from all target actors
            a_next = torch.cat([actor_action(target["actors"][i],
                                             nobs_i[i]) for i in range(n)],
                               -1)
        closs_sum = aloss_sum = 0.0
        for i in range(n):
            with torch.no_grad():
                tq = critic_value(target["critics"][i], mb["next_obs"],
                                  a_next)
                backup = mb["rewards"] + gamma * (1 - mb["dones"]) * tq

            def critic_loss(c):
                return torch.square(
                    critic_value(c, mb["obs"], mb["actions"])
                    - backup).mean(), {}

            (closs, _), cg = value_and_grad(critic_loss,
                                            nets["critics"][i])
            critic_opt.step(nets["critics"][i], cg, critic_os[i])
            critic_i = nets["critics"][i]       # updated in place

            def actor_loss(a):
                acts = [actor_action(a, obs_i[j]) if j == i else act_i[j]
                        for j in range(n)]
                return -critic_value(critic_i, mb["obs"],
                                     torch.cat(acts, -1)).mean(), {}

            (aloss, _), ag = value_and_grad(actor_loss, nets["actors"][i])
            actor_opt.step(nets["actors"][i], ag, actor_os[i])
            closs_sum = closs_sum + closs
            aloss_sum = aloss_sum + aloss
        polyak_(target, nets, tau)
        return (nets, target, actor_os, critic_os, closs_sum / n,
                aloss_sum / n)

    return update


# --- rollout worker ----------------------------------------------------------


@ray_tpu_torch.remote
class _MADDPGWorker:
    def __init__(self, env_name, env_config: dict, seed: int):
        self.env = make_multi_agent_env(env_name, env_config or {})
        self.agents = list(self.env.possible_agents)
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed: List[float] = []

    @torch.inference_mode()
    def sample(self, actors, num_steps: int, noise: float,
               random_actions: bool):
        """`actors`: the actors' CPU tensors."""
        cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                                "next_obs")}
        for _ in range(num_steps):
            acts, flat = {}, []
            for i, aid in enumerate(self.agents):
                d = self.env.act_dims[aid]
                if random_actions:
                    a = self.rng.uniform(-1, 1, d).astype(np.float32)
                else:
                    a = actor_action(actors[i], torch.as_tensor(
                        np.asarray(self.obs[aid], np.float32))[None])[0]
                    a = np.clip(a.numpy() + self.rng.normal(0, noise, d),
                                -1, 1).astype(np.float32)
                acts[aid] = a
                flat.append(a)
            so = np.concatenate([np.asarray(self.obs[a], np.float32)
                                 for a in self.agents])
            nobs, rew, term, trunc, _ = self.env.step(acts)
            done = term.get("__all__", False) or trunc.get("__all__", False)
            cols["obs"].append(so)
            cols["actions"].append(np.concatenate(flat))
            cols["rewards"].append(float(sum(rew.values())))
            cols["dones"].append(float(done))
            self.episode_return += float(sum(rew.values()))
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                nobs, _ = self.env.reset()
            self.obs = nobs
            cols["next_obs"].append(
                np.concatenate([np.asarray(nobs[a], np.float32)
                                for a in self.agents]))
        return {k: np.stack(v).astype(np.float32) for k, v in cols.items()}

    def episode_stats(self):
        return episode_stats_from(self.completed)

    def placement(self):
        return placement()


# --- trainer -----------------------------------------------------------------


@dataclass
class MADDPGConfig:
    env: Any = "line_spread"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 50
    replay_capacity: int = 50_000
    learning_starts: int = 300
    train_batch_size: int = 128
    updates_per_iter: int = 16
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.95
    tau: float = 0.01
    exploration_noise: float = 0.2
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class MADDPGTrainer(Algorithm):
    """ref: rllib/algorithms/maddpg/maddpg.py training_step — joint
    replay, per-agent centralized-critic TD + decentralized actor
    ascent, polyak targets."""

    def _setup(self, cfg: MADDPGConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        probe = make_multi_agent_env(cfg.env, cfg.env_config)
        self.agents = list(probe.possible_agents)
        self.obs_dims = [probe.obs_dims[a] for a in self.agents]
        self.act_dims = [probe.act_dims[a] for a in self.agents]
        self.nets = to_device(init_maddpg_nets(
            torch.Generator().manual_seed(cfg.seed), len(self.agents),
            self.obs_dims, self.act_dims, cfg.hidden), self.device)
        self.target = clone_tree(self.nets)
        self.opt = Adam(cfg.actor_lr)
        self.copt = Adam(cfg.critic_lr)
        self.actor_os = [self.opt.init(a) for a in self.nets["actors"]]
        self.critic_os = [self.copt.init(c) for c in self.nets["critics"]]
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _MADDPGWorker.options(num_cpus=0.5,
                                  runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.env_config, cfg.seed + i * 1000)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._update = make_maddpg_update(
            self.obs_dims, self.act_dims, cfg.gamma, cfg.tau, self.opt,
            self.copt)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        actors_host = to_host(self.nets["actors"])
        refs = [w.sample.remote(actors_host, cfg.rollout_fragment_length,
                                cfg.exploration_noise,
                                self.timesteps < cfg.learning_starts)
                for w in self.workers]
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            self.timesteps += len(b["rewards"])
        t1 = time.time()

        closs = aloss = float("nan")
        updates = 0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                mb = minibatch_to_device(
                    self.buffer.sample(cfg.train_batch_size), self.device)
                (self.nets, self.target, self.actor_os, self.critic_os,
                 closs, aloss) = self._update(
                    self.nets, self.target, self.actor_os,
                    self.critic_os, mb)
                updates += 1
            closs, aloss = float(closs), float(aloss)  # waits for the device
        t2 = time.time()

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "critic_loss": closs,
            "actor_loss": aloss,
            "num_updates": updates,
            "buffer_size": len(self.buffer),
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target = clone_tree(self.nets)
