"""Multi-agent RL: dict-in/dict-out envs, per-policy training.

Port of ``ray_tpu/rl/multi_agent.py`` (reference: rllib/env/
multi_agent_env.py (MultiAgentEnv, "__all__" termination key), rllib
multi-agent config (policies dict + policy_mapping_fn +
policies_to_train, algorithm_config.py multi_agent()) and the per-policy
SampleBatch assembly in rllib/evaluation/episode_v2.py / sampler.py).

Rollouts are CPU actors stepping dict envs; each policy's update is the
same PPO step as the single-agent trainer, on the learner's device, run
once per policy per iteration (policies are independent param trees).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   episode_stats_from, to_device, to_host)
from ray_tpu_torch.rl.ppo import (categorical_sample, compute_gae,
                                  init_policy, make_ppo_update,
                                  policy_forward, read_aux, run_ppo_epochs)


class MultiAgentEnv:
    """Dict-keyed env interface (ref: rllib/env/multi_agent_env.py).

    reset() -> (obs_dict, info_dict)
    step(action_dict) -> (obs, rewards, terminateds, truncateds, infos),
    each a dict keyed by agent id; terminateds/truncateds carry the
    special "__all__" key ending the episode for everyone.
    """

    # Subclasses must set these in __init__ (annotations only here —
    # mutable class-level defaults would be shared across every env):
    possible_agents: List[str]
    obs_dims: Dict[str, int]      # {agent_id: flat obs dim}
    n_actions: Dict[str, int]     # {agent_id: discrete action count}

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, int]):
        raise NotImplementedError


class ContextMatchEnv(MultiAgentEnv):
    """Built-in cooperative test env: each agent observes a one-hot
    context and is rewarded for matching its index; agent "b" is
    additionally rewarded when both match (cooperative term). Episodes
    are fixed-length. Learnable by independent PPO in a few iterations
    (fills the role of rllib's TwoStepGame / RockPaperScissors examples)."""

    def __init__(self, n_context: int = 4, episode_len: int = 25,
                 seed: int = 0):
        self.possible_agents = ["a", "b"]
        self.n_context = n_context
        self.obs_dims = {aid: n_context for aid in self.possible_agents}
        self.n_actions = {aid: n_context for aid in self.possible_agents}
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._ctx = {}

    def _obs(self):
        out = {}
        for aid in self.possible_agents:
            c = int(self._rng.integers(self.n_context))
            self._ctx[aid] = c
            o = np.zeros(self.n_context, np.float32)
            o[c] = 1.0
            out[aid] = o
        return out

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        hit = {aid: float(action_dict[aid] == self._ctx[aid])
               for aid in self.possible_agents}
        rew = {"a": hit["a"], "b": hit["b"] + 0.5 * hit["a"] * hit["b"]}
        self._t += 1
        done = self._t >= self.episode_len
        obs = self._obs()
        term = {aid: done for aid in self.possible_agents}
        term["__all__"] = done
        trunc = {aid: False for aid in self.possible_agents}
        trunc["__all__"] = False
        return obs, rew, term, trunc, {}


_ENV_REGISTRY: Dict[str, Callable[..., MultiAgentEnv]] = {
    "context_match": ContextMatchEnv,
}


def register_multi_agent_env(name: str, ctor: Callable[..., MultiAgentEnv]):
    """ref: ray.tune.registry.register_env, as used by rllib."""
    _ENV_REGISTRY[name] = ctor


def make_multi_agent_env(name_or_ctor, env_config: dict) -> MultiAgentEnv:
    ctor = _ENV_REGISTRY.get(name_or_ctor, name_or_ctor)
    if not callable(ctor):
        raise ValueError(f"unknown multi-agent env {name_or_ctor!r}")
    return ctor(**env_config)


@ray_tpu_torch.remote
class MultiAgentRolloutWorker:
    """Steps a dict env, routing each agent through its mapped policy and
    collecting per-POLICY sample batches (ref: rllib episode_v2 per-policy
    batch assembly; policy_mapping_fn from the multi-agent config)."""

    def __init__(self, env_name, env_config: dict,
                 policy_mapping: Dict[str, str], seed: int = 0):
        self.env = make_multi_agent_env(env_name, env_config)
        self.mapping = policy_mapping
        self.seed = seed
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed: List[float] = []

    @torch.inference_mode()
    def sample(self, policies_host: Dict[str, Any], num_steps: int):
        """Returns {policy_id: [per-AGENT batch, ...]} covering num_steps
        env steps. Batches stay per-agent so each is a single temporally
        ordered trajectory — GAE is only valid on one agent's stream;
        interleaving agents that share a policy would bootstrap one
        agent's values from another's (ref: rllib builds per-(episode,
        agent) SampleBatches in episode_v2.py before policy-level concat).
        `policies_host`: each policy's CPU tensors; the forward runs on the
        CPU."""
        rng = np.random.default_rng(self.seed + len(self.completed))
        # per-AGENT trajectory columns
        cols: Dict[str, Dict[str, list]] = {
            aid: {k: [] for k in
                  ("obs", "actions", "rewards", "dones", "logp", "values")}
            for aid in self.mapping}
        for _ in range(num_steps):
            actions, step_logp, step_val = {}, {}, {}
            for aid, ob in self.obs.items():
                pid = self.mapping[aid]
                logits, value = policy_forward(
                    policies_host[pid],
                    torch.as_tensor(np.asarray(ob, np.float32))[None])
                a, logp = categorical_sample(logits[0].numpy(), rng)
                actions[aid] = a
                step_logp[aid] = logp
                step_val[aid] = float(value[0])
            nobs, rew, term, trunc, _ = self.env.step(actions)
            done = term.get("__all__", False) or trunc.get("__all__", False)
            for aid, ob in self.obs.items():
                c = cols[aid]
                c["obs"].append(np.asarray(ob, np.float32))
                c["actions"].append(actions[aid])
                c["rewards"].append(float(rew.get(aid, 0.0)))
                # per-AGENT termination: an individually-finished agent's
                # trajectory must close here or GAE would bootstrap its
                # terminal step from its NEXT episode's first value
                c["dones"].append(done or term.get(aid, False)
                                  or trunc.get(aid, False))
                c["logp"].append(step_logp[aid])
                c["values"].append(step_val[aid])
            self.episode_return += float(sum(rew.values()))
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                nobs, _ = self.env.reset()
            self.obs = nobs

        out: Dict[str, list] = {}
        for aid, c in cols.items():
            if not c["obs"]:
                continue
            pid = self.mapping[aid]
            # bootstrap from THIS agent's current value estimate
            if aid in self.obs:
                _, v = policy_forward(
                    policies_host[pid],
                    torch.as_tensor(np.asarray(self.obs[aid],
                                               np.float32))[None])
                last_value = float(v[0])
            else:
                last_value = 0.0
            out.setdefault(pid, []).append({
                "obs": np.stack(c["obs"]),
                "actions": np.asarray(c["actions"], np.int32),
                "rewards": np.asarray(c["rewards"], np.float32),
                "dones": np.asarray(c["dones"], np.bool_),
                "logp": np.asarray(c["logp"], np.float32),
                "values": np.asarray(c["values"], np.float32),
                "last_value": last_value,
            })
        return out

    def episode_stats(self):
        return episode_stats_from(self.completed)


@dataclass
class MultiAgentPPOConfig:
    env: Any = "context_match"
    env_config: Dict[str, Any] = field(default_factory=dict)
    # {policy_id: (obs_dim, n_actions)} — inferred from env when None
    policies: Optional[Dict[str, Any]] = None
    # agent_id -> policy_id; default: one policy per agent, same name
    policy_mapping: Optional[Dict[str, str]] = None
    policies_to_train: Optional[List[str]] = None
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 100
    num_epochs: int = 4
    minibatch_size: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class MultiAgentPPOTrainer(Algorithm):
    """Independent PPO over a policy map (ref: rllib multi-agent training:
    algorithm.py training_step iterates policies_to_train; one shared
    jitted update because all policies share net shapes per (obs, act))."""

    def _setup(self, cfg: MultiAgentPPOConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        probe = make_multi_agent_env(cfg.env, cfg.env_config)
        mapping = cfg.policy_mapping or {a: a for a in probe.possible_agents}
        self.mapping = mapping
        specs = cfg.policies or {
            mapping[a]: (probe.obs_dims[a], probe.n_actions[a])
            for a in probe.possible_agents}
        self.train_ids = cfg.policies_to_train or sorted(specs)

        # one generator, drawn policy by policy in sorted order (the
        # reference folds the policy's index into its key)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.policies: Dict[str, Any] = {}
        self.opt = Adam(cfg.lr)
        # built from each policy's params at its first update
        self.opt_states: Dict[str, Any] = {}
        for pid, (od, na) in sorted(specs.items()):
            self.policies[pid] = to_device(
                init_policy(gen, od, na, cfg.hidden), self.device)
            self.opt_states[pid] = None

        self.workers = [
            MultiAgentRolloutWorker.options(
                num_cpus=0.5, runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.env_config, mapping, seed=cfg.seed + i * 1000)
            for i in range(cfg.num_rollout_workers)]
        self._update = self._make_update()
        self.timesteps = 0

    def _make_update(self):
        # same clipped-surrogate update as single-agent PPO, shared by
        # every policy
        return make_ppo_update(self.config, self.opt)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        host = {pid: to_host(p) for pid, p in self.policies.items()}
        refs = [w.sample.remote(host, cfg.rollout_fragment_length)
                for w in self.workers]
        per_policy: Dict[str, List[dict]] = {}
        for worker_out in ray_tpu_torch.get(refs):
            for pid, agent_batches in worker_out.items():
                per_policy.setdefault(pid, []).extend(agent_batches)

        # env steps, not per-agent rows (matches PPOTrainer semantics)
        self.timesteps += (cfg.rollout_fragment_length
                           * cfg.num_rollout_workers)
        agent_steps = 0
        aux_by_pid = {}
        for pid in self.train_ids:
            batches = per_policy.get(pid, [])
            if not batches:
                continue
            obs, acts, logps, advs, rets = [], [], [], [], []
            for b in batches:
                adv, ret = compute_gae(b, cfg.gamma, cfg.lam)
                obs.append(b["obs"]); acts.append(b["actions"])
                logps.append(b["logp"]); advs.append(adv); rets.append(ret)
            obs = np.concatenate(obs)
            agent_steps += len(obs)
            (self.policies[pid], self.opt_states[pid],
             aux) = run_ppo_epochs(
                self._update, self.policies[pid], self.opt_states[pid],
                obs=obs, actions=np.concatenate(acts),
                logp=np.concatenate(logps), adv=np.concatenate(advs),
                returns=np.concatenate(rets),
                num_epochs=cfg.num_epochs,
                minibatch_size=cfg.minibatch_size, seed=self.iteration)
            aux_by_pid[pid] = read_aux(aux)

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "agent_steps_this_iter": agent_steps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in done])) if done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "policies": aux_by_pid,
        }

    def get_weights(self):
        return self.policies

    def set_weights(self, weights):
        self.policies = {pid: to_device(p, self.device)
                         for pid, p in weights.items()}

    @torch.inference_mode()
    def compute_actions(self, obs_dict: Dict[str, np.ndarray]):
        """Greedy per-agent actions (inference path, on the learner's
        device)."""
        out = {}
        for aid, ob in obs_dict.items():
            obs = torch.as_tensor(np.asarray(ob, np.float32))[None]
            logits, _ = policy_forward(self.policies[self.mapping[aid]],
                                       obs.to(self.device))
            out[aid] = int(logits[0].argmax())
        return out
