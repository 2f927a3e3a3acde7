"""APEX-DQN: distributed prioritized replay with an async worker fleet.

Port of ``ray_tpu/rl/apex.py`` (reference: rllib/algorithms/apex_dqn/
(Horgan et al. 2018 — many actors with per-actor exploration epsilons feed
a sharded prioritized replay; the learner consumes batches asynchronously
and pushes updated priorities + weights back)). The replay shard is an
actor (core.ReplayActor pattern) on the CPU, its buffer the reference's
numpy one (the same indices for a seed); the Q-network and TD math are
shared with ray_tpu_torch.rl.dqn, the learner on the config's device. Each
update's |TD errors| come back to the host once, as numpy, for the shard.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   ReplayBuffer, clone_tree,
                                   minibatch_to_device, placement,
                                   probe_env_spec, rollout_result, to_device,
                                   to_host)
from ray_tpu_torch.rl.dqn import (_EpsilonWorker, init_qnet, make_q_update,
                                  td_error)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (ref:
    rllib/utils/replay_buffers/prioritized_replay_buffer.py): P(i) ~
    p_i^alpha, importance weights w_i = (N*P(i))^-beta / max w. Storage
    and wraparound come from the uniform core.ReplayBuffer; this layer
    adds only the priority bookkeeping."""

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        idx = (self._idx + np.arange(n)) % self.capacity
        super().add_batch(batch)
        self._prio[idx] = self._max_prio  # new samples get max priority

    def sample(self, batch_size: int, beta: float = 0.4):
        p = self._prio[:self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, batch_size, p=p)
        weights = (self._size * p[idx]) ** (-beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._storage.items()}
        out["_weights"] = weights.astype(np.float32)
        out["_indices"] = idx.astype(np.int64)
        return out

    def update_priorities(self, indices: np.ndarray, prios: np.ndarray):
        prios = np.abs(prios) + 1e-6
        self._prio[indices] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))


@ray_tpu_torch.remote
class PrioritizedReplayActor:
    """One replay shard (ref: apex ReplayActor fleet)."""

    def __init__(self, capacity: int, alpha: float, seed: int = 0):
        self.buf = PrioritizedReplayBuffer(capacity, alpha, seed)

    def add_batch(self, batch):
        self.buf.add_batch(batch)
        return len(self.buf)

    def sample(self, batch_size: int, beta: float):
        if len(self.buf) < batch_size:
            return None
        return self.buf.sample(batch_size, beta)

    def update_priorities(self, indices, prios):
        self.buf.update_priorities(np.asarray(indices), np.asarray(prios))
        return True

    def size(self):
        return len(self.buf)

    def placement(self) -> Dict[str, Any]:
        return placement()


@dataclass
class ApexDQNConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 3
    num_replay_shards: int = 1
    rollout_fragment_length: int = 50
    replay_capacity: int = 50_000
    learning_starts: int = 300
    train_batch_size: int = 64
    updates_per_iter: int = 16
    lr: float = 1e-3
    gamma: float = 0.99
    double_q: bool = True
    dueling: bool = True
    target_network_update_freq: int = 500
    # per-worker exploration: eps_i = base^(1 + 7*i/(N-1)) (ref: apex
    # paper eq. 1 via rllib per_worker_exploration)
    epsilon_base: float = 0.4
    prioritized_alpha: float = 0.6
    prioritized_beta: float = 0.4
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_apex_dqn_loss(gamma: float, double_q: bool):
    def loss_fn(net, target, mb):
        td = td_error(net, target, mb, gamma, double_q)
        # importance-weighted MSE; |td| goes back as new priorities
        return (mb["_weights"] * torch.square(td)).mean(), {"td": td.abs()}

    return loss_fn


class _ApexBase(Algorithm):
    """The fan-in shared by both Ape-X trainers: one in-flight sample per
    worker lands in a replay shard while the learner trains."""

    def _make_shards(self, cfg):
        return [PrioritizedReplayActor.options(
                    num_cpus=0.2, runtime_env=CPU_WORKER_ENV).remote(
                    cfg.replay_capacity // cfg.num_replay_shards,
                    cfg.prioritized_alpha, cfg.seed + s)
                for s in range(cfg.num_replay_shards)]

    def _shard(self, i: int):
        return self.shards[i % len(self.shards)]

    def _drain(self, host_params):
        """Launch every idle worker, then move the landed samples into
        their shards (non-blocking fan-in) and relaunch those workers
        (each after its steps are counted in ``timesteps``: ApexDDPG's
        warm-up flag reads it); returns the env steps that landed."""
        for i in range(len(self.workers)):
            if i not in self._inflight.values():
                self._launch(i, host_params)
        ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                      num_returns=len(self._inflight),
                                      timeout=0.2)
        adds = []
        landed = 0
        for ref in ready:
            i = self._inflight.pop(ref)
            b = ray_tpu_torch.get(ref)
            landed += len(b["rewards"])
            self.timesteps += len(b["rewards"])
            adds.append(self._shard(i).add_batch.remote(b))
            # the params are unchanged until the update loop; reuse the
            # host copy instead of a device read per landed sample
            self._launch(i, host_params)
        if adds:
            # a failed add would otherwise vanish with the dropped ref
            # and silently shrink the replay stream
            ray_tpu_torch.get(adds)
        return landed

    def _replay_updates(self, step):
        """updates_per_iter prioritized minibatches through ``step(mb) ->
        (loss, |td|)``, each update's |td| back to its shard as numpy,
        once the shards hold learning_starts rows; returns (the last loss
        as a float or NaN, updates made, the shards' sizes, whether
        training ran)."""
        cfg = self.config
        loss = float("nan")
        updates = 0
        sizes = ray_tpu_torch.get([s.size.remote() for s in self.shards])
        trained = sum(sizes) >= cfg.learning_starts
        if trained:
            prio_refs = []
            for u in range(cfg.updates_per_iter):
                shard = self.shards[u % len(self.shards)]
                mb = ray_tpu_torch.get(shard.sample.remote(
                    cfg.train_batch_size, cfg.prioritized_beta))
                if mb is None:
                    continue
                indices = mb.pop("_indices")
                loss, td = step(minibatch_to_device(mb, self.device))
                prio_refs.append(shard.update_priorities.remote(
                    indices, td.cpu().numpy()))
                updates += 1
                self.num_updates += 1
            if prio_refs:
                # surface failed priority writes (they'd skew sampling
                # toward stale TD errors with no visible symptom)
                ray_tpu_torch.get(prio_refs)
            loss = float(loss)
        return loss, updates, sizes, trained

    def stop(self):
        for a in self.workers + self.shards:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class ApexDQNTrainer(_ApexBase):
    """Async fan-in: one in-flight sample per worker lands in a replay
    shard while the learner trains; weights rebroadcast on relaunch
    (ref: apex_dqn.py training_step)."""

    def _setup(self, cfg: ApexDQNConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, _, _ = probe_env_spec(cfg.env, cfg.env_config)
        assert n_actions is not None, "APEX-DQN is discrete-action"
        self.net = to_device(init_qnet(
            torch.Generator().manual_seed(cfg.seed), obs_dim, n_actions,
            cfg.hidden, cfg.dueling), self.device)
        self.target = clone_tree(self.net)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.net)
        self.shards = self._make_shards(cfg)
        self.workers = [
            _EpsilonWorker.options(num_cpus=0.4,
                                   runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        n = max(1, cfg.num_rollout_workers - 1)
        self._eps = [cfg.epsilon_base ** (1 + 7 * i / n)
                     for i in range(cfg.num_rollout_workers)]
        self._inflight: Dict[Any, int] = {}   # sample ref -> worker index
        self.timesteps = 0
        self._since_target_sync = 0
        self.num_updates = 0
        self._update = make_q_update(
            make_apex_dqn_loss(cfg.gamma, cfg.double_q), self.opt)

    def _launch(self, i: int, net_host):
        ref = self.workers[i].sample.remote(
            net_host, self.config.rollout_fragment_length, self._eps[i])
        self._inflight[ref] = i

    def _step(self, mb):
        self.net, self.opt_state, loss, aux = self._update(
            self.net, self.target, self.opt_state, mb)
        return loss, aux["td"]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self._since_target_sync += self._drain(to_host(self.net))
        loss, updates, sizes, trained = self._replay_updates(self._step)
        if (trained and self._since_target_sync
                >= cfg.target_network_update_freq):
            self.target = clone_tree(self.net)
            self._since_target_sync = 0

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "num_updates": self.num_updates,
            "updates_this_iter": updates,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "replay_size": sum(sizes),
            "loss": loss,
        }

    def get_weights(self):
        return self.net

    def set_weights(self, weights):
        self.net = to_device(weights, self.device)
        self.target = clone_tree(self.net)


@dataclass
class ApexDDPGConfig:
    env: str = "Pendulum-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 3
    num_replay_shards: int = 1
    rollout_fragment_length: int = 50
    replay_capacity: int = 100_000
    learning_starts: int = 300
    train_batch_size: int = 128
    updates_per_iter: int = 16
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    # per-worker exploration-noise ladder (ref: apex_ddpg.py
    # per_worker_exploration — each worker explores at its own scale)
    noise_base: float = 0.2
    prioritized_alpha: float = 0.6
    prioritized_beta: float = 0.4
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class ApexDDPGTrainer(_ApexBase):
    """APEX-DDPG: the ApexDQN fan-in architecture with a DDPG learner
    (ref: rllib/algorithms/apex_ddpg/apex_ddpg.py — continuous-action
    APEX: prioritized distributed replay, per-worker exploration noise,
    deterministic actor + Q critic with polyak targets)."""

    def _setup(self, cfg: ApexDDPGConfig):
        from ray_tpu_torch.rl.ddpg import init_ddpg_nets, make_ddpg_update
        from ray_tpu_torch.rl.td3 import _TD3Worker

        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, _n, act_dim, act_high = probe_env_spec(
            cfg.env, cfg.env_config)
        assert act_dim is not None, "APEX-DDPG is continuous-action"
        self.act_high = act_high or 1.0
        self.nets = to_device(init_ddpg_nets(
            torch.Generator().manual_seed(cfg.seed), obs_dim, act_dim,
            cfg.hidden), self.device)
        self.target = clone_tree(self.nets)
        self.actor_opt = Adam(cfg.actor_lr)
        self.critic_opt = Adam(cfg.critic_lr)
        self.actor_os = self.actor_opt.init(self.nets["actor"])
        self.critic_os = self.critic_opt.init(self.nets["q"])
        self.shards = self._make_shards(cfg)
        self.workers = [
            _TD3Worker.options(num_cpus=0.4,
                               runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        n = max(1, cfg.num_rollout_workers - 1)
        self._noise = [cfg.noise_base ** (1 + 2 * i / n)
                       for i in range(cfg.num_rollout_workers)]
        self._inflight: Dict[Any, int] = {}
        self.timesteps = 0
        self.num_updates = 0
        self._update = make_ddpg_update(cfg, self.act_high, self.actor_opt,
                                        self.critic_opt, weighted=True)

    def _launch(self, i: int, actor_host):
        ref = self.workers[i].sample.remote(
            actor_host, self.config.rollout_fragment_length,
            self.timesteps < self.config.learning_starts, self._noise[i])
        self._inflight[ref] = i

    def _step(self, mb):
        (self.nets, self.target, self.actor_os, self.critic_os, closs,
         _aloss, td) = self._update(self.nets, self.target, self.actor_os,
                                    self.critic_os, mb)
        return closs, td

    def training_step(self) -> Dict[str, Any]:
        self._drain(to_host(self.nets["actor"]))
        loss, updates, sizes, _ = self._replay_updates(self._step)
        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        return {
            **rollout_result(self.timesteps, stats, {}),
            "num_updates": self.num_updates,
            "updates_this_iter": updates,
            "replay_size": sum(sizes),
            "critic_loss": loss,
        }

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target = clone_tree(self.nets)
