"""SAC: squashed-Gaussian actor, twin Q critics, auto-tuned temperature.

Port of ``ray_tpu/rl/sac.py`` (reference: rllib/algorithms/sac/ (twin_q,
target entropy = -|A|, tau polyak updates)). Continuous control; sampling
on CPU actors, the nets, the target critics, log-alpha and the three Adam
states on the learner's device (CUDA unless ``SACConfig.device`` is
"cpu").

The reference draws its Gaussian noise with ``jax.random`` keys built
from integers: the update's from ``PRNGKey(iteration * 10007 + u)`` split
in two (the next action's, the actor's), a worker's from
``PRNGKey(seed * 100003 + steps)``. Here ``sample_action`` takes the
standard normal draw ``eps`` as a tensor and the update takes both of its
draws; each is drawn from a ``torch.Generator`` seeded with the integer
the reference gives ``PRNGKey`` (``SACTrainer._noise``), so a test can
feed the reference's own draws instead.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   EnvSampler, ReplayBuffer, clone_tree,
                                   minibatch_to_device, mlp_forward,
                                   mlp_init, polyak_, probe_env_spec,
                                   standard_normal, to_device, to_host,
                                   value_and_grad)
from ray_tpu_torch.rl.ppo import read_aux

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def init_sac_nets(gen: torch.Generator, obs_dim: int, act_dim: int,
                  hidden: int):
    actor = {"torso": mlp_init(gen, [obs_dim, hidden, hidden]),
             "head": mlp_init(gen, [hidden, 2 * act_dim], out_scale=0.01)}
    q1 = mlp_init(gen, [obs_dim + act_dim, hidden, hidden, 1])
    q2 = mlp_init(gen, [obs_dim + act_dim, hidden, hidden, 1])
    return {"actor": actor, "q1": q1, "q2": q2}


def actor_dist(actor, obs):
    h = mlp_forward(actor["torso"], obs, final_activation=True)
    out = mlp_forward(actor["head"], h)
    mu, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std


def sample_action(actor, obs, eps, act_high: float):
    """tanh-squashed reparameterized sample + log-prob; `eps` is the
    standard normal draw, of mu's shape."""
    mu, log_std = actor_dist(actor, obs)
    std = torch.exp(log_std)
    pre = mu + std * eps
    a = torch.tanh(pre)
    # log prob with tanh correction (SAC appendix C)
    logp = (-0.5 * (eps ** 2 + 2 * log_std
                    + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a * act_high, logp


def q_value(q, obs, act):
    return mlp_forward(q, torch.cat([obs, act], -1))[..., 0]


@ray_tpu_torch.remote
class _SACWorker(EnvSampler):
    def __init__(self, env_name: str, seed: int,
                 env_config: Optional[dict] = None):
        super().__init__(env_name, seed, env_config)
        self.act_high = float(np.asarray(
            self.env.action_space.high).reshape(-1)[0])
        self.act_dim = int(np.prod(self.env.action_space.shape))

    @torch.inference_mode()
    def sample(self, actor, num_steps: int, random_actions: bool):
        """`actor`: the actor's CPU tensors."""
        def select(obs):
            if random_actions:
                return self.env.action_space.sample()
            eps = standard_normal(self.seed * 100003 + self.steps,
                                  (1, self.act_dim), "cpu")
            a, _ = sample_action(actor, torch.as_tensor(
                np.asarray(obs, np.float32))[None], eps, self.act_high)
            return a[0].numpy()

        return self.sample_transitions(select, num_steps)


@dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 1
    rollout_fragment_length: int = 100
    replay_capacity: int = 100_000
    learning_starts: int = 500
    train_batch_size: int = 128
    updates_per_iter: int = 32
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_sac_update(cfg: SACConfig, act_high: float, target_entropy: float,
                    actor_opt, critic_opt, alpha_opt):
    """``update(nets, target_q, log_alpha, actor_os, critic_os, alpha_os,
    mb, noise) -> (nets, target_q, log_alpha, ..., aux)`` with ``noise =
    {"eps_next", "eps_pi"}`` (standard normal, [B, act_dim] each: the next
    action's and the actor's): the twin critics' step, the actor's against
    the updated critics, the temperature's, then polyak of the target
    critics. Every leaf (log_alpha too, 0-d) updated in place."""
    def critic_loss(qs, nets, target_q, alpha, mb, eps_next):
        with torch.no_grad():
            a_next, logp_next = sample_action(nets["actor"], mb["next_obs"],
                                              eps_next, act_high)
            tq = torch.minimum(
                q_value(target_q["q1"], mb["next_obs"], a_next),
                q_value(target_q["q2"], mb["next_obs"], a_next))
            backup = mb["rewards"] + cfg.gamma * (1 - mb["dones"]) * (
                tq - alpha * logp_next)
        l1 = torch.square(q_value(qs["q1"], mb["obs"], mb["actions"])
                          - backup).mean()
        l2 = torch.square(q_value(qs["q2"], mb["obs"], mb["actions"])
                          - backup).mean()
        return l1 + l2, {}

    def actor_loss(actor, nets, alpha, mb, eps_pi):
        a, logp = sample_action(actor, mb["obs"], eps_pi, act_high)
        q = torch.minimum(q_value(nets["q1"], mb["obs"], a),
                          q_value(nets["q2"], mb["obs"], a))
        return (alpha * logp - q).mean(), {"logp": logp}

    def alpha_loss(la, logp):
        return -(torch.exp(la) * (logp + target_entropy)).mean(), {}

    def update(nets, target_q, log_alpha, actor_os, critic_os, alpha_os,
               mb, noise):
        alpha = torch.exp(log_alpha)

        # --- critics
        qs = {"q1": nets["q1"], "q2": nets["q2"]}
        (closs, _), cgrads = value_and_grad(
            critic_loss, qs, nets, target_q, alpha, mb, noise["eps_next"])
        critic_opt.step(qs, cgrads, critic_os)

        # --- actor
        (aloss, aaux), agrads = value_and_grad(
            actor_loss, nets["actor"], nets, alpha, mb, noise["eps_pi"])
        actor_opt.step(nets["actor"], agrads, actor_os)

        # --- temperature (the actor's logp without gradient)
        (_, _), lgrads = value_and_grad(alpha_loss, log_alpha, aaux["logp"])
        alpha_opt.step(log_alpha, lgrads, alpha_os)

        # --- polyak target update
        polyak_(target_q, qs, cfg.tau)
        aux = {"critic_loss": closs, "actor_loss": aloss,
               "alpha": torch.exp(log_alpha)}
        return (nets, target_q, log_alpha, actor_os, critic_os, alpha_os,
                aux)

    return update


class SACTrainer(Algorithm):
    """ref: rllib/algorithms/sac/sac.py training_step."""

    def _setup(self, cfg: SACConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_dim, n_actions, act_dim, act_high = probe_env_spec(
            cfg.env, cfg.env_config)
        assert act_dim is not None, "SAC needs a continuous action space"
        self.act_high = act_high or 1.0
        self.act_dim = act_dim
        self.nets = to_device(init_sac_nets(
            torch.Generator().manual_seed(cfg.seed), obs_dim, act_dim,
            cfg.hidden), self.device)
        self.target_q = clone_tree({"q1": self.nets["q1"],
                                    "q2": self.nets["q2"]})
        self.log_alpha = torch.zeros((), device=self.device)
        self.target_entropy = -float(act_dim)

        self.actor_opt = Adam(cfg.actor_lr)
        self.critic_opt = Adam(cfg.critic_lr)
        self.alpha_opt = Adam(cfg.alpha_lr)
        self.actor_os = self.actor_opt.init(self.nets["actor"])
        self.critic_os = self.critic_opt.init(
            {"q1": self.nets["q1"], "q2": self.nets["q2"]})
        self.alpha_os = self.alpha_opt.init(self.log_alpha)

        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _SACWorker.options(num_cpus=0.5,
                               runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, cfg.seed + i * 1000, cfg.env_config)
            for i in range(cfg.num_rollout_workers)]
        self.timesteps = 0
        self._update = make_sac_update(
            cfg, self.act_high, self.target_entropy, self.actor_opt,
            self.critic_opt, self.alpha_opt)

    def _noise(self, u: int, batch: int) -> Dict[str, torch.Tensor]:
        """Update u's draws (the reference's ``PRNGKey(iteration * 10007 +
        u)``): the next action's, then the actor's, one generator."""
        gen = torch.Generator().manual_seed(self.iteration * 10007 + u)
        shape = (batch, self.act_dim)
        eps_next = torch.randn(shape, generator=gen)
        eps_pi = torch.randn(shape, generator=gen)
        return {"eps_next": eps_next.to(self.device),
                "eps_pi": eps_pi.to(self.device)}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        actor_host = to_host(self.nets["actor"])
        warmup = self.timesteps < cfg.learning_starts
        refs = [w.sample.remote(actor_host, cfg.rollout_fragment_length,
                                warmup)
                for w in self.workers]
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
            self.timesteps += len(b["rewards"])
        t1 = time.time()

        aux = {}
        if len(self.buffer) >= cfg.learning_starts:
            for u in range(cfg.updates_per_iter):
                mb = minibatch_to_device(
                    self.buffer.sample(cfg.train_batch_size), self.device)
                (self.nets, self.target_q, self.log_alpha, self.actor_os,
                 self.critic_os, self.alpha_os, aux) = self._update(
                    self.nets, self.target_q, self.log_alpha, self.actor_os,
                    self.critic_os, self.alpha_os, mb,
                    self._noise(u, cfg.train_batch_size))
        aux = read_aux(aux)                 # waits for the device
        t2 = time.time()

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        eps_done = [s for s in stats if s["episodes"]]
        return {
            "timesteps_total": self.timesteps,
            "episode_return_mean": float(np.mean(
                [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "buffer_size": len(self.buffer),
            # rllib's timers: sampling (the fragments into the buffer) and
            # learning (the replay minibatches' copies and updates)
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
            **aux,
        }

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target_q = clone_tree({"q1": self.nets["q1"],
                                    "q2": self.nets["q2"]})
