"""Offline RL: behavior cloning (BC), conservative Q-learning (CQL) and
critic-regularized regression (CRR).

Port of ``ray_tpu/rl/offline.py`` (reference: rllib/algorithms/bc/
(supervised policy learning from a recorded dataset, the MARWIL base with
beta=0), rllib/algorithms/cql/ (SAC base + conservative regularizer
penalizing out-of-distribution actions; CQL(H) variant with logsumexp over
sampled actions) and rllib/algorithms/crr/). rllib reads offline data
through ray.data JSON readers (rllib/offline/); here the dataset is a dict
of arrays or a ``ray_tpu_torch.data.Dataset`` of transition rows. The data
stays on the host; each minibatch is copied to the learner's device (CUDA
unless the config's ``device`` is "cpu").

CQL's noise (the reference's ``jax.random`` draws from
``PRNGKey(iteration * 31337 + u)`` split five ways) enters its update as
tensors, drawn by ``CQLTrainer._noise`` from a ``torch.Generator`` seeded
with that integer; ``jax.vmap`` over the sampled actions becomes one
batched forward over ``[2 N · B, ...]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rl.core import (Adam, Algorithm, clone_tree,
                                   minibatch_to_device, mlp_forward,
                                   mlp_init, polyak_, standard_normal,
                                   to_device, value_and_grad)
from ray_tpu_torch.rl.dqn import make_q_update
from ray_tpu_torch.rl.ppo import read_aux
from ray_tpu_torch.rl.sac import (actor_dist, init_sac_nets, q_value,
                                  sample_action)


def _as_transition_arrays(dataset) -> Dict[str, np.ndarray]:
    """Accept {col: array} or a ray_tpu_torch.data.Dataset of row dicts
    (ref: rllib/offline/json_reader.py feeding SampleBatches)."""
    if isinstance(dataset, dict):
        return {k: np.asarray(v) for k, v in dataset.items()}
    from ray_tpu_torch.data.dataset import Dataset

    if isinstance(dataset, Dataset):
        import pandas as pd  # noqa: F401  (to_pandas uses it)

        df = dataset.to_pandas()
        return {c: np.stack(df[c].to_numpy()) for c in df.columns}
    raise TypeError(f"unsupported offline dataset type {type(dataset)}")


class _OfflineMixin:
    """Minibatch plumbing shared by the offline trainers."""

    def _init_data(self, dataset, batch_size: int, seed: int):
        self.data = _as_transition_arrays(dataset)
        self.n = len(next(iter(self.data.values())))
        self.batch_size = min(batch_size, self.n)
        self._rng = np.random.default_rng(seed)

    def _minibatch(self) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.n, self.batch_size)
        return {k: v[idx] for k, v in self.data.items()}

    def _device_minibatch(self) -> Dict[str, torch.Tensor]:
        return minibatch_to_device(self._minibatch(), self.device)


def _gather(logp_all, actions):
    return logp_all.gather(-1, actions.long()[:, None])[:, 0]


def gaussian_nll_terms(out, actions):
    """(-log-likelihood of `actions` per row without the 2π constant, mu)
    under the head's (mu, log_std) halves, log_std clipped to [-5, 2]."""
    mu, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, -5.0, 2.0)
    nll = (0.5 * torch.square((actions - mu) / torch.exp(log_std))
           + log_std).sum(-1)
    return nll, mu


@dataclass
class BCConfig:
    dataset: Any = None              # {"obs", "actions"} or data.Dataset
    discrete: bool = True
    obs_dim: int = 0                 # inferred from data when 0
    n_actions: int = 0               # discrete head size
    act_dim: int = 0                 # continuous head size
    lr: float = 1e-3
    train_batch_size: int = 256
    updates_per_iter: int = 32
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_bc_loss(discrete: bool):
    def loss_fn(params, mb):
        out = mlp_forward(params, mb["obs"])
        if discrete:
            nll = -_gather(F.log_softmax(out, -1), mb["actions"]).mean()
            acc = (out.argmax(-1) == mb["actions"]).float().mean()
            return nll, {"accuracy": acc}
        nll, mu = gaussian_nll_terms(out, mb["actions"])
        return nll.mean(), {"mse": torch.square(mu - mb["actions"]).mean()}

    return loss_fn


class BCTrainer(_OfflineMixin, Algorithm):
    """Behavior cloning (ref: rllib/algorithms/bc/bc.py — MARWIL beta=0):
    cross-entropy on discrete actions, Gaussian NLL on continuous."""

    def _setup(self, cfg: BCConfig):
        assert cfg.dataset is not None, "BC needs an offline dataset"
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self._init_data(cfg.dataset, cfg.train_batch_size, cfg.seed)
        obs_dim = cfg.obs_dim or int(self.data["obs"].shape[-1])
        if cfg.discrete:
            n_out = cfg.n_actions or int(self.data["actions"].max()) + 1
        else:
            n_out = 2 * (cfg.act_dim or int(self.data["actions"].shape[-1]))
        self.params = to_device(mlp_init(
            torch.Generator().manual_seed(cfg.seed),
            [obs_dim, cfg.hidden, cfg.hidden, n_out], out_scale=0.01),
            self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.workers = []
        self._loss = make_bc_loss(cfg.discrete)

    def _update(self, params, opt_state, mb):
        (loss, aux), grads = value_and_grad(self._loss, params, mb)
        self.opt.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss, **aux}

    def training_step(self) -> Dict[str, Any]:
        aux = {}
        for _ in range(self.config.updates_per_iter):
            self.params, self.opt_state, aux = self._update(
                self.params, self.opt_state, self._device_minibatch())
        return {"num_samples": self.n, **read_aux(aux)}

    @torch.inference_mode()
    def compute_action(self, obs):
        out = mlp_forward(self.params, torch.as_tensor(
            np.asarray(obs, np.float32), device=self.device)[None])[0]
        out = out.cpu().numpy()
        if self.config.discrete:
            return int(out.argmax())
        return out[:out.shape[-1] // 2]

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)


@dataclass
class CQLConfig:
    dataset: Any = None  # {"obs","actions","rewards","dones","next_obs"}
    act_high: float = 1.0
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    alpha: float = 0.2               # SAC entropy weight (fixed here)
    cql_weight: float = 1.0          # conservative penalty weight
    cql_n_actions: int = 4           # sampled actions for the logsumexp
    train_batch_size: int = 128
    updates_per_iter: int = 32
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def cql_penalty(q_params, obs, pol_a, q_data, rand_a):
    """logsumexp over (uniform + frozen-policy) actions minus the dataset
    Q — pushes down OOD action values (CQL eq. 4). `rand_a` [N, B, A] are
    the uniform actions, `pol_a` [N, B, A] the policy's, pre-sampled
    without gradient so that the penalty only shapes the critics, never
    the actor. The 2N action sets go through the critic as one batch."""
    cat = torch.cat([rand_a, pol_a], 0)                  # [2N, B, A]
    n2, B, A = cat.shape
    obs_all = obs.expand(n2, *obs.shape).reshape(n2 * B, -1)
    q_all = q_value(q_params, obs_all, cat.reshape(n2 * B, A)).reshape(n2, B)
    return (torch.logsumexp(q_all, 0) - q_data).mean()


def make_cql_update(cfg: CQLConfig, critic_opt, actor_opt):
    """``update(nets, target_q, critic_os, actor_os, mb, noise)`` with
    ``noise = {"eps_next" [B, A], "eps_pol" [N, B, A], "rand_a1",
    "rand_a2" [N, B, A] (uniform in [-act_high, act_high]), "eps_pi" [B,
    A]}``: sequenced like SAC's — the critics' step (actor frozen), then
    the actor's (critics frozen), then polyak of the target critics; a
    single joint loss would leak actor gradients into the critics and
    penalty gradients into the actor."""
    act_high = cfg.act_high

    def critic_loss(qs, nets, target_q, mb, pol_a, noise):
        with torch.no_grad():
            a_next, logp_next = sample_action(
                nets["actor"], mb["next_obs"], noise["eps_next"], act_high)
            tq = torch.minimum(
                q_value(target_q["q1"], mb["next_obs"], a_next),
                q_value(target_q["q2"], mb["next_obs"], a_next))
            backup = mb["rewards"] + cfg.gamma * (1 - mb["dones"]) * (
                tq - cfg.alpha * logp_next)
        q1_data = q_value(qs["q1"], mb["obs"], mb["actions"])
        q2_data = q_value(qs["q2"], mb["obs"], mb["actions"])
        bellman = (torch.square(q1_data - backup).mean()
                   + torch.square(q2_data - backup).mean())
        cons = (cql_penalty(qs["q1"], mb["obs"], pol_a, q1_data,
                            noise["rand_a1"])
                + cql_penalty(qs["q2"], mb["obs"], pol_a, q2_data,
                              noise["rand_a2"]))
        return bellman + cfg.cql_weight * cons, {"bellman": bellman,
                                                 "cons": cons}

    def actor_loss(actor, nets, mb, eps_pi):
        a_pi, logp_pi = sample_action(actor, mb["obs"], eps_pi, act_high)
        q_pi = torch.minimum(q_value(nets["q1"], mb["obs"], a_pi),
                             q_value(nets["q2"], mb["obs"], a_pi))
        return (cfg.alpha * logp_pi - q_pi).mean(), {}

    def update(nets, target_q, critic_os, actor_os, mb, noise):
        # frozen-policy actions for the penalty's logsumexp
        with torch.no_grad():
            obs_n = mb["obs"].expand(cfg.cql_n_actions, *mb["obs"].shape)
            pol_a, _ = sample_action(nets["actor"], obs_n, noise["eps_pol"],
                                     act_high)
        qs = {"q1": nets["q1"], "q2": nets["q2"]}
        (closs, caux), cgrads = value_and_grad(
            critic_loss, qs, nets, target_q, mb, pol_a, noise)
        critic_opt.step(qs, cgrads, critic_os)

        # SAC actor step against the (updated) conservative critics
        (aloss, _), agrads = value_and_grad(actor_loss, nets["actor"], nets,
                                            mb, noise["eps_pi"])
        actor_opt.step(nets["actor"], agrads, actor_os)
        polyak_(target_q, qs, cfg.tau)
        return nets, target_q, critic_os, actor_os, {
            "loss": closs + aloss, "bellman_loss": caux["bellman"],
            "cql_penalty": caux["cons"], "actor_loss": aloss}

    return update


class CQLTrainer(_OfflineMixin, Algorithm):
    """CQL(H) on the SAC machinery (ref: rllib/algorithms/cql/cql.py —
    SAC losses + min_q regularizer: logsumexp over random/policy actions
    minus the dataset action's Q)."""

    def _setup(self, cfg: CQLConfig):
        assert cfg.dataset is not None, "CQL needs an offline dataset"
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self._init_data(cfg.dataset, cfg.train_batch_size, cfg.seed)
        obs_dim = int(self.data["obs"].shape[-1])
        self.act_dim = int(self.data["actions"].shape[-1])
        self.nets = to_device(init_sac_nets(
            torch.Generator().manual_seed(cfg.seed), obs_dim, self.act_dim,
            cfg.hidden), self.device)
        self.target_q = clone_tree({"q1": self.nets["q1"],
                                    "q2": self.nets["q2"]})
        self.critic_opt = Adam(cfg.lr)
        self.actor_opt = Adam(cfg.lr)
        self.critic_os = self.critic_opt.init(
            {"q1": self.nets["q1"], "q2": self.nets["q2"]})
        self.actor_os = self.actor_opt.init(self.nets["actor"])
        self.workers = []
        self._update = make_cql_update(cfg, self.critic_opt, self.actor_opt)

    def _noise(self, u: int) -> Dict[str, torch.Tensor]:
        """Update u's draws (the reference's ``PRNGKey(iteration * 31337 +
        u)``), in the reference's key order, one generator."""
        cfg = self.config
        gen = torch.Generator().manual_seed(self.iteration * 31337 + u)
        B, A, N = self.batch_size, self.act_dim, cfg.cql_n_actions
        hi = cfg.act_high
        draws = {"eps_next": torch.randn((B, A), generator=gen),
                 "eps_pol": torch.randn((N, B, A), generator=gen),
                 "rand_a1": torch.rand((N, B, A), generator=gen)
                 * (2 * hi) - hi,
                 "rand_a2": torch.rand((N, B, A), generator=gen)
                 * (2 * hi) - hi,
                 "eps_pi": torch.randn((B, A), generator=gen)}
        return {k: v.to(self.device) for k, v in draws.items()}

    def training_step(self) -> Dict[str, Any]:
        aux = {}
        for u in range(self.config.updates_per_iter):
            (self.nets, self.target_q, self.critic_os, self.actor_os,
             aux) = self._update(self.nets, self.target_q, self.critic_os,
                                 self.actor_os, self._device_minibatch(),
                                 self._noise(u))
        return {"num_samples": self.n, **read_aux(aux)}

    @torch.inference_mode()
    def compute_action(self, obs, deterministic: bool = True):
        obs_t = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)[None]
        if deterministic:
            mu, _ = actor_dist(self.nets["actor"], obs_t)
            return (torch.tanh(mu)[0] * self.config.act_high).cpu().numpy()
        self._action_seed = getattr(self, "_action_seed", 0) + 1
        eps = standard_normal(self._action_seed, (1, self.act_dim),
                              self.device)
        a, _ = sample_action(self.nets["actor"], obs_t, eps,
                             self.config.act_high)
        return a[0].cpu().numpy()

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target_q = clone_tree({"q1": self.nets["q1"],
                                    "q2": self.nets["q2"]})


@dataclass
class CRRConfig:
    dataset: Any = None  # {"obs","actions","rewards","dones","next_obs"}
    n_actions: int = 0               # inferred from data when 0
    lr: float = 1e-3
    gamma: float = 0.99
    train_batch_size: int = 256
    updates_per_iter: int = 32
    target_update_freq: int = 8      # in updates
    # "binary" (indicator on positive advantage) or "exp" (exp(A/beta))
    weight_mode: str = "binary"
    beta: float = 1.0
    weight_clip: float = 20.0
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_crr_loss(cfg: CRRConfig):
    def loss_fn(nets, target_q, mb):
        acts = mb["actions"].long()[:, None]
        # critic: expected-SARSA backup under the current policy
        with torch.no_grad():
            pi_next = torch.softmax(
                mlp_forward(nets["actor"], mb["next_obs"]), -1)
            v_next = (pi_next * mlp_forward(target_q, mb["next_obs"])).sum(-1)
            backup = mb["rewards"] + cfg.gamma * (1 - mb["dones"]) * v_next
        q_all = mlp_forward(nets["q"], mb["obs"])
        q_sel = q_all.gather(-1, acts)[:, 0]
        critic_loss = torch.square(q_sel - backup).mean()
        # actor: advantage-filtered behavior cloning
        logits = mlp_forward(nets["actor"], mb["obs"])
        logp = F.log_softmax(logits, -1).gather(-1, acts)[:, 0]
        with torch.no_grad():
            pi = torch.softmax(logits, -1)
            v = (pi * q_all).sum(-1)
            adv = q_sel - v
            if cfg.weight_mode == "binary":
                w = (adv > 0).to(logp.dtype)
            else:
                w = torch.clamp(torch.exp(adv / cfg.beta),
                                max=cfg.weight_clip)
        actor_loss = -(w * logp).mean()
        total = actor_loss + critic_loss
        return total, {"actor_loss": actor_loss,
                       "critic_loss": critic_loss,
                       "mean_weight": w.mean(),
                       "mean_advantage": adv.mean()}

    return loss_fn


class CRRTrainer(_OfflineMixin, Algorithm):
    """CRR: critic-regularized regression (ref: rllib/algorithms/crr/ —
    offline actor-critic where the policy does filtered/weighted
    behavior cloning: only actions the critic scores above the policy's
    own expected value get cloned; the critic trains with expected-SARSA
    TD under the current policy)."""

    def _setup(self, cfg: CRRConfig):
        assert cfg.dataset is not None, "CRR needs an offline dataset"
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self._init_data(cfg.dataset, cfg.train_batch_size, cfg.seed)
        obs_dim = int(self.data["obs"].shape[-1])
        n_actions = cfg.n_actions or int(self.data["actions"].max()) + 1
        gen = torch.Generator().manual_seed(cfg.seed)
        self.nets = to_device({
            "actor": mlp_init(gen, [obs_dim, cfg.hidden, cfg.hidden,
                                    n_actions], out_scale=0.01),
            "q": mlp_init(gen, [obs_dim, cfg.hidden, cfg.hidden,
                                n_actions], out_scale=0.01),
        }, self.device)
        self.target_q = clone_tree(self.nets["q"])
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.nets)
        self.workers = []
        self._n_updates = 0
        self._update = make_q_update(make_crr_loss(cfg), self.opt)

    def training_step(self) -> Dict[str, Any]:
        aux = {}
        for _ in range(self.config.updates_per_iter):
            self.nets, self.opt_state, loss, aux = self._update(
                self.nets, self.target_q, self.opt_state,
                self._device_minibatch())
            aux = {"loss": loss, **aux}
            self._n_updates += 1
            if self._n_updates % self.config.target_update_freq == 0:
                self.target_q = clone_tree(self.nets["q"])
        return {"num_samples": self.n, **read_aux(aux)}

    @torch.inference_mode()
    def compute_action(self, obs):
        logits = mlp_forward(self.nets["actor"], torch.as_tensor(
            np.asarray(obs, np.float32), device=self.device)[None])[0]
        return int(logits.argmax())

    def get_weights(self):
        return self.nets

    def set_weights(self, weights):
        self.nets = to_device(weights, self.device)
        self.target_q = clone_tree(self.nets["q"])
