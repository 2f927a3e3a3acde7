"""IMPALA: async rollout fan-in with V-trace off-policy correction.

Port of ``ray_tpu/rl/impala.py`` (reference: rllib/algorithms/impala/
(async sample queue, V-trace from Espeholt et al. 2018 — rho/c truncated
importance weights)). Workers sample with stale weights while the learner
updates on its device; ray_tpu_torch.wait() drives the async fan-in
instead of rllib's AsyncRequestsManager.

V-trace's backward recursion (the reference's ``lax.scan`` over reversed
time) is a reverse loop over the fragment here, the same f32 operations
in the same order (acc = delta_t + discount_t * c_t * acc): the targets
agree with the reference's to f32 rounding. A cumulative-product form
would divide by products that reach 0 at episode ends.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   make_update, to_device, to_host)
from ray_tpu_torch.rl.ppo import (RolloutWorker, batch_to_device, entropy,
                                  log_softmax_taken, policy_forward,
                                  read_aux)


@dataclass
class ImpalaConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 100
    batches_per_iter: int = 4
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    # connector factories + network choice, same semantics as PPOConfig
    # (pixel IMPALA: atari_connectors() + the auto-selected NatureCNN)
    obs_connectors: Any = None
    network: str = "auto"
    cnn_hidden: int = 512
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


@torch.no_grad()
def vtrace(values, rewards, dones, rhos, last_value, *, gamma: float,
           rho_clip: float, c_clip: float):
    """Truncated importance-sampled value targets (V-trace): (vs, pg_adv)
    for one fragment, [T] tensors (dones as float), no gradient."""
    rho = torch.clamp(rhos, max=rho_clip)
    c = torch.clamp(rhos, max=c_clip)
    discounts = gamma * (1.0 - dones)
    last = last_value.reshape(1)
    next_values = torch.cat([values[1:], last])
    deltas = rho * (rewards + discounts * next_values - values)
    vs_minus_v = torch.empty_like(values)
    acc = torch.zeros((), dtype=values.dtype, device=values.device)
    dc = discounts * c
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + dc[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    next_vs = torch.cat([vs[1:], last])
    pg_adv = rho * (rewards + discounts * next_vs - values)
    return vs, pg_adv


def fragment_batch(b: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A worker's fragment as the V-trace learners' batch on `device`."""
    return batch_to_device({
        "obs": b["obs"], "actions": b["actions"], "rewards": b["rewards"],
        "dones": np.asarray(b["dones"], np.float32), "logp": b["logp"],
        "last_value": np.float32(b["last_value"])}, device)


def async_result(trainer, consumed: int, aux) -> Dict[str, Any]:
    """The async learners' result dict (IMPALA, APPO)."""
    stats = ray_tpu_torch.get(
        [w.episode_stats.remote() for w in trainer.workers])
    eps_done = [s for s in stats if s["episodes"]]
    return {
        "timesteps_total": trainer.timesteps,
        "episode_return_mean": float(np.mean(
            [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
        "episodes_total": sum(s["episodes"] for s in stats),
        "batches_consumed": consumed,
        **read_aux(aux),
    }


class ImpalaTrainer(Algorithm):
    """Async learner: keeps one in-flight sample request per worker,
    consumes whichever lands first (ref: impala.py training_step)."""

    def _setup(self, cfg: ImpalaConfig):
        from ray_tpu_torch.rl.connectors import build_pipeline
        from ray_tpu_torch.rl.core import probe_connected_spec
        from ray_tpu_torch.rl.ppo import init_any_policy

        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_shape, n_actions = probe_connected_spec(
            cfg.env, cfg.env_config, cfg.obs_connectors, cfg.seed)
        self.pipeline = build_pipeline(cfg.obs_connectors)
        self._conn_abs = None  # authoritative merged connector state
        self.params = to_device(init_any_policy(
            torch.Generator().manual_seed(cfg.seed), obs_shape, n_actions,
            cfg), self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = None
        self.workers = [
            RolloutWorker.options(num_cpus=0.5,
                                  runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, seed=cfg.seed + i * 1000,
                env_config=cfg.env_config,
                connectors=cfg.obs_connectors)
            for i in range(cfg.num_rollout_workers)]
        self._inflight: Dict[Any, Any] = {}   # ref -> worker
        self.timesteps = 0
        self._update = make_update(self._loss, self.opt)

    def _loss(self, params, batch):
        cfg = self.config
        logits, values = policy_forward(params, batch["obs"])
        logp_all, logp = log_softmax_taken(logits, batch["actions"])
        rhos = torch.exp(logp - batch["logp"])
        vs, pg_adv = vtrace(values, batch["rewards"], batch["dones"], rhos,
                            batch["last_value"], gamma=cfg.gamma,
                            rho_clip=cfg.vtrace_rho_clip,
                            c_clip=cfg.vtrace_c_clip)
        pg_loss = -(logp * pg_adv).mean()
        vf_loss = 0.5 * torch.square(values - vs).mean()
        ent = entropy(logp_all)
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * ent
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent}

    def _launch(self, worker, params_host):
        # the merged absolute connector state rides along with the weights,
        # same collect/merge/broadcast cycle as PPOTrainer.train
        ref = worker.sample.remote(params_host,
                                   self.config.rollout_fragment_length,
                                   self._conn_abs)
        self._inflight[ref] = worker

    def _consume(self, b):
        """A landed fragment: merge its connector delta, one update."""
        delta = b.pop("connector_state", None)
        if delta is not None:
            self._conn_abs = self.pipeline.merge_pipeline_states(
                [delta], prev=self._conn_abs)
        self.params, self.opt_state, aux = self._update(
            self.params, self.opt_state, fragment_batch(b, self.device))
        self.timesteps += len(b["rewards"])
        return aux

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        params_host = to_host(self.params)
        for w in self.workers:
            if w not in self._inflight.values():
                self._launch(w, params_host)

        aux = {}
        consumed = 0
        while consumed < cfg.batches_per_iter:
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=60.0)
            if not ready:
                break
            for ref in ready:
                if consumed >= cfg.batches_per_iter:
                    break
                worker = self._inflight.pop(ref)
                aux = self._consume(ray_tpu_torch.get(ref))
                consumed += 1
                # Relaunch immediately with the freshest weights (the
                # IMPALA point: actors never wait for the learner).
                self._launch(worker, to_host(self.params))
        return async_result(self, consumed, aux)

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
