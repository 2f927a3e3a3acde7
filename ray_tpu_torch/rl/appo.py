"""APPO: asynchronous PPO — IMPALA-style async sampling + clipped surrogate.

Port of ``ray_tpu/rl/appo.py`` (reference: rllib/algorithms/appo/ (APPO =
PPO loss computed on V-trace corrected advantages over an asynchronous
sample pipeline, plus a target network refreshed periodically to anchor
the importance ratios — appo.py / appo_tf_policy.py)). Workers sample
with whatever weights they last received; the learner never blocks the
fleet. The learner's params are updated in place, so the target network
is a copy of them (the reference's immutable arrays need none).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   make_update, to_device, to_host,
                                   tree_map)
from ray_tpu_torch.rl.impala import async_result, fragment_batch, vtrace
from ray_tpu_torch.rl.ppo import (RolloutWorker, entropy,
                                  log_softmax_taken, policy_forward)


@dataclass
class APPOConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 100
    batches_per_iter: int = 4
    lr: float = 5e-4
    gamma: float = 0.99
    clip: float = 0.3
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    # refresh the ratio-anchoring target network every n learner updates
    # (ref: appo.py target_update_frequency)
    target_update_freq: int = 8
    hidden: int = 64
    seed: int = 0
    # connector factories + network choice, same semantics as PPOConfig
    obs_connectors: Any = None
    network: str = "auto"
    cnn_hidden: int = 512
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


class APPOTrainer(Algorithm):
    """Async PPO learner. One in-flight sample request per worker; each
    landed fragment gets V-trace advantages (off-policy correction against
    the *target* policy the fragment was sampled near) and one clipped
    PPO update (ref: appo.py training_step)."""

    def _setup(self, cfg: APPOConfig):
        from ray_tpu_torch.rl.connectors import build_pipeline
        from ray_tpu_torch.rl.core import probe_connected_spec
        from ray_tpu_torch.rl.ppo import init_any_policy

        self.device = ray_tpu_torch.resolve_device(cfg.device)
        obs_shape, n_actions = probe_connected_spec(
            cfg.env, cfg.env_config, cfg.obs_connectors, cfg.seed)
        self.pipeline = build_pipeline(cfg.obs_connectors)
        self._conn_abs = None
        self.params = to_device(init_any_policy(
            torch.Generator().manual_seed(cfg.seed), obs_shape, n_actions,
            cfg), self.device)
        self.target = _copy(self.params)
        self.opt = Adam(cfg.lr)
        self.opt_state = None
        self.workers = [
            RolloutWorker.options(num_cpus=0.5,
                                  runtime_env=CPU_WORKER_ENV).remote(
                cfg.env, seed=cfg.seed + i * 1000,
                env_config=cfg.env_config,
                connectors=cfg.obs_connectors)
            for i in range(cfg.num_rollout_workers)]
        self._inflight: Dict[Any, Any] = {}
        self.timesteps = 0
        self.num_updates = 0
        self._update = make_update(self._loss, self.opt)

    def _loss(self, params, batch):
        cfg = self.config
        logits, values = policy_forward(params, batch["obs"])
        logp_all, logp = log_softmax_taken(logits, batch["actions"])
        # ratios anchored on the periodically-refreshed target net,
        # not the behavior policy — the APPO stabilization trick
        with torch.no_grad():
            t_logits, _ = policy_forward(self.target, batch["obs"])
            _, t_logp = log_softmax_taken(t_logits, batch["actions"])
        behav_rhos = torch.exp(t_logp - batch["logp"])
        vs, pg_adv = vtrace(values, batch["rewards"], batch["dones"],
                            behav_rhos, batch["last_value"],
                            gamma=cfg.gamma, rho_clip=cfg.vtrace_rho_clip,
                            c_clip=cfg.vtrace_c_clip)
        # jnp.std: the population standard deviation
        adv = (pg_adv - pg_adv.mean()) / (
            pg_adv.std(correction=0) + 1e-8)
        ratio = torch.exp(logp - t_logp)
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
        vf = 0.5 * torch.square(values - vs).mean()
        ent = entropy(logp_all)
        total = pg + cfg.vf_coeff * vf - cfg.entropy_coeff * ent
        return total, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}

    def _launch(self, worker, params_host):
        ref = worker.sample.remote(params_host,
                                   self.config.rollout_fragment_length,
                                   self._conn_abs)
        self._inflight[ref] = worker

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
                b = ray_tpu_torch.get(ref)
                delta = b.pop("connector_state", None)
                if delta is not None:
                    self._conn_abs = self.pipeline.merge_pipeline_states(
                        [delta], prev=self._conn_abs)
                self.params, self.opt_state, aux = self._update(
                    self.params, self.opt_state,
                    fragment_batch(b, self.device))
                self.timesteps += len(b["rewards"])
                consumed += 1
                self.num_updates += 1
                if self.num_updates % cfg.target_update_freq == 0:
                    self.target = _copy(self.params)
                self._launch(worker, to_host(self.params))
        return {"num_updates": self.num_updates,
                **async_result(self, consumed, aux)}

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
        self.target = _copy(self.params)
