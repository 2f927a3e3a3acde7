"""MARWIL: monotonic advantage re-weighted imitation learning.

Port of ``ray_tpu/rl/marwil.py`` (reference: rllib/algorithms/marwil —
offline imitation where each behavior-cloning term is weighted by exp(beta
* advantage): good demonstrated actions are imitated harder than bad ones,
and beta=0 degrades exactly to BC (the reference implements BC as MARWIL
beta=0; here BC is the standalone ray_tpu_torch.rl.offline.BCTrainer and
MARWIL adds the advantage machinery on the same offline mixin)).

The advantage is reward-to-go minus a learned value baseline, both
estimated from the offline transitions; the value net trains jointly with
the policy (squared error to the Monte-Carlo returns), and the advantage
scale is tracked with a running moving average as in the reference
(marwil.py's moving-average normalizer c^2 update). That average is a
Python float updated from each update's mean squared advantage, as the
reference's is: one device read an update. The learner on
``MARWILConfig.device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rl.core import (Adam, Algorithm, mlp_forward, mlp_init,
                                   reward_to_go, to_device, value_and_grad)
from ray_tpu_torch.rl.offline import (_OfflineMixin, _gather,
                                      gaussian_nll_terms)
from ray_tpu_torch.rl.ppo import read_aux


@dataclass
class MARWILConfig:
    dataset: Any = None              # {"obs","actions","rewards","dones"}
    discrete: bool = True
    beta: float = 1.0                # 0 => plain BC
    gamma: float = 0.99
    obs_dim: int = 0
    n_actions: int = 0
    act_dim: int = 0
    lr: float = 1e-3
    vf_coeff: float = 1.0
    moving_average_decay: float = 0.99   # advantage-norm c^2 tracker
    train_batch_size: int = 256
    updates_per_iter: int = 32
    hidden: int = 128
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def make_marwil_loss(cfg: MARWILConfig):
    def loss_fn(params, mb, c: float):
        values = mlp_forward(params["vf"], mb["obs"])[:, 0]
        adv = mb["returns"] - values
        vf_loss = torch.square(adv).mean()
        # re-weight imitation by exp(beta * normalized advantage);
        # no gradient: the policy must not inflate weights by corrupting
        # the baseline (ref: marwil surrogate); the exponent capped:
        # before the c^2 normalizer warms up, raw advantages can overflow
        # the exp
        w = torch.exp(torch.clamp(cfg.beta * adv.detach() / c, max=5.0))
        out = mlp_forward(params["pi"], mb["obs"])
        if cfg.discrete:
            logp = _gather(F.log_softmax(out, -1), mb["actions"])
            aux = {"accuracy": (out.argmax(-1) == mb["actions"]).float()
                   .mean()}
        else:
            nll, mu = gaussian_nll_terms(out, mb["actions"])
            logp = -nll
            aux = {"mse": torch.square(mu - mb["actions"]).mean()}
        pi_loss = -(w * logp).mean()
        total = pi_loss + cfg.vf_coeff * vf_loss
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "mean_weight": w.mean(),
                       "adv_sq": torch.square(adv).mean(), **aux}

    return loss_fn


class MARWILTrainer(_OfflineMixin, Algorithm):
    def _setup(self, cfg: MARWILConfig):
        assert cfg.dataset is not None, "MARWIL needs an offline dataset"
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self._init_data(cfg.dataset, cfg.train_batch_size, cfg.seed)
        for need in ("rewards", "dones"):
            assert need in self.data, f"MARWIL dataset needs {need!r}"
        self.data["returns"] = reward_to_go(
            np.asarray(self.data["rewards"], np.float32), cfg.gamma,
            dones=np.asarray(self.data["dones"], np.float32))
        obs_dim = cfg.obs_dim or int(self.data["obs"].shape[-1])
        if cfg.discrete:
            n_out = cfg.n_actions or int(self.data["actions"].max()) + 1
        else:
            n_out = 2 * (cfg.act_dim or int(self.data["actions"].shape[-1]))
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = to_device({
            "pi": mlp_init(gen, [obs_dim, cfg.hidden, cfg.hidden, n_out],
                           out_scale=0.01),
            "vf": mlp_init(gen, [obs_dim, cfg.hidden, cfg.hidden, 1],
                           out_scale=0.01),
        }, self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.c2 = 1.0                 # moving average of squared advantage
        self.workers = []
        self._loss = make_marwil_loss(cfg)

    def _update(self, params, opt_state, mb, c: float):
        (loss, aux), grads = value_and_grad(self._loss, params, mb, c)
        self.opt.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss, **aux}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        aux = {}
        for _ in range(cfg.updates_per_iter):
            mb = self._device_minibatch()
            c = float(np.sqrt(self.c2) + 1e-8)
            self.params, self.opt_state, aux = self._update(
                self.params, self.opt_state, mb, c)
            d = cfg.moving_average_decay
            self.c2 = d * self.c2 + (1 - d) * float(aux["adv_sq"])
        return {"c": float(np.sqrt(self.c2)), **read_aux(aux)}

    @torch.inference_mode()
    def compute_action(self, obs: np.ndarray):
        out = mlp_forward(self.params["pi"], torch.as_tensor(
            np.asarray(obs, np.float32)[None], device=self.device))[0]
        out = out.cpu().numpy()
        if self.config.discrete:
            return int(out.argmax(-1))
        mu, _ = np.split(out, 2, axis=-1)
        return mu

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
