"""DT: Decision Transformer — offline RL as sequence modeling.

Port of ``ray_tpu/rl/dt.py`` (reference: rllib/algorithms/dt/ (dt.py,
dt_torch_model.py — Chen et al. 2021: trajectories become (return-to-go,
state, action) token streams; a causal transformer is trained to predict
the action at each state token; at evaluation the desired return is fed
as the first RTG token and decremented by observed rewards)). The
transformer is the reference's compact causal encoder: fused QKV matmuls,
static context length K, the interleaved 3-tokens-per-step layout of the
reference's GPT backbone, one head, and plain attention with the
reference's ``-1e9`` fill and its softmax written out (T = 3 K tokens, a
few dozen: the reference reaches no kernel here, and neither does this).
The learner on ``DTConfig.device``; windows are drawn on the host with the
reference's numpy generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rl.core import (Adam, Algorithm, dense_init, mlp_forward,
                                   mlp_init, to_device, value_and_grad)


# --- tiny causal transformer -------------------------------------------------


def init_dt_model(gen: torch.Generator, obs_dim: int, n_actions: int,
                  d: int, n_layers: int, max_steps: int):
    model = {
        "rtg_emb": dense_init(gen, 1, d),
        "obs_emb": dense_init(gen, obs_dim, d),
        "act_emb": dense_init(gen, n_actions, d),
        "pos_emb": torch.randn((max_steps, d), generator=gen) * 0.02,
        "head": mlp_init(gen, [d, n_actions], out_scale=0.01),
        "blocks": [],
    }
    for _ in range(n_layers):
        model["blocks"].append({
            "qkv": dense_init(gen, d, 3 * d, scale=0.3),
            "proj": dense_init(gen, d, d, scale=0.3),
            "mlp1": dense_init(gen, d, 4 * d),
            "mlp2": dense_init(gen, 4 * d, d, scale=0.3),
        })
    return model


def _layer_norm(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5)


def dt_forward(model, rtg, obs, acts_onehot):
    """rtg [B,K,1], obs [B,K,O], acts_onehot [B,K,A] -> action logits
    at each state token [B,K,A]. Token order per step: (R_t, s_t, a_t),
    single-head causal attention over the 3K stream."""
    B, K = rtg.shape[:2]
    d = model["pos_emb"].shape[-1]
    pos = model["pos_emb"][:K][None, :, None, :]          # [1,K,1,d]
    tok = torch.stack([
        rtg @ model["rtg_emb"]["w"] + model["rtg_emb"]["b"],
        obs @ model["obs_emb"]["w"] + model["obs_emb"]["b"],
        acts_onehot @ model["act_emb"]["w"] + model["act_emb"]["b"],
    ], dim=2) + pos                                       # [B,K,3,d]
    x = tok.reshape(B, 3 * K, d)
    T = 3 * K
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=x.device))
    for blk in model["blocks"]:
        h = _layer_norm(x)
        qkv = h @ blk["qkv"]["w"] + blk["qkv"]["b"]
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        att = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        att = torch.where(mask[None], att, torch.full_like(att, -1e9))
        att = torch.exp(att - att.amax(-1, keepdim=True))
        att = att / att.sum(-1, keepdim=True)
        x = x + (att @ v) @ blk["proj"]["w"] + blk["proj"]["b"]
        h = _layer_norm(x)
        h = torch.relu(h @ blk["mlp1"]["w"] + blk["mlp1"]["b"])
        x = x + h @ blk["mlp2"]["w"] + blk["mlp2"]["b"]
    x = _layer_norm(x).reshape(B, K, 3, d)
    return mlp_forward(model["head"], x[:, :, 1])          # state tokens


# --- trainer -----------------------------------------------------------------


@dataclass
class DTConfig:
    # offline dataset: list of episodes, each {"obs" [T,O], "actions" [T],
    # "rewards" [T]} — or flat transition arrays with "dones" to split on
    dataset: Any = None
    n_actions: int = 0
    context_len: int = 8            # K steps of (R, s, a) context
    d_model: int = 64
    n_layers: int = 2
    lr: float = 1e-3
    train_batch_size: int = 64
    updates_per_iter: int = 32
    # evaluation-time return conditioning (ref: target_return config)
    target_return: float = 100.0
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


def _episodes_from(dataset) -> List[Dict[str, np.ndarray]]:
    if isinstance(dataset, list):
        return [{k: np.asarray(v) for k, v in ep.items()}
                for ep in dataset]
    data = {k: np.asarray(v) for k, v in dataset.items()}
    ends = np.flatnonzero(data["dones"]) + 1
    bounds = [0, *ends.tolist()]
    if bounds[-1] != len(data["obs"]):
        bounds.append(len(data["obs"]))
    return [{k: data[k][a:b] for k in ("obs", "actions", "rewards")}
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def make_dt_loss(n_actions: int):
    def loss_fn(model, rtg, obs, acts, mask):
        # true actions ride as tokens; a_t sits AFTER s_t in the stream,
        # so the causal mask keeps the prediction at s_t from seeing it
        # (no shift needed)
        logits = dt_forward(model, rtg, obs,
                            F.one_hot(acts, n_actions).to(rtg.dtype))
        logp = F.log_softmax(logits, -1)
        nll = -logp.gather(-1, acts[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        acc = ((logits.argmax(-1) == acts) * mask).sum() / denom
        return loss, {"acc": acc}

    return loss_fn


class DTTrainer(Algorithm):
    """ref: rllib/algorithms/dt/dt.py training_step — sample K-step
    windows from offline episodes, supervised action prediction
    conditioned on returns-to-go."""

    def _setup(self, cfg: DTConfig):
        assert cfg.dataset is not None, "DT needs an offline dataset"
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self.episodes = _episodes_from(cfg.dataset)
        for ep in self.episodes:
            # returns-to-go per step, the conditioning signal
            ep["rtg"] = np.cumsum(ep["rewards"][::-1])[::-1].astype(
                np.float32).copy()
        obs_dim = int(self.episodes[0]["obs"].shape[-1])
        self.n_actions = cfg.n_actions or int(
            max(ep["actions"].max() for ep in self.episodes)) + 1
        self.model = to_device(init_dt_model(
            torch.Generator().manual_seed(cfg.seed), obs_dim,
            self.n_actions, cfg.d_model, cfg.n_layers, cfg.context_len),
            self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.model)
        self._rng = np.random.default_rng(cfg.seed)
        self.workers = []
        self._loss = make_dt_loss(self.n_actions)

    def _sample_windows(self, batch_size: int):
        """K-step windows, left-padded with zeros (mask marks real
        steps), matching the reference's SegmentationBuffer sampling."""
        cfg = self.config
        K = cfg.context_len
        obs_dim = self.episodes[0]["obs"].shape[-1]
        rtg = np.zeros((batch_size, K, 1), np.float32)
        obs = np.zeros((batch_size, K, obs_dim), np.float32)
        acts = np.zeros((batch_size, K), np.int32)
        mask = np.zeros((batch_size, K), np.float32)
        for b in range(batch_size):
            ep = self.episodes[self._rng.integers(len(self.episodes))]
            T = len(ep["actions"])
            end = self._rng.integers(1, T + 1)
            start = max(0, end - K)
            n = end - start
            rtg[b, K - n:, 0] = ep["rtg"][start:end]
            obs[b, K - n:] = ep["obs"][start:end]
            acts[b, K - n:] = ep["actions"][start:end]
            mask[b, K - n:] = 1.0
        return rtg, obs, acts, mask

    def _update(self, model, opt_state, rtg, obs, acts, mask):
        (loss, aux), grads = value_and_grad(self._loss, model, rtg, obs,
                                            acts, mask)
        self.opt.step(model, grads, opt_state)
        return model, opt_state, loss, aux["acc"]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        loss = acc = torch.tensor(float("nan"))
        for _ in range(cfg.updates_per_iter):
            rtg, obs, acts, mask = self._sample_windows(
                cfg.train_batch_size)
            dev = self.device
            self.model, self.opt_state, loss, acc = self._update(
                self.model, self.opt_state, torch.from_numpy(rtg).to(dev),
                torch.from_numpy(obs).to(dev),
                torch.from_numpy(acts).to(dev, torch.int64),
                torch.from_numpy(mask).to(dev))
        loss, acc = torch.stack([loss.float().cpu(), acc.float().cpu()])
        return {"loss": float(loss), "action_accuracy": float(acc),
                "num_episodes": len(self.episodes)}

    @torch.inference_mode()
    def compute_action(self, history) -> int:
        """history: {"rtg": [t], "obs": [t, O], "actions": [t-1]} — the
        running episode so far; returns the next action (greedy)."""
        K = self.config.context_len
        t = len(history["obs"])
        n = min(t, K)
        obs_dim = history["obs"][0].shape[-1] if t else 0
        rtg = np.zeros((1, K, 1), np.float32)
        obs = np.zeros((1, K, obs_dim), np.float32)
        acts = np.zeros((1, K), np.int64)
        rtg[0, K - n:, 0] = np.asarray(history["rtg"][-n:])
        obs[0, K - n:] = np.asarray(history["obs"][-n:])
        # past actions as tokens; the current (unknown) action slot is a
        # zero token the causal mask hides from the prediction anyway
        past = list(history["actions"])[-(n - 1):] if n > 1 else []
        acts[0, K - n:K - n + len(past)] = np.asarray(past, np.int64)
        dev = self.device
        logits = dt_forward(
            self.model, torch.from_numpy(rtg).to(dev),
            torch.from_numpy(obs).to(dev),
            F.one_hot(torch.from_numpy(acts).to(dev),
                      self.n_actions).float())
        return int(logits[0, -1].argmax())

    def get_weights(self):
        return self.model

    def set_weights(self, weights):
        self.model = to_device(weights, self.device)
