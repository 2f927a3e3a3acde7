"""PPO: clipped surrogate objective, GAE, rollout-actor fleet + a learner on
the card.

Port of ``ray_tpu/rl/ppo.py`` (reference: rllib/algorithms/ppo/ (config +
training_step) and rllib/evaluation/rollout_worker.py sampling). Env
interface is gymnasium-shaped. The learner's params and Adam state live on
the trainer's device (CUDA unless ``PPOConfig.device="cpu"``); each
iteration the rollout actors get CPU copies and run the forward on the CPU
under ``torch.inference_mode()``, drawing actions with the reference's
numpy generator, so a seeded fragment takes the reference's actions.

``run_ppo_epochs`` copies the batch onto the learner's device once and
gathers each minibatch there with the reference's permutation (the same
``np.random.default_rng(seed)``), and reads the loss terms back once,
after the last minibatch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, EnvSampler,
                                   dense_init, make_update, to_device,
                                   to_host, tree_leaves)


# --- policy (plain functions, shared by learner and rollout workers) ---------


def init_policy(gen: torch.Generator, obs_dim: int, n_actions: int,
                hidden: int = 64):
    return {
        "torso": [dense_init(gen, obs_dim, hidden),
                  dense_init(gen, hidden, hidden)],
        "pi": dense_init(gen, hidden, n_actions),
        "v": dense_init(gen, hidden, 1),
    }


def policy_forward(params, obs):
    if "conv" in params:
        # pixel policy (rl/vision.py NatureCNN); PPO/IMPALA/APPO/DDPPO all
        # route through here, so the whole actor-critic family gains pixel
        # support from the one dispatch
        from ray_tpu_torch.rl.vision import vision_forward

        return vision_forward(params, obs)
    x = obs
    for layer in params["torso"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["v"]["w"] + params["v"]["b"])[..., 0]
    return logits, value


def init_any_policy(gen: torch.Generator, obs_shape, n_actions: int, cfg):
    """MLP for flat obs, NatureCNN for [H, W, C] obs (cfg.network
    "auto" | "mlp" | "cnn"; ref: rllib model catalog dispatch,
    rllib/models/catalog.py -> visionnet.py:22)."""
    net = getattr(cfg, "network", "auto")
    if net == "cnn" or (net == "auto" and len(obs_shape) == 3):
        from ray_tpu_torch.rl.vision import init_vision_policy

        return init_vision_policy(gen, obs_shape, n_actions,
                                  hidden=getattr(cfg, "cnn_hidden", 512))
    return init_policy(gen, int(np.prod(obs_shape)), n_actions, cfg.hidden)


def categorical_sample(logits_row: np.ndarray, rng):
    """Numerically-stable softmax sample -> (action, logp). Shared by the
    single- and multi-agent rollout workers."""
    p = np.exp(logits_row - logits_row.max())
    p = p / p.sum()
    a = int(rng.choice(len(p), p=p))
    return a, float(np.log(p[a] + 1e-9))


# --- rollout worker (CPU actor) ----------------------------------------------


@ray_tpu_torch.remote
class RolloutWorker(EnvSampler):
    """Samples env steps with the latest policy weights
    (ref: rollout_worker.py; sampler.py). Observations pass through the
    configured connector pipeline (ref: rllib agent connectors) exactly
    once each; the policy sees and trains on connected obs."""

    def __init__(self, env_name: str, seed: int = 0,
                 env_config=None, connectors=None):
        from ray_tpu_torch.rl.connectors import build_pipeline

        super().__init__(env_name, seed, env_config)
        self.pipeline = build_pipeline(connectors)
        self.pipeline.on_episode_start()
        self._obs_t = None  # connected view of self.obs

    def connector_state(self):
        return self.pipeline.get_state()

    def set_connector_state(self, state):
        self.pipeline.set_state(state)

    @torch.inference_mode()
    def sample(self, params_host, num_steps: int,
               connector_state=None) -> Dict[str, np.ndarray]:
        """`params_host`: the policy's CPU tensors. The forward runs on the
        CPU, one observation at a time."""
        # merged absolute connector state rides along with the weights
        # (no extra sync round-trips); the returned batch carries this
        # fragment's DELTA state for the trainer to merge
        if connector_state is not None:
            self.pipeline.set_state(connector_state)
        rng = np.random.default_rng(self.seed + len(self.completed))
        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = \
            [], [], [], [], [], []
        if self._obs_t is None:
            self._obs_t = self.pipeline(np.asarray(self.obs, np.float32))
        for _ in range(num_steps):
            obs_t = self._obs_t
            logits, value = policy_forward(params_host,
                                           torch.as_tensor(obs_t)[None])
            action, logp = categorical_sample(logits[0].numpy(), rng)
            _prev, rew, term, trunc, _nobs = self.step_env(action)
            if term or trunc:
                self.pipeline.on_episode_start()
            self._obs_t = self.pipeline(np.asarray(self.obs, np.float32))
            obs_buf.append(np.asarray(obs_t, np.float32))
            act_buf.append(action)
            rew_buf.append(rew)
            done_buf.append(term or trunc)
            logp_buf.append(logp)
            val_buf.append(float(value[0]))
        # bootstrap value for the final (connected) state
        _, last_v = policy_forward(params_host,
                                   torch.as_tensor(self._obs_t)[None])
        out = {
            "obs": np.stack(obs_buf),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, np.bool_),
            "logp": np.asarray(logp_buf, np.float32),
            "values": np.asarray(val_buf, np.float32),
            "last_value": float(last_v[0]),
        }
        if self.pipeline.connectors:
            out["connector_state"] = self.pipeline.get_state()
        return out


# --- GAE + learner -----------------------------------------------------------


def compute_gae(batch: dict, gamma: float, lam: float):
    rew, done, val = batch["rewards"], batch["dones"], batch["values"]
    T = len(rew)
    adv = np.zeros(T, np.float32)
    last_gae = 0.0
    next_v = batch["last_value"]
    for t in reversed(range(T)):
        nonterminal = 0.0 if done[t] else 1.0
        delta = rew[t] + gamma * next_v * nonterminal - val[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_v = val[t]
    returns = adv + val
    return adv, returns


def log_softmax_taken(logits, actions):
    """(log_softmax(logits), the log-prob of each row's action)."""
    logp_all = F.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions[:, None])[:, 0]


def entropy(logp_all):
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


def make_ppo_loss(clip: float, vf_coeff: float, entropy_coeff: float):
    """The clipped-surrogate loss alone (shared by make_ppo_update and
    the DDPPO worker-side gradient, ddppo.py). ``mb["actions"]`` is int64."""
    def loss_fn(params, mb):
        logits, value = policy_forward(params, mb["obs"])
        logp_all, logp = log_softmax_taken(logits, mb["actions"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf = 0.5 * torch.square(value - mb["returns"]).mean()
        ent = entropy(logp_all)
        total = pg + vf_coeff * vf - entropy_coeff * ent
        return total, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}

    return loss_fn


def make_ppo_update(cfg, opt):
    """The clipped-surrogate update shared by PPOTrainer,
    MultiAgentPPOTrainer and ExternalPPOTrainer (``core.make_update``: the
    params updated in place, aux left on the device). cfg needs .clip/
    .vf_coeff/.entropy_coeff; opt is a ``core.Adam``."""
    return make_update(
        make_ppo_loss(cfg.clip, cfg.vf_coeff, cfg.entropy_coeff), opt)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Host arrays as tensors on `device` (one copy each); integer actions
    as int64, the index type ``gather`` takes. A read-only array (a
    zero-copy view of the object store) is copied first: a tensor over it
    would claim to be writable."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and not v.flags.writeable:
            v = v.copy()
        t = torch.as_tensor(v)
        out[k] = t.to(device, torch.int64 if k == "actions" else t.dtype)
    return out


def run_ppo_epochs(update, params, opt_state, *, obs, actions, logp, adv,
                   returns, num_epochs: int, minibatch_size: int, seed: int):
    """The shared epoch/minibatch drive used by every PPO-family trainer:
    normalize advantages, then num_epochs passes of shuffled FULL
    minibatches (the reference keeps one shape for one XLA compilation;
    the minibatches are the same here). With fewer than minibatch_size
    rows, indices wrap. The batch goes to the params' device once; each
    minibatch is gathered there."""
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    dev = tree_leaves(params)[0].device
    batch = batch_to_device({"obs": obs, "actions": actions, "logp": logp,
                             "adv": adv, "returns": returns}, dev)
    n = len(obs)
    mbs = minibatch_size
    rng = np.random.default_rng(seed)
    aux = {}
    for _ in range(num_epochs):
        perm = rng.permutation(n)
        if n < mbs:
            perm = np.resize(perm, mbs)      # wrap: one full minibatch
        perm = torch.from_numpy(perm).to(dev)
        for lo in range(0, len(perm) - mbs + 1, mbs):
            idx = perm[lo:lo + mbs]
            mb = {k: v[idx] for k, v in batch.items()}
            params, opt_state, aux = update(params, opt_state, mb)
    return params, opt_state, aux


def read_aux(aux: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The loss terms as floats, in one device-to-host read."""
    if not aux:
        return {}
    vals = torch.stack([v.float() for v in aux.values()]).tolist()
    return dict(zip(aux, vals))


@dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 200
    num_epochs: int = 4
    minibatch_size: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    # connector FACTORIES (zero-arg callables) so every worker gets its
    # own stateful instances (ref: rllib connectors_v2 config)
    obs_connectors: Optional[List[Any]] = None
    # "auto": CNN when the connected obs is [H, W, C], MLP otherwise
    # (ref: rllib model catalog picks VisionNetwork for image spaces)
    network: str = "auto"
    cnn_hidden: int = 512
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class PPOTrainer:
    """ref: Algorithm.training_step (algorithm.py:1400) — sample via the
    worker fleet, update on the device, broadcast new weights. Params
    assigned to ``self.params`` before the first ``train()`` are trained
    from: the Adam state is built from the params that stand then."""

    def __init__(self, config: PPOConfig):
        from ray_tpu_torch.rl.connectors import build_pipeline
        from ray_tpu_torch.rl.core import probe_connected_spec

        self.cfg = config
        self.device = ray_tpu_torch.resolve_device(config.device)
        # obs shape AFTER the connector pipeline (e.g. FrameStack widens it)
        obs_shape, n_actions = probe_connected_spec(
            config.env, config.env_config, config.obs_connectors,
            config.seed)
        self.pipeline = build_pipeline(config.obs_connectors)
        self.params = to_device(init_any_policy(
            torch.Generator().manual_seed(config.seed), obs_shape,
            n_actions, config), self.device)
        self.opt = Adam(config.lr)
        self.opt_state = None
        self.workers = [
            RolloutWorker.options(num_cpus=0.5,
                                  runtime_env=CPU_WORKER_ENV).remote(
                config.env, seed=config.seed + i * 1000,
                env_config=config.env_config,
                connectors=config.obs_connectors)
            for i in range(config.num_rollout_workers)]
        self._update = self._make_update()
        self.iteration = 0
        self._conn_abs = None  # authoritative merged connector state

    def _make_update(self):
        return make_ppo_update(self.cfg, self.opt)

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        """One round of fragments from every worker, with GAE, as the
        host arrays run_ppo_epochs takes."""
        params_host = to_host(self.params)
        refs = [w.sample.remote(params_host, self.cfg.rollout_fragment_length,
                                self._conn_abs)
                for w in self.workers]
        batches = ray_tpu_torch.get(refs)

        # connector state sync (ref: rllib MeanStdFilter collect/merge/
        # broadcast): worker DELTAS arrive inside the sample batches,
        # merge into the authoritative absolute state here, and the next
        # sample() call carries it back — zero extra round-trips
        if self.cfg.obs_connectors:
            deltas = [b.pop("connector_state", None) for b in batches]
            self._conn_abs = self.pipeline.merge_pipeline_states(
                deltas, prev=self._conn_abs)

        obs, acts, logps, advs, rets = [], [], [], [], []
        for b in batches:
            adv, ret = compute_gae(b, self.cfg.gamma, self.cfg.lam)
            obs.append(b["obs"])
            acts.append(b["actions"])
            logps.append(b["logp"])
            advs.append(adv)
            rets.append(ret)
        return {"obs": np.concatenate(obs), "actions": np.concatenate(acts),
                "logp": np.concatenate(logps), "adv": np.concatenate(advs),
                "returns": np.concatenate(rets)}

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        batch = self._sample_batch()
        t1 = time.time()
        n = len(batch["obs"])
        self.params, self.opt_state, aux = run_ppo_epochs(
            self._update, self.params, self.opt_state, **batch,
            num_epochs=self.cfg.num_epochs,
            minibatch_size=self.cfg.minibatch_size, seed=self.iteration)
        aux = read_aux(aux)                 # waits for the device
        t2 = time.time()

        stats = ray_tpu_torch.get(
            [w.episode_stats.remote() for w in self.workers])
        mean_ret = float(np.mean([s["mean_return"] for s in stats
                                  if s["episodes"]])) \
            if any(s["episodes"] for s in stats) else 0.0
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "episodes_total": sum(s["episodes"] for s in stats),
            "timesteps_this_iter": n,
            "time_this_iter_s": time.time() - t0,
            # rllib's timers: sampling (fragments, GAE, concatenation)
            # and learning (the batch's copy and every minibatch update)
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
            **aux,
        }

    def stop(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
