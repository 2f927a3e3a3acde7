"""Shared RL infrastructure: networks, optimizers, replay, Algorithm base.

Port of ``ray_tpu/rl/core.py`` (reference: rllib's Algorithm
(rllib/algorithms/algorithm.py:554 setup / :813 step), ReplayBuffer
(rllib/utils/replay_buffers/) and the RolloutWorker fleet pattern
(rllib/evaluation/worker_set.py)). The learner lives on one device (CUDA
unless a config says ``device="cpu"``); rollout actors run on the CPU.

Params keep the reference's layout: nested dicts and lists of ``{"w",
"b"}`` tensors, dense weights ``[in, out]``, so a JAX tree carries over
leaf for leaf through ``params_from_jax``. The one exception is a conv
weight, which is OIHW here (``F.conv2d``) where JAX's is HWIO. Forwards
are plain functions on tensors; the optimizers (``Adam``, ``RMSProp``)
are optax's update rules on the leaves, in place.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch


# --- param trees --------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple, dict keys sorted (JAX's
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (and the same leaves of `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves: List[Any]):
    """A tree of `tree`'s structure holding `leaves` (in tree_leaves
    order)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            out = {k: rec(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(x) for x in node)
        return next(it)
    return rec(tree)


def to_device(tree, device):
    """A copy of a param tree (tensors or numpy arrays) on `device`, as
    float32 tensors that no autograd graph holds."""
    return tree_map(lambda x: torch.as_tensor(x).detach().to(
        device, torch.float32, copy=True), tree)


def to_host(tree):
    """CPU copies of a param tree's tensors: what rollout actors and
    checkpoints receive (never views of the learner's leaves, which the
    optimizer updates in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def clone_tree(tree):
    """A copy of a param tree on its own device (the reference's
    ``tree_map(lambda x: x, net)`` target networks: new leaves, never
    aliases of the learner's, which Adam updates in place)."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def polyak_(target, source, tau: float) -> None:
    """target <- (1 - tau) * target + tau * source, leaf for leaf, in place
    (one foreach lerp for the whole tree)."""
    torch._foreach_lerp_(tree_leaves(target), tree_leaves(source), tau)


def standard_normal(seed: int, shape, device) -> torch.Tensor:
    """A standard normal draw of `shape` from a CPU ``torch.Generator``
    seeded with `seed` (the integer the reference gives ``PRNGKey``), on
    `device`: the same numbers whatever the device. The update noise of
    TD3, SAC and CQL is drawn so."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


def minibatch_to_device(batch: Dict[str, Any],
                        device) -> Dict[str, torch.Tensor]:
    """A replay or offline minibatch (numpy columns) as tensors on `device`:
    floating columns in float32 (as ``jnp.asarray`` makes them with x64
    off: an offline dataset may hold float64), integer ones as int64 (the
    index type ``gather`` takes), booleans as they are. A read-only array
    (a zero-copy view of the object store) is copied first."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if not v.flags.writeable:
            v = v.copy()
        t = torch.as_tensor(v)
        if t.is_floating_point():
            t = t.to(device, torch.float32)
        elif t.dtype != torch.bool:
            t = t.to(device, torch.int64)
        else:
            t = t.to(device)
        out[k] = t
    return out


def params_from_jax(tree, device):
    """A JAX RL param tree (dicts and lists of ``{"w", "b"}`` leaves, numpy
    or jax arrays) as float32 tensors on `device`. Conv weights (4-D) go
    from JAX's HWIO to OIHW; every other leaf keeps its layout."""
    def one(x):
        t = torch.as_tensor(np.array(x, np.float32))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)
    return tree_map(one, tree)


# --- tiny nets ----------------------------------------------------------------


def dense_init(gen: torch.Generator, i: int, o: int, scale: float = None):
    """He-normal ``[i, o]`` weight (or normal * `scale`) and a zero bias,
    drawn on the CPU from `gen`."""
    s = (2.0 / i) ** 0.5 if scale is None else scale
    return {"w": torch.randn((i, o), generator=gen) * s,
            "b": torch.zeros((o,))}


def reward_to_go(batch_or_rewards, gamma: float, dones=None):
    """Discounted reward-to-go, resetting at dones (shared by PG/MARWIL;
    ref: postprocessing.compute_advantages with use_critic=False)."""
    if dones is None:
        rews = batch_or_rewards["rewards"]
        dones = batch_or_rewards["dones"]
    else:
        rews = batch_or_rewards
    out = np.zeros_like(rews, dtype=np.float32)
    running = 0.0
    for t in range(len(rews) - 1, -1, -1):
        running = rews[t] + gamma * running * (1.0 - dones[t])
        out[t] = running
    return out


def rollout_result(timesteps_total: int, worker_stats, aux) -> dict:
    """The standard on-policy result dict (shared by A2C/A3C/PG)."""
    eps_done = [s for s in worker_stats if s["episodes"]]
    return {
        "timesteps_total": timesteps_total,
        "episode_return_mean": float(np.mean(
            [s["mean_return"] for s in eps_done])) if eps_done else 0.0,
        "episodes_total": sum(s["episodes"] for s in worker_stats),
        **{k: float(v) for k, v in aux.items()},
    }


def mlp_init(gen: torch.Generator, sizes: List[int],
             out_scale: float = None):
    layers = []
    for n, (i, o) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = n == len(sizes) - 2
        layers.append(dense_init(gen, i, o, out_scale if last else None))
    return layers


def mlp_forward(layers, x, final_activation=False):
    for n, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if n < len(layers) - 1 or final_activation:
            x = torch.tanh(x)
    return x


# --- optimizers (optax's update rules) ----------------------------------------


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all the tensors together."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below `max_norm`, else each
    gradient scaled by max_norm / norm, i.e. by max / max(norm, max).
    (``torch.nn.utils.clip_grad_norm_`` scales by max / (norm + 1e-6).)
    Decided on the device: no host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class Adam:
    """optax.adam(lr, b1, b2, eps) (eps outside the square root, both
    moments bias-corrected with the step count from 1), after
    ``optax.clip_by_global_norm(grad_clip)`` where one is given. ``init``
    builds the state from the params that stand; ``step`` updates the
    params' leaves and the state in place (foreach ops: a few launches for
    the whole tree)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.grad_clip = grad_clip

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def step(self, params, grads: List[torch.Tensor], state) -> None:
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        state["count"] += 1
        t = state["count"]
        m_hat = torch._foreach_div(mu, 1 - self.b1 ** t)
        denom = torch._foreach_div(nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_mul_(m_hat, -self.lr)
        torch._foreach_add_(tree_leaves(params), m_hat)


class RMSProp:
    """optax.rmsprop(lr, decay, eps) at its defaults otherwise: the
    second moment from 0, no momentum, not centred, and eps INSIDE the
    square root (g * rsqrt(nu + eps); ``torch.optim.RMSprop`` divides by
    sqrt(nu) + eps), after ``clip_by_global_norm(grad_clip)`` where one is
    given. In place, as ``Adam``."""

    def __init__(self, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 grad_clip: Optional[float] = None):
        self.lr, self.decay, self.eps = lr, decay, eps
        self.grad_clip = grad_clip

    def init(self, params) -> Dict[str, Any]:
        return {"nu": [torch.zeros_like(p) for p in tree_leaves(params)]}

    @torch.no_grad()
    def step(self, params, grads: List[torch.Tensor], state) -> None:
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        nu = state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.decay)
        upd = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(upd)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(tree_leaves(params), upd)


def value_and_grad(loss_fn: Callable, params, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``: the
    loss, its aux dict (detached) and the gradient of every leaf of
    `params` in tree_leaves order. The params need not require grad: the
    loss is taken over detached aliases of the leaves (same storage)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten_like(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), grads


def make_update(loss_fn: Callable, opt):
    """One optimizer step on ``loss_fn(params, mb) -> (loss, aux)``:
    ``update(params, opt_state, mb) -> (params, opt_state, aux)`` with
    ``aux["total_loss"]``, the params updated in place (the same tree
    comes back), the aux still tensors on the device (read them once, after
    the last step: every read is a host sync). The opt state is built from
    the params on the first call when None is passed."""
    def update(params, opt_state, mb):
        if opt_state is None:
            opt_state = opt.init(params)
        (total, aux), grads = value_and_grad(loss_fn, params, mb)
        opt.step(params, grads, opt_state)
        aux["total_loss"] = total
        return params, opt_state, aux

    return update


# --- rollout sampling ---------------------------------------------------------


# Rollout actors must never touch the card: the learner owns it.
# process_env_vars applies at worker-process spawn, before torch is
# imported (runtime_env.py), so CUDA stays uninitialisable there.
# OMP_NUM_THREADS=1: an actor holds half a CPU, and torch's default of a
# thread per core in each of several actors oversubscribes the host.
CPU_WORKER_ENV = {"process_env_vars": {"CUDA_VISIBLE_DEVICES": "",
                                       "OMP_NUM_THREADS": "1"}}


def make_env(env_name: str, env_config: Optional[dict] = None):
    """Construct an env. "module:Class" names import and instantiate
    directly (no registry round-trip — works in any worker process, e.g.
    "ray_tpu_torch.rl.pixel_env:PixelCatcher"); everything else goes
    through gymnasium.make (ref: rllib env_creator resolution in
    rllib/env/utils.py)."""
    if ":" in env_name:
        import importlib

        mod_name, cls_name = env_name.split(":", 1)
        cls = getattr(importlib.import_module(mod_name), cls_name)
        return cls(**(env_config or {}))
    import gymnasium as gym

    return gym.make(env_name, **(env_config or {}))


class EnvSampler:
    """Shared env-loop plumbing for rollout actors: env construction,
    episode-return accounting, reset handling (ref: rollout_worker.py
    sample loop bookkeeping). Subclasses implement action selection."""

    def __init__(self, env_name: str, seed: int = 0,
                 env_config: Optional[dict] = None):
        self.env = make_env(env_name, env_config)
        self.seed = seed
        self.obs, _ = self.env.reset(seed=seed)
        self.steps = 0
        self.episode_return = 0.0
        self.completed: List[float] = []

    def step_env(self, action):
        """One env step with episode bookkeeping; returns
        (prev_obs, reward, terminated, truncated, next_obs) where next_obs
        is the pre-reset successor (what TD targets need)."""
        prev = self.obs
        nobs, rew, term, trunc, _ = self.env.step(action)
        successor = nobs
        self.episode_return += float(rew)
        self.steps += 1
        if term or trunc:
            self.completed.append(self.episode_return)
            self.episode_return = 0.0
            nobs, _ = self.env.reset()
        self.obs = nobs
        return prev, float(rew), bool(term), bool(trunc), successor

    def episode_stats(self) -> Dict[str, float]:
        return episode_stats_from(self.completed)

    def placement(self) -> Dict[str, Any]:
        return placement()

    def sample_transitions(self, select_action,
                           num_steps: int) -> Dict[str, np.ndarray]:
        """Collect an off-policy transition batch
        {obs, actions, rewards, dones, next_obs}; action choice is the
        only per-algorithm part (shared by the SAC/TD3 workers)."""
        obs_b, act_b, rew_b, done_b, nobs_b = [], [], [], [], []
        for _ in range(num_steps):
            action = select_action(self.obs)
            prev, rew, term, _trunc, nobs = self.step_env(action)
            obs_b.append(np.asarray(prev, np.float32))
            act_b.append(np.asarray(action, np.float32))
            rew_b.append(rew)
            done_b.append(float(term))
            nobs_b.append(np.asarray(nobs, np.float32))
        return {"obs": np.stack(obs_b), "actions": np.stack(act_b),
                "rewards": np.asarray(rew_b, np.float32),
                "dones": np.asarray(done_b, np.float32),
                "next_obs": np.stack(nobs_b)}


def placement() -> Dict[str, Any]:
    """Where the calling actor runs: its pid, whether CUDA is usable in it
    and what CUDA_VISIBLE_DEVICES says (CPU_WORKER_ENV hides the card)."""
    import os

    return {"pid": os.getpid(),
            "cuda_available": torch.cuda.is_available(),
            "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES")}


def episode_stats_from(completed: List[float]) -> Dict[str, float]:
    """Windowed episode-return stats shared by every rollout worker."""
    rets = completed[-20:]
    return {"episodes": len(completed),
            "mean_return": float(np.mean(rets)) if rets else 0.0}


# --- replay buffer ------------------------------------------------------------


class ReplayBuffer:
    """Uniform FIFO replay (ref: rllib/utils/replay_buffers/replay_buffer.py).
    Process-local; the off-policy trainers own one in the driver. For a
    distributed variant use ReplayActor."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v)
                self._storage[k] = np.zeros((self.capacity,) + v.shape[1:],
                                            v.dtype)
        for k, v in batch.items():
            v = np.asarray(v)
            idx = (self._idx + np.arange(n)) % self.capacity
            self._storage[k][idx] = v
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._storage.items()}

    def __len__(self):
        return self._size


@ray_tpu_torch.remote
class ReplayActor:
    """Replay buffer as an actor, for async fill/sample fan-in
    (ref: rllib distributed replay in APEX)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.buf = ReplayBuffer(capacity, seed)

    def add_batch(self, batch):
        self.buf.add_batch(batch)
        return len(self.buf)

    def sample(self, batch_size: int):
        if len(self.buf) < batch_size:
            return None
        return self.buf.sample(batch_size)

    def size(self):
        return len(self.buf)


# --- Algorithm base -----------------------------------------------------------


class Algorithm:
    """Minimal Trainable-compatible base (ref: Algorithm is a Tune
    Trainable; tune.Tuner can drive any subclass via the function API:
    `lambda cfg: loop over algo.train()`). Subclasses set ``self.device``
    (``ray_tpu_torch.resolve_device(config.device)``: CUDA unless the
    config says "cpu", and an error without CUDA) before anything else."""

    def __init__(self, config):
        self.config = config
        self.iteration = 0
        self._setup(config)

    def _setup(self, config):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("time_this_iter_s", time.time() - t0)
        return result

    def save(self) -> Dict[str, Any]:
        return {"params": to_host(self.get_weights()),
                "iteration": self.iteration}

    def restore(self, ckpt: Dict[str, Any]):
        self.set_weights(ckpt["params"])
        self.iteration = ckpt.get("iteration", 0)

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights):
        raise NotImplementedError

    def stop(self):
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass


def probe_connected_spec(env_name: str, env_config: Optional[dict],
                         connectors, seed: int = 0):
    """(obs_shape_after_connectors, n_actions) for a discrete-action env
    — the shared probe used by every actor-critic trainer (PPO/IMPALA/
    APPO/DDPPO) to size its policy net. Always closes the probe env."""
    from ray_tpu_torch.rl.connectors import build_pipeline

    env = make_env(env_name, env_config)
    try:
        obs0, _ = env.reset(seed=seed)
        if not hasattr(env.action_space, "n"):
            raise ValueError(
                f"{env_name} is not discrete-action; this trainer family "
                "requires a Discrete action space")
        n_actions = int(env.action_space.n)
    finally:
        env.close()
    pipeline = build_pipeline(connectors)
    obs_shape = pipeline(np.asarray(obs0, np.float32)).shape
    return obs_shape, n_actions


def probe_env_spec(env_name: str, env_config: Optional[dict] = None):
    """(obs_dim, n_actions | None, act_dim | None, act_high)."""
    env = make_env(env_name, env_config)
    obs_dim = int(np.prod(env.observation_space.shape))
    n_actions = act_dim = act_high = None
    if hasattr(env.action_space, "n"):
        n_actions = int(env.action_space.n)
    else:
        act_dim = int(np.prod(env.action_space.shape))
        act_high = float(np.asarray(env.action_space.high).reshape(-1)[0])
    env.close()
    return obs_dim, n_actions, act_dim, act_high
