"""Learner / LearnerGroup: the new-API-stack update engine.

Port of ``ray_tpu/rl/learner.py`` (reference: rllib/core/learner/
learner.py (Learner: module + optimizer + update loop,
compute_gradients/apply_gradients split) and learner_group.py:61
(LearnerGroup, update:156 — DDP across learner workers)).

A ``Learner`` owns params and Adam state on one device (the reference
shards the batch over ``jax.devices()``; the port runs on one card).
``LearnerGroup`` fans a batch across learner ACTORS; the reduction is an
explicit host-level gradient average done by the driver — the moral
equivalent of rllib's torch DDP learner group.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (Adam, to_device, to_host,
                                   tree_leaves, tree_unflatten_like,
                                   value_and_grad)
from ray_tpu_torch.rl.ppo import batch_to_device

# Lane-packed learners (num_cpus_per_learner < 1) run two actor lanes in
# ONE worker process, each a thread; a learner updates its params and
# optimizer state in place, and two threads interleaving those updates
# (or their kernels on one device) would corrupt both. All device work
# below is serialized per process.
_DEVICE_LOCK = threading.Lock()


@dataclass
class LearnerSpec:
    """What a learner needs to build itself (ref: LearnerSpec /
    RLModuleSpec in rllib/core/learner/learner.py)."""

    init_fn: Callable[[torch.Generator], Any]  # generator -> params tree
    loss_fn: Callable[[Any, Dict], Any]        # (params, batch) -> loss
    lr: float = 3e-4
    grad_clip: Optional[float] = None
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class Learner:
    """Owns params + optimizer state and the update
    (ref: learner.py update/compute_gradients/apply_gradients). Batches
    are host arrays, moved to the device per call (``actions`` as int64);
    the loss reads tensors."""

    def __init__(self, spec: LearnerSpec):
        self.spec = spec
        self.device = ray_tpu_torch.resolve_device(spec.device)
        self.params = to_device(
            spec.init_fn(torch.Generator().manual_seed(spec.seed)),
            self.device)
        self.opt = Adam(spec.lr, grad_clip=spec.grad_clip)
        self.opt_state = self.opt.init(self.params)

    def _grads(self, batch):
        (loss, _), grads = value_and_grad(
            lambda p, b: (self.spec.loss_fn(p, b), {}), self.params,
            batch_to_device(batch, self.device))
        return loss, grads

    def update(self, batch: Dict[str, np.ndarray]) -> float:
        """One optimizer step on the whole batch."""
        with _DEVICE_LOCK:
            loss, grads = self._grads(batch)
            self.opt.step(self.params, grads, self.opt_state)
            return float(loss)

    def compute_gradients(self, batch):
        """(loss, gradient tree as CPU tensors)."""
        with _DEVICE_LOCK:
            loss, grads = self._grads(batch)
            return float(loss), to_host(tree_unflatten_like(self.params,
                                                            grads))

    def apply_gradients(self, grads):
        with _DEVICE_LOCK:
            self.opt.step(self.params,
                          [g.to(self.device) for g in tree_leaves(grads)],
                          self.opt_state)

    def get_weights(self):
        return to_host(self.params)

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)

    def get_state(self):
        return {"params": to_host(self.params),
                "opt_state": {"count": self.opt_state["count"],
                              "mu": to_host(self.opt_state["mu"]),
                              "nu": to_host(self.opt_state["nu"])}}

    def set_state(self, state):
        self.params = to_device(state["params"], self.device)
        opt = state["opt_state"]
        self.opt_state = {"count": opt["count"],
                          "mu": to_device(opt["mu"], self.device),
                          "nu": to_device(opt["nu"], self.device)}


@ray_tpu_torch.remote
class _LearnerActor:
    def __init__(self, spec: LearnerSpec):
        self.learner = Learner(spec)

    def compute_gradients(self, batch):
        return self.learner.compute_gradients(batch)

    def apply_gradients(self, grads):
        self.learner.apply_gradients(grads)

    def update(self, batch):
        return self.learner.update(batch)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        self.learner.set_state(state)

    def get_weights(self):
        return self.learner.get_weights()


class LearnerGroup:
    """Data-parallel group of learner actors
    (ref: learner_group.py:61; update():156 drives DDP workers).

    update(batch) splits the batch N ways, gathers per-learner grads,
    averages on the driver, and applies the same averaged grads on every
    learner — keeping replicas bit-identical like DDP does. Learners on
    CUDA share the node's one card: each asks for 1/N of a GPU unit."""

    def __init__(self, spec: LearnerSpec, num_learners: int = 1,
                 num_cpus_per_learner: float = 1.0):
        if num_learners < 1:
            raise ValueError("num_learners >= 1")
        on_gpu = spec.device is None or torch.device(
            spec.device).type == "cuda"
        self._actors = [
            _LearnerActor.options(
                num_cpus=num_cpus_per_learner,
                num_gpus=1.0 / num_learners if on_gpu else 0).remote(spec)
            for _ in range(num_learners)]
        # replicas must start identical: broadcast learner 0's state
        state = ray_tpu_torch.get(self._actors[0].get_state.remote())
        ray_tpu_torch.get([a.set_state.remote(state)
                           for a in self._actors[1:]])

    def __len__(self):
        return len(self._actors)

    @staticmethod
    def _split(batch, n):
        keys = list(batch)
        rows = len(batch[keys[0]])
        if rows < n:
            raise ValueError(f"batch of {rows} rows can't split {n} ways")
        # spread the remainder so no row is dropped
        bounds = np.linspace(0, rows, n + 1, dtype=int)
        return [{k: np.asarray(batch[k])[bounds[i]:bounds[i + 1]]
                 for k in keys} for i in range(n)]

    def update(self, batch: Dict[str, np.ndarray]) -> float:
        if len(self._actors) == 1:
            return ray_tpu_torch.get(self._actors[0].update.remote(batch))
        shards = self._split(batch, len(self._actors))
        outs = ray_tpu_torch.get([a.compute_gradients.remote(s)
                                  for a, s in zip(self._actors, shards)])
        # weight by shard size (shards may be uneven) so the result equals
        # the full-batch gradient
        w = np.asarray([len(next(iter(s.values()))) for s in shards],
                       np.float64)
        w = torch.from_numpy(w / w.sum())
        losses = [o[0] for o in outs]
        grads = [tree_leaves(o[1]) for o in outs]
        mean = [torch.tensordot(w, torch.stack(g).double(), dims=1).to(
            g[0].dtype) for g in zip(*grads)]
        mean_grads = tree_unflatten_like(outs[0][1], mean)
        ray_tpu_torch.get([a.apply_gradients.remote(mean_grads)
                           for a in self._actors])
        return float(np.dot(w.numpy(), losses))

    def get_weights(self):
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def get_state(self):
        return ray_tpu_torch.get(self._actors[0].get_state.remote())

    def set_state(self, state):
        ray_tpu_torch.get([a.set_state.remote(state) for a in self._actors])

    def shutdown(self):
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
