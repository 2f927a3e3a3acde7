"""The training step, unsharded or sharded over a mesh, in PyTorch.

Port of ``ray_tpu/parallel/train_step.py``. Where JAX jits one function
over (params, optimizer state, batch) and XLA shards it by the state's
shardings, the port runs eagerly: ``loss.backward()`` for
``jax.value_and_grad`` and a ``torch.optim`` optimizer for the optax
chain. The parameters are updated IN PLACE (JAX donates the state to the
jitted step instead), so the returned ``TrainState`` holds the same
tensors as the one passed in.

- ``adamw`` builds ``torch.optim.AdamW`` with ``optax.adamw``'s defaults:
  note ``weight_decay=1e-4`` (torch's own default is 1e-2). Both decay
  every leaf (norms and embedding included), decouple the decay from the
  adaptive step, put eps outside the square root and bias-correct with
  the step count from 1, so their updates agree to f32 rounding.
- ``grad_norm`` is the global L2 norm of the gradients before the update.

Sharded (``mesh``, ``rules``, ``param_logical``): every param is a DTensor
placed by its logical spec and the rules, and so are its gradient and its
AdamW moments, which ``torch.optim.AdamW`` creates like the param (ZeRO:
under fsdp each rank holds 1/fsdp of every moment). The init draws the
params leaf by leaf from the seed generator and keeps only this rank's
shard of each. The step places the batch by ``batch_sharding``; the
model's loss (``llama.loss_fn`` with the same mesh and rules) gathers
weights at use and returns the global loss on every rank; ``loss`` and
``grad_norm`` come back as plain replicated scalars.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ray_tpu_torch import is_dtensor, resolve_device


class TrainState(NamedTuple):
    params: Any          # dict (pytree) of leaf tensors that require grad
    opt_state: Any       # the torch.optim optimizer over those leaves
    step: int


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


def _replicated(mesh):
    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec())


def opt_state_shardings(param_shardings, mesh):
    """ZeRO: the AdamW moments of each leaf (``exp_avg``, ``exp_avg_sq``)
    are sharded like the leaf, its step counter replicated; a tree
    mirroring the params. (JAX derives this from the optax state's shapes;
    torch.optim keeps one state dict per param, made at the first step.)"""
    rep = _replicated(mesh)
    return _map(lambda sh: {"step": rep, "exp_avg": sh, "exp_avg_sq": sh},
                param_shardings)


def batch_sharding(mesh, rules, batch_shapes):
    """Batch tree (leaves with a ``.shape``): dim 0 = batch over (dp, fsdp),
    dim 1 = seq over sp (if ranked), scalars replicated."""
    from ray_tpu_torch.parallel.sharding import named_sharding

    def one(x):
        ndim = len(x.shape) if hasattr(x, "shape") else 0
        if ndim == 0:
            return _replicated(mesh)
        if ndim == 1:
            return named_sharding(mesh, ("batch",), rules)
        return named_sharding(mesh, ("batch", "seq") + (None,) * (ndim - 2),
                              rules)

    return _map(one, batch_shapes)


def _check_mesh(mesh, rules, dev) -> None:
    if rules is None:
        raise ValueError("a mesh needs rules= (a ShardingRules preset)")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but the "
                         f"device is {dev.type!r}")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable[[List[torch.Tensor]],
                                                  torch.optim.Optimizer]:
    """``optax.adamw`` with its defaults, as a factory: call it on the
    parameter tensors to get a ``torch.optim.AdamW`` over them."""
    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    return make


def make_train_state_init(init_params_fn: Callable, optimizer, mesh=None,
                          rules=None, param_logical=None, device=None):
    """Returns (init_fn, state_shardings). ``init_fn(seed)`` (an int or a
    ``torch.Generator``) calls ``init_params_fn(generator)``, copies every
    leaf onto `device` (None means CUDA; raises without CUDA unless given
    "cpu") as a leaf that requires grad, and builds the optimizer (a
    factory such as ``adamw(...)``) over the leaves.

    Without a mesh, state_shardings is None. With one, it is
    ``TrainState(param shardings, opt_state_shardings, replicated)`` and
    every leaf becomes a DTensor placed by `param_logical` (a tree of
    logical specs, e.g. ``llama.param_specs(cfg)``) and `rules`, holding
    only this rank's shard. If ``init_params_fn`` takes a ``leaf`` keyword
    (as ``llama.init_params`` does) each leaf is sharded as soon as it is
    drawn, before the next one is, so no rank ever holds the whole float
    tree; the draws are the unsharded init's own, so the shards gathered
    back equal ``init_fn(seed)`` without a mesh bit for bit."""
    dev = resolve_device(device)
    if mesh is None:
        def init_fn(seed) -> TrainState:
            params = _map(lambda t: t.detach().to(dev, copy=True)
                          .requires_grad_(t.is_floating_point()),
                          init_params_fn(_generator(seed, dev)))
            return TrainState(params, optimizer(_leaves(params)), 0)

        return init_fn, None

    from ray_tpu_torch.parallel import sharding

    _check_mesh(mesh, rules, dev)
    if param_logical is None:
        raise ValueError("a mesh needs param_logical= (the params' logical "
                         "specs, e.g. llama.param_specs(cfg))")
    param_sh = sharding.tree_shardings(mesh, param_logical, rules)
    state_sh = TrainState(param_sh, opt_state_shardings(param_sh, mesh),
                          _replicated(mesh))
    placer = sharding.leaf_placer(mesh, param_logical, rules, dev)

    def place(path, t):
        return placer(path, t).requires_grad_(t.is_floating_point())

    streams = "leaf" in inspect.signature(init_params_fn).parameters

    def init_fn(seed) -> TrainState:
        gen = _generator(seed, dev)
        if streams:
            params = init_params_fn(gen, leaf=place)
        else:
            params = _map(lambda t: t.requires_grad_(t.is_floating_point()),
                          sharding.shard_params(mesh, init_params_fn(gen),
                                                param_logical, rules, dev))
        return TrainState(params, optimizer(_leaves(params)), 0)

    return init_fn, state_sh


def _generator(seed, dev) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))


def optax_global_norm(tree) -> torch.Tensor:
    """The global L2 norm of a tree of tensors, summed in f32. DTensor
    leaves (sharded gradients) count every element once: each rank sums
    the squares of its shard, and the sums are added over the mesh axes
    that shard the leaf (one all-reduce per placement pattern)."""
    plain, parts = [], {}
    for x in _leaves(tree):
        if is_dtensor(x):
            key = (x.device_mesh, tuple(x.placements))
            parts.setdefault(key, []).append(
                torch.sum(torch.square(x.to_local().float())))
        else:
            plain.append(torch.sum(torch.square(x.float())))
    for (mesh, placements), sums in parts.items():
        plain.append(_sum_over_shards(sum(sums), mesh, placements))
    return torch.sqrt(sum(plain))


def _sum_over_shards(x, mesh, placements):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = [Partial() if isinstance(p, Shard) else Replicate()
          for p in placements]
    return DTensor.from_local(x, mesh, pl).full_tensor()


def _place_batch(batch, shardings):
    """Batch leaves as DTensors of their sharding: a DTensor redistributed,
    a whole tensor cut to this rank's block."""
    from ray_tpu_torch.parallel.sharding import shard_tensor

    def one(x, sh):
        if is_dtensor(x):
            return x.redistribute(sh.mesh, sh.placements)
        return shard_tensor(x, sh, what="batch")

    if isinstance(batch, dict):
        return {k: _place_batch(v, shardings[k]) for k, v in batch.items()}
    return one(batch, shardings)


def make_train_step(loss_fn: Callable, optimizer=None, mesh=None,
                    rules=None, state_shardings=None, batch_shapes=None,
                    donate: bool = True):
    """loss_fn(params, batch) -> scalar. Returns step(state, batch) ->
    (state, {"loss", "grad_norm", "step"}). The optimizer is the one in
    ``state.opt_state`` (built by ``make_train_state_init``); the step
    updates the params in place whatever `donate` says (the port's form
    of JAX's donated state).

    With a mesh, the batch (DTensors or whole tensors, the same on every
    rank) is placed by ``batch_sharding(mesh, rules, batch_shapes or
    batch)`` before loss_fn sees it; loss_fn must pass the same mesh and
    rules to the model. `state_shardings` is ``make_train_state_init``'s
    (the state carries its placements; it is accepted for the JAX
    signature)."""
    if mesh is not None and rules is None:
        raise ValueError("a mesh needs rules= (a ShardingRules preset)")
    batch_sh = (batch_sharding(mesh, rules, batch_shapes)
                if mesh is not None and batch_shapes is not None else None)

    def step(state: TrainState, batch: Dict[str, Any]):
        if mesh is not None:
            batch = _place_batch(batch, batch_sh or
                                 batch_sharding(mesh, rules, batch))
        leaves = _leaves(state.params)
        for p in leaves:
            p.grad = None
        loss = loss_fn(state.params, batch)
        loss.backward()
        gnorm = optax_global_norm([p.grad for p in leaves if p.grad
                                   is not None])
        state.opt_state.step()
        n = state.step + 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm.detach(),
                   "step": n}
        return TrainState(state.params, state.opt_state, n), metrics

    return step


def make_eval_step(loss_fn: Callable, mesh=None, rules=None,
                   state_shardings=None):
    """eval(state, batch) -> loss_fn(state.params, batch), without
    gradients; with a mesh the batch is placed as in the train step."""
    if mesh is not None and rules is None:
        raise ValueError("a mesh needs rules= (a ShardingRules preset)")

    @torch.no_grad()
    def _eval(state: TrainState, batch):
        if mesh is not None:
            batch = _place_batch(batch, batch_sharding(mesh, rules, batch))
        return loss_fn(state.params, batch)

    return _eval
