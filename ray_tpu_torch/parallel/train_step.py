"""The training step on one device, in PyTorch.

Port of ``ray_tpu/parallel/train_step.py``. Where JAX jits one function
over (params, optimizer state, batch) and XLA shards it by the state's
shardings, the port runs eagerly on one device: ``loss.backward()`` for
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

Sharded training (``mesh``, ``rules``, ``state_shardings``,
``param_logical``, ``batch_shapes``) waits for ROADMAP.md queue 1 item 4:
a non-None ``mesh`` raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ray_tpu_torch import resolve_device


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


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: sharded training (mesh/rules) is not ported yet "
            f"(ROADMAP.md queue 1 item 4)")


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
    """Returns (init_fn, state_shardings=None). ``init_fn(seed)`` (an int
    or a ``torch.Generator``) calls ``init_params_fn(generator)``, copies
    every leaf onto `device` (None means CUDA; raises without CUDA unless
    given "cpu") as a leaf that requires grad, and builds the optimizer
    (a factory such as ``adamw(...)``) over the leaves."""
    _no_mesh(mesh, "make_train_state_init")
    dev = resolve_device(device)

    def init_fn(seed) -> TrainState:
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        params = _map(lambda t: t.detach().to(dev, copy=True)
                      .requires_grad_(t.is_floating_point()),
                      init_params_fn(gen))
        return TrainState(params, optimizer(_leaves(params)), 0)

    return init_fn, None


def optax_global_norm(tree) -> torch.Tensor:
    """The global L2 norm of a tree of tensors, summed in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def make_train_step(loss_fn: Callable, optimizer=None, mesh=None,
                    rules=None, state_shardings=None, batch_shapes=None,
                    donate: bool = True):
    """loss_fn(params, batch) -> scalar. Returns step(state, batch) ->
    (state, {"loss", "grad_norm", "step"}). The optimizer is the one in
    ``state.opt_state`` (built by ``make_train_state_init``); the step
    updates the params in place whatever `donate` says (the port's form
    of JAX's donated state)."""
    _no_mesh(mesh, "make_train_step")

    def step(state: TrainState, batch: Dict[str, Any]):
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
    gradients."""
    _no_mesh(mesh, "make_eval_step")

    @torch.no_grad()
    def _eval(state: TrainState, batch):
        return loss_fn(state.params, batch)

    return _eval
