"""The on-policy zoo (ray_tpu_torch/rl/{pg,a2c,a3c,impala,appo,ddppo}.py)
and the optimizers under it against the JAX reference on the CPU, in f32,
as tests/test_torch_rl_parity.py does for PPO.

- ``core.Adam`` and ``core.RMSProp``, with and without
  ``clip_by_global_norm``, against ``optax.chain(clip_by_global_norm,
  adam / rmsprop(decay=0.99, eps=1e-5))`` over 3 steps of the same
  gradients: params within OPT_TOL.
- One ``train()`` of PGTrainer, A2CTrainer, A3CTrainer, ImpalaTrainer,
  APPOTrainer and DDPPOTrainer on CartPole: the port's trainer over the
  port's runtime (workers in worker processes, learner on the CPU)
  against the reference's in this process, both from the reference's
  init. The asynchronous trainers (A3C, IMPALA, APPO) take their workers'
  results in dispatch order in both packages (the reference stub's
  ``wait`` gives that order; the port's ``wait`` is made to give it here),
  so the updates come in a fixed order. What each learner step is given
  is compared: batches (observations, actions, rewards bit for bit; logp
  and advantages within FWD_TOL / ADV_TOL) or the workers' gradients
  (within GRAD_TOL of each leaf's largest element), and the params after
  the iteration within ``test_torch_rl_parity.PARAM_MAX``.
"""

import numpy as np
import pytest
import torch

from test_torch_rl_parity import (FWD_TOL, GRAD_TOL, assert_close_scaled,
                                  assert_params_close, leaves_np,
                                  ref_layout)
from test_torch_support import jax_reference
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

import ray_tpu_torch
from ray_tpu_torch.rl import core as tcore

# the same f32 elementwise update rules on the same gradients: a few ulps
# of the params (|p| < 2 here, an ulp 2.4e-7)
OPT_TOL = 1e-6
# normalised advantages from the workers' values (f32 forwards that agree
# within FWD_TOL), as in the PPO trainer test
ADV_TOL = 1e-4


@pytest.mark.parametrize("name,clip", [("adam", None), ("adam", 0.5),
                                       ("rmsprop", None),
                                       ("rmsprop", 0.5)])
def test_optimizer_steps(name, clip):
    """3 steps of each optimizer on a two-leaf tree with fixed gradients
    (their global norm ~8-11: at 0.5 every step is clipped)."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(10)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (2.0 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    lr = 7e-4
    inner = (optax.adam(lr) if name == "adam" else
             optax.rmsprop(lr, decay=0.99, eps=1e-5))
    ropt = optax.chain(optax.clip_by_global_norm(clip), inner) if clip \
        else inner
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = ropt.init(rp)
    want = []
    for g in grads:
        upd, state = ropt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 state, rp)
        rp = optax.apply_updates(rp, upd)
        want.append({k: np.asarray(v) for k, v in rp.items()})

    topt = (tcore.Adam(lr, grad_clip=clip) if name == "adam" else
            tcore.RMSProp(lr, decay=0.99, eps=1e-5, grad_clip=clip))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = topt.init(tp)
    for g, w in zip(grads, want):
        topt.step(tp, tcore.tree_leaves(
            {k: torch.from_numpy(v) for k, v in g.items()}), tstate)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), w[k], rtol=0,
                                       atol=OPT_TOL, err_msg=k)


def _fifo_wait(refs, *, num_returns=1, timeout=None):
    """``ray_tpu_torch.wait`` in dispatch order: the first `num_returns`
    refs once they are ready."""
    ready = list(refs[:num_returns])
    ray_tpu_torch.get(ready, timeout=timeout)
    return ready, list(refs[num_returns:])


def _record(obj, name, arg, store):
    """Wrap ``obj.name`` so that each call's argument `arg` is kept (as
    numpy, copied) before the call."""
    fn = getattr(obj, name)

    def as_np(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy().copy()
        return np.array(x)

    def wrapped(*args):
        store.append(_tree_np(args[arg], as_np))
        return fn(*args)

    setattr(obj, name, wrapped)


def _tree_np(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_np(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v, fn) for v in tree]
    return fn(tree)


# (reference module, config, trainer), the config's kwargs, how many
# learner steps one train() makes, the recorded method and its argument
# index in the reference's trainer and in the port's, and what it takes:
# a batch ("batch") or the workers' gradients ("grads" of one worker,
# "grads_list" of the fleet)
CASES = {
    "pg": (("rl_pg", "PGConfig", "PGTrainer"),
           dict(num_rollout_workers=2, rollout_fragment_length=64), 1,
           ("_update", 2, 2), "batch"),
    "a2c": (("rl_a2c", "A2CConfig", "A2CTrainer"),
            dict(num_rollout_workers=2, rollout_fragment_length=64), 1,
            ("_update", 2, 2), "batch"),
    "a3c": (("rl_a3c", "A3CConfig", "A3CTrainer"),
            dict(num_rollout_workers=2, rollout_fragment_length=32,
                 grads_per_step=4), 4, ("_apply", 2, 0), "grads"),
    "impala": (("rl_impala", "ImpalaConfig", "ImpalaTrainer"),
               dict(num_rollout_workers=2, rollout_fragment_length=50,
                    batches_per_iter=4), 4, ("_update", 2, 2), "batch"),
    "appo": (("rl_appo", "APPOConfig", "APPOTrainer"),
             dict(num_rollout_workers=2, rollout_fragment_length=50,
                  batches_per_iter=4, target_update_freq=2), 4,
             ("_update", 3, 2), "batch"),
    "ddppo": (("rl_ddppo", "DDPPOConfig", "DDPPOTrainer"),
              dict(num_rollout_workers=2, rollout_fragment_length=64,
                   num_sgd_iter=3, minibatch_size=32), 3,
              ("_apply", 2, 0), "grads_list"),
}


def _port_trainer(name):
    import importlib

    (mod, cfg_name, tr_name), *_ = CASES[name]
    m = importlib.import_module(f"ray_tpu_torch.rl.{mod[3:]}")
    return getattr(m, cfg_name), getattr(m, tr_name)


def _compare_grads(got, want, what):
    for i, (g, w) in enumerate(zip(leaves_np(ref_layout(
            tcore.tree_map(torch.from_numpy, got))), leaves_np(want))):
        assert_close_scaled(g, w, GRAD_TOL, f"{what} leaf {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_train_iteration(ray_start_regular, monkeypatch, name):
    """One train() of the port's trainer against the reference's, from
    the reference's init (APPO's target network too)."""
    (mod, cfg_name, tr_name), kw, n_updates, (meth, rarg, targ), kind = \
        CASES[name]
    kw = dict(kw, seed=0)
    with jax_reference() as ref:
        m = getattr(ref, mod)
        rtr = getattr(m, tr_name)(getattr(m, cfg_name)(**kw))
        p0 = rtr.params
        rseen = []
        _record(rtr, meth, rarg, rseen)
        rres = rtr.train()
        rparams = rtr.params

    cfg_cls, tr_cls = _port_trainer(name)
    monkeypatch.setattr(ray_tpu_torch, "wait", _fifo_wait)
    tr = tr_cls(cfg_cls(device="cpu", **kw))
    try:
        tr.set_weights(tcore.params_from_jax(p0, "cpu"))
        seen = []
        _record(tr, meth, targ, seen)
        res = tr.train()
    finally:
        tr.stop()

    assert len(seen) == len(rseen) == n_updates
    assert res["timesteps_total"] == rres["timesteps_total"]
    # the last step's loss terms, as in the PPO trainer test
    terms = [k for k in ("loss", "total_loss", "pg_loss", "vf_loss",
                         "entropy") if k in rres]
    assert terms
    for k in terms:
        assert abs(res[k] - rres[k]) <= 1e-4 * max(abs(rres[k]), 1.0), k
    for step, (b, r) in enumerate(zip(seen, rseen)):
        if kind == "batch":
            assert set(b) == set(r), step
            for k in b:
                if k in ("obs", "actions", "rewards", "dones"):
                    np.testing.assert_array_equal(b[k], r[k], err_msg=k)
                elif k in ("adv", "returns"):
                    np.testing.assert_allclose(b[k], r[k], rtol=0,
                                               atol=ADV_TOL, err_msg=k)
                else:
                    np.testing.assert_allclose(b[k], r[k], rtol=0,
                                               atol=FWD_TOL, err_msg=k)
        elif kind == "grads":
            _compare_grads(b, r, f"apply {step}")
        else:
            assert len(b) == len(r)
            for j, (g, w) in enumerate(zip(b, r)):
                _compare_grads(g, w, f"sgd iter {step} worker {j}")
    assert_params_close(tr.params, rparams)
