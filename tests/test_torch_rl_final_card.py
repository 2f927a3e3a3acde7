"""The last five RL learners and tune on the card (``cuda``-marked; each
skips without CUDA, checked inside the test; this file imports no JAX).

- One update of each learner (QMIX, MADDPG, MAML's meta-update,
  AlphaZero, SlateQ) at its reference config's widths from the same
  params and minibatch on the card and on the CPU, f32 with TF32 off: each
  loss within LOSS_RTOL of the CPU's, each gradient leaf within GRAD_RTOL
  of its largest element (sums of at most 128 products in another order;
  MAML's second-order term through one more backward), the params after
  within 2 x lr of the CPU's (one Adam step moves an element by about lr).
- A two-trial ``Tuner`` whose trials ask for ``{"CPU": 1, "GPU": 1}``, one
  at a time: each trial sees CUDA, reports ``torch.cuda.current_device()``
  and finds no memory of its own in use at its start.
"""

import numpy as np
import pytest
import torch

from test_torch_support import require_cuda
from torch_runtime_support import reap_orphans  # noqa: F401

from ray_tpu_torch.rl import alpha_zero, maddpg, maml, qmix, slateq
from ray_tpu_torch.rl import core
from ray_tpu_torch.rl.dqn import make_q_update

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# a tune trial's reading of the card's use at its start: over the driver's
# by its own CUDA context (about 0.5 GB) at most CONTEXT_GB; trials one
# after the other within CARD_USED_MARGIN_GB, less than one context
CONTEXT_GB = 1.0
CARD_USED_MARGIN_GB = 0.25


class _Rec(core.Adam):
    """``core.Adam`` keeping each step's gradients (CPU f64 copies)."""

    def __init__(self, lr):
        super().__init__(lr)
        self.grads = []

    def step(self, params, grads, state):
        self.grads.append([g.detach().to("cpu", torch.float64)
                           for g in grads])
        super().step(params, grads, state)


def _mb(name, rng):
    """A minibatch of the learner's shapes at its config's batch size."""
    f = np.float32
    if name == "qmix":
        B = 32
        o, no = rng.normal(size=(B, 2, 3)).astype(f), \
            rng.normal(size=(B, 2, 3)).astype(f)
        return {"obs": o, "state": o.reshape(B, -1), "next_obs": no,
                "next_state": no.reshape(B, -1),
                "actions": rng.integers(0, 2, (B, 2)).astype(np.int32),
                "rewards": rng.normal(size=B).astype(f),
                "dones": (rng.random(B) < 0.3).astype(f)}
    if name == "maddpg":
        B = 128
        return {"obs": rng.normal(size=(B, 8)).astype(f),
                "actions": rng.uniform(-1, 1, (B, 2)).astype(f),
                "rewards": rng.normal(size=B).astype(f),
                "dones": (rng.random(B) < 0.2).astype(f),
                "next_obs": rng.normal(size=(B, 8)).astype(f)}
    if name == "alphazero":
        B, logits = 128, rng.normal(size=(128, 9))
        return {"obs": (rng.random((B, 18)) < 0.3).astype(f),
                "pi": (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                       ).astype(f),
                "z": rng.choice([-1.0, 0.0, 1.0], B).astype(f)}
    if name == "slateq":
        B = 64

        def unit(x):
            return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(f)
        return {"user": unit(rng.normal(size=(B, 4))),
                "docs": unit(rng.normal(size=(B, 10, 4))),
                "clicked": rng.integers(-1, 10, B).astype(np.int32),
                "rewards": rng.normal(size=B).astype(f),
                "dones": (rng.random(B) < 0.2).astype(f),
                "next_user": unit(rng.normal(size=(B, 4))),
                "next_docs": unit(rng.normal(size=(B, 10, 4)))}
    return {"obs": rng.normal(size=(80, 2)).astype(f),       # MAML task
            "actions": rng.normal(size=(80, 2)).astype(f),
            "adv": rng.normal(size=80).astype(f)}


def _setup(name, gen):
    """(initial tree(s), the update run(tree, mb, opt, device) -> (loss,
    params), lr) for learner `name` at its reference config's widths."""
    if name == "qmix":
        cfg = qmix.QMIXConfig()
        nets = qmix.init_qmix_nets(gen, 2, 3, 2, 6, cfg.hidden,
                                   cfg.mixing_embed)
        target = qmix.init_qmix_nets(gen, 2, 3, 2, 6, cfg.hidden,
                                     cfg.mixing_embed)

        def run(t, mb, opt):
            upd = make_q_update(qmix.make_qmix_loss(cfg.gamma, True), opt)
            net, _, loss, _ = upd(t[0], t[1], None, mb)
            return [loss], net
        return [nets, target], run, cfg.lr
    if name == "slateq":
        cfg = slateq.SlateQConfig()
        net = slateq.init_slateq_net(gen, 4, cfg.hidden)
        target = slateq.init_slateq_net(gen, 4, cfg.hidden)

        def run(t, mb, opt):
            upd = make_q_update(slateq.make_slateq_loss(cfg.gamma, 3, 0.5),
                                opt)
            net, _, loss, _ = upd(t[0], t[1], None, mb)
            return [loss], net
        return [net, target], run, cfg.lr
    if name == "maddpg":
        cfg = maddpg.MADDPGConfig()
        nets = maddpg.init_maddpg_nets(gen, 2, [4, 4], [1, 1], cfg.hidden)
        target = maddpg.init_maddpg_nets(gen, 2, [4, 4], [1, 1], cfg.hidden)

        def run(t, mb, opt):
            upd = maddpg.make_maddpg_update([4, 4], [1, 1], cfg.gamma,
                                            cfg.tau, opt, opt)
            aos = [opt.init(a) for a in t[0]["actors"]]
            cos = [opt.init(c) for c in t[0]["critics"]]
            out = upd(t[0], t[1], aos, cos, mb)
            return [out[4], out[5]], {"nets": out[0], "target": out[1]}
        return [nets, target], run, cfg.actor_lr
    if name == "alphazero":
        cfg = alpha_zero.AlphaZeroConfig()
        net = alpha_zero.init_az_net(gen, 18, 9, cfg.hidden)

        def run(t, mb, opt):
            upd = core.make_update(alpha_zero.az_loss, opt)
            net, _, aux = upd(t[0], None, mb)
            return [aux["total_loss"], aux["pi_loss"], aux["v_loss"]], net
        return [net], run, cfg.lr
    cfg = maml.MAMLConfig()
    params = maml.init_maml_policy(gen, cfg.hidden)

    def run(t, mb, opt):
        upd = maml.make_meta_update(opt, cfg.inner_lr)
        p, _, loss = upd(t[0], None, mb[0], mb[1])
        return [loss], p
    return [params], run, cfg.meta_lr


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qmix", "maddpg", "maml", "alphazero",
                                  "slateq"])
def test_update_card_matches_cpu(name):
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    tree0, run, lr = _setup(name, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    if name == "maml":      # two tasks' pre- and post-adaptation batches
        mb = [[_mb(name, rng) for _ in range(2)] for _ in range(2)]
    else:
        mb = _mb(name, rng)
    out = {}
    for dev in ("cuda", "cpu"):
        opt = _Rec(lr)
        t = core.to_device(tree0, dev)
        batch = ([[core.minibatch_to_device(b, dev) for b in tasks]
                  for tasks in mb] if name == "maml"
                 else core.minibatch_to_device(mb, dev))
        losses, params = run(t, batch, opt)
        assert all(x.device.type == dev for x in core.tree_leaves(params))
        out[dev] = ([float(x) for x in losses], opt.grads,
                    [x.detach().cpu().double() for x in
                     core.tree_leaves(params)])
    (lc, gc, pc), (lh, gh, ph) = out["cuda"], out["cpu"]
    for a, b in zip(lc, lh):
        assert abs(a - b) <= LOSS_RTOL * max(abs(b), 1.0), (a, b)
    assert len(gc) == len(gh) > 0
    for step_c, step_h in zip(gc, gh):
        for a, b in zip(step_c, step_h):
            assert float((a - b).abs().max()) <= GRAD_RTOL * max(
                float(b.abs().max()), 1e-30)
    for a, b in zip(pc, ph):
        assert float((a - b).abs().max()) <= 2 * lr


@pytest.mark.cuda
def test_tuner_trials_hold_the_card():
    """Two one-card trials, one after the other. Each reads the card's
    device-wide use at its start (``mem_get_info``): the driver's use plus
    its own CUDA context (about 0.5 GB), never more than
    CONTEXT_GB over the driver's; and the second reads within
    CARD_USED_MARGIN_GB of the first, so the first trial's process (its
    context at least) was gone."""
    require_cuda()
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import tune

    def trainable(config):
        import torch as t

        from ray_tpu_torch import tune as tn

        free, total = t.cuda.mem_get_info()
        x = t.ones(1024, 1024, device="cuda") * config["k"]
        tn.report({"device": t.cuda.current_device(),
                   "cuda": t.cuda.is_available(),
                   "card_used_at_start_gb": (total - free) / 1e9,
                   "score": float(x.sum())})

    ray_tpu_torch.init(num_cpus=4)
    try:
        free, total = torch.cuda.mem_get_info()
        driver_gb = (total - free) / 1e9
        grid = tune.Tuner(
            trainable, param_space={"k": tune.grid_search([1.0, 2.0])},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=1,
                resources_per_trial={"CPU": 1, "GPU": 1})).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert len(grid) == 2 and not grid.errors
    used = []
    for r in grid:
        m = r.metrics_history[0]
        assert m["cuda"] and m["device"] == 0
        used.append(m["card_used_at_start_gb"])
    assert used[0] <= driver_gb + CONTEXT_GB, (driver_gb, used)
    assert all(abs(u - used[0]) <= CARD_USED_MARGIN_GB for u in used), used
    assert grid.get_best_result().config["k"] == 2.0
