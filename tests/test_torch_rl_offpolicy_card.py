"""SAC, DQN and CQL updates on the card against the CPU (``cuda``-marked:
skipped without CUDA). One update from the same params, minibatch and
noise, f32 with TF32 off, on transitions of the rl_offpolicy phase's
fixtures (``chip_smoke.Pendulum``/``CartPole``, random actions): each
loss term within LOSS_RTOL of the CPU's, each gradient leaf (every
optimizer's) within GRAD_RTOL of its largest element, every param within
2 lr of the CPU's (Adam's first step is lr g / (|g| + eps): an element
whose gradient is at rounding level may take it with either sign). Imports
neither JAX nor gymnasium: it runs beside the card."""

import numpy as np
import pytest
import torch

from test_torch_support import require_cuda

import chip_smoke
from ray_tpu_torch.rl import core, dqn, offline, sac

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


class _RecAdam(core.Adam):
    def __init__(self, lr, store):
        super().__init__(lr)
        self.store = store

    def step(self, params, grads, state):
        self.store.append([g.detach().to("cpu", torch.float64)
                           for g in grads])
        super().step(params, grads, state)


def _transitions(env, n, seed):
    """`n` random-action transitions of `env`, as the replay buffer keeps
    them."""
    env.action_space.seed(seed)
    obs, _ = env.reset(seed=seed)
    rows = {k: [] for k in ("obs", "actions", "rewards", "dones",
                            "next_obs")}
    for _ in range(n):
        a = env.action_space.sample()
        nobs, rew, term, trunc, _ = env.step(a)
        for k, v in zip(rows, (obs, a, float(rew), float(term), nobs)):
            rows[k].append(np.asarray(v))
        obs = env.reset()[0] if term or trunc else nobs
    out = {k: np.stack(v) for k, v in rows.items()}
    for k in ("obs", "rewards", "dones", "next_obs"):
        out[k] = out[k].astype(np.float32)
    if out["actions"].dtype.kind == "f":
        out["actions"] = out["actions"].astype(np.float32)
    return out


def _noise(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen) for k, s in shapes.items()}


def _run(name, dev):
    """One update of `name` on `dev`: (loss terms, gradient lists, params
    after)."""
    gen = torch.Generator().manual_seed(0)
    store = []
    if name == "dqn":
        mb = _transitions(chip_smoke.CartPole(), 64, 1)
        cfg = dqn.DQNConfig()
        net = core.to_device(dqn.init_qnet(gen, 4, 2, cfg.hidden, True), dev)
        target = core.to_device(dqn.init_qnet(gen, 4, 2, cfg.hidden, True),
                                dev)
        upd = dqn.make_q_update(dqn.make_dqn_loss(cfg.gamma, True),
                                _RecAdam(cfg.lr, store))
        net, _, loss, _ = upd(net, target, None,
                              core.minibatch_to_device(mb, dev))
        return {"loss": loss}, store, net
    mb = _transitions(chip_smoke.Pendulum(), 128, 2)
    nets = core.to_device(sac.init_sac_nets(gen, 3, 1, 128), dev)
    tq = core.to_device(sac.init_sac_nets(gen, 3, 1, 128), dev)
    target = {"q1": tq["q1"], "q2": tq["q2"]}
    batch = core.minibatch_to_device(mb, dev)
    if name == "sac":
        cfg = sac.SACConfig()
        opts = [_RecAdam(3e-4, store) for _ in range(3)]
        la = torch.tensor(-0.5, device=dev)
        upd = sac.make_sac_update(cfg, 2.0, -1.0, *opts)
        noise = {k: v.to(dev) for k, v in _noise(
            {"eps_next": (128, 1), "eps_pi": (128, 1)}, 3).items()}
        out = upd(nets, target, la, opts[0].init(nets["actor"]),
                  opts[1].init({"q1": nets["q1"], "q2": nets["q2"]}),
                  opts[2].init(la), batch, noise)
        return out[6], store, {"nets": out[0], "log_alpha": out[2]}
    cfg = offline.CQLConfig(act_high=2.0)
    N = cfg.cql_n_actions
    noise = _noise({"eps_next": (128, 1), "eps_pol": (N, 128, 1),
                    "eps_pi": (128, 1)}, 4)
    gen = torch.Generator().manual_seed(5)
    for k in ("rand_a1", "rand_a2"):
        noise[k] = torch.rand((N, 128, 1), generator=gen) * 4 - 2
    c_opt, a_opt = _RecAdam(cfg.lr, store), _RecAdam(cfg.lr, store)
    upd = offline.make_cql_update(cfg, c_opt, a_opt)
    out = upd(nets, target, c_opt.init({"q1": nets["q1"], "q2": nets["q2"]}),
              a_opt.init(nets["actor"]), batch,
              {k: v.to(dev) for k, v in noise.items()})
    return out[4], store, out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sac", "dqn", "cql"])
def test_update_card_matches_cpu(name):
    require_cuda()
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        (lc, gc, pc), (lh, gh, ph) = _run(name, "cuda"), _run(name, "cpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert core.tree_leaves(pc)[0].device.type == "cuda"
    for k, v in lh.items():
        got, want = float(lc[k]), float(v)
        assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1e-30), \
            (k, got, want)
    assert len(gc) == len(gh) == {"sac": 3, "dqn": 1, "cql": 2}[name]
    for s, (gs_c, gs_h) in enumerate(zip(gc, gh)):
        for i, (a, b) in enumerate(zip(gs_c, gs_h)):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) / scale <= GRAD_RTOL, (s, i)
    lr = 1e-3 if name == "dqn" else 3e-4
    for a, b in zip(core.tree_leaves(pc), core.tree_leaves(ph)):
        assert float((a.cpu() - b).abs().max()) <= 2 * lr
