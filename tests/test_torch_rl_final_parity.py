"""The last five RL modules (ray_tpu_torch/rl/{slateq,qmix,maddpg,
alpha_zero,maml}.py) against the JAX reference on the CPU, in f32, as
tests/test_torch_rl_offpolicy_parity.py does for the off-policy family.
The reference loads through test_torch_support's stub packages (its
``rl_final`` group; a local-mode runtime: its trainers run in this
process); weights cross with ``rl.core.params_from_jax``.

Function level, from carried params, within FWD_TOL_FINAL of each
output's largest element: ``item_q``; ``agent_qs`` and ``mix``;
``actor_action`` and ``critic_value``; ``az_forward``; ``gaussian_logp``
and ``pg_loss``, with ``log_std`` inside and outside ``clip``'s range.

One update of each learner (SlateQ; QMIX double-Q and plain; MADDPG with
both agents' sequential critic and actor steps and the polyak targets;
AlphaZero's policy cross-entropy plus value MSE; MAML's meta-update): the
reference's update, jitted, with optax's Adam wrapped to hand back the
gradients it is given in its state, against the port's with
``core.Adam`` wrapped to keep them: loss terms within LOSS_RTOL, every
gradient leaf within GRAD_TOL of its largest element, the params (and
MADDPG's targets) after within PARAM_MAX (test_torch_rl_parity's).

MAML's meta-gradient against ``jax.grad`` through ``inner_adapt``: the
second-order term is there (the first-order gradient differs from it by
far more than the tolerance). ``mcts_policy``'s visit distribution equals
the reference's bit for bit for the same net and numpy rng.

Trainer level: one ``train()`` of each trainer (two of QMIX and SlateQ,
whose targets sync after the first), the port's over the port's runtime
(actors in worker processes, learners on the CPU) against the reference's
in this process, from the reference's init carried over, with
``ray_tpu_torch.wait`` in dispatch order: what each learner step is given
(env data bit for bit; MAML's rollouts, which follow each framework's
policy outputs, within FWD_TOL), the counters, the losses within LOSS_RTOL
and the params after within PARAM_MAX.

Ties: the inputs are continuous draws, so no two Q values, click-weighted
scores or MCTS scores are exactly equal, and an argmax or a top-k cannot
flip on a last-bit difference between the frameworks.
"""

import numpy as np
import pytest
import torch

from test_torch_rl_offpolicy_parity import (_assert_grads, _assert_terms,
                                            _fifo_wait, _grads, _jnp,
                                            _np_tree, _rec_optax, _RecAdam,
                                            _recorder, _recording)
from test_torch_rl_parity import (FWD_TOL, LOSS_RTOL, assert_close_scaled,
                                  assert_params_close)
from test_torch_support import jax_reference, to_np
from torch_runtime_support import reap_orphans  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.rl import alpha_zero as taz
from ray_tpu_torch.rl import core as tcore
from ray_tpu_torch.rl import maddpg as tmaddpg
from ray_tpu_torch.rl import maml as tmaml
from ray_tpu_torch.rl import qmix as tqmix
from ray_tpu_torch.rl import slateq as tslateq

# The forwards: f32 MLPs of at most 64 wide, the same products summed in
# another order; each element within 1e-6 of the output's largest.
FWD_TOL_FINAL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _carry(tree):
    return tcore.params_from_jax(_np_tree(tree), "cpu")


# --- forwards -----------------------------------------------------------------


def test_item_q():
    import jax

    rng = np.random.default_rng(0)
    user = rng.normal(size=(6, 4)).astype(np.float32)
    docs = rng.normal(size=(6, 10, 4)).astype(np.float32)
    with jax_reference("rl_final") as ref:
        net = ref.rl_slateq.init_slateq_net(jax.random.PRNGKey(3), 4, 64)
        want = np.asarray(ref.rl_slateq.item_q(net, user, docs))
    got = tslateq.item_q(_carry(net), _t(user), _t(docs))
    assert got.shape == (6, 10)
    assert_close_scaled(to_np(got), want, FWD_TOL_FINAL, "item_q")


def test_qmix_agent_qs_and_mix():
    import jax

    rng = np.random.default_rng(1)
    obs = rng.normal(size=(8, 2, 3)).astype(np.float32)
    qs = rng.normal(size=(8, 2)).astype(np.float32)
    state = rng.normal(size=(8, 6)).astype(np.float32)
    with jax_reference("rl_final") as ref:
        m = ref.rl_qmix
        nets = m.init_qmix_nets(jax.random.PRNGKey(4), 2, 3, 2, 6, 32, 16)
        want_q = np.asarray(m.agent_qs(nets, obs))
        want_mix = np.asarray(m.mix(nets, qs, state))
    tn = _carry(nets)
    assert_close_scaled(to_np(tqmix.agent_qs(tn, _t(obs))), want_q,
                        FWD_TOL_FINAL, "agent_qs")
    assert_close_scaled(to_np(tqmix.mix(tn, _t(qs), _t(state))), want_mix,
                        FWD_TOL_FINAL, "mix")


def test_maddpg_actor_and_critic():
    import jax

    rng = np.random.default_rng(2)
    obs = rng.normal(size=(16, 4)).astype(np.float32)
    jobs = rng.normal(size=(16, 8)).astype(np.float32)
    jact = rng.uniform(-1, 1, (16, 2)).astype(np.float32)
    with jax_reference("rl_final") as ref:
        m = ref.rl_maddpg
        nets = m.init_maddpg_nets(jax.random.PRNGKey(5), 2, [4, 4], [1, 1],
                                  64)
        want_a = np.asarray(m.actor_action(nets["actors"][1], obs))
        want_c = np.asarray(m.critic_value(nets["critics"][0], jobs, jact))
    tn = _carry(nets)
    assert_close_scaled(to_np(tmaddpg.actor_action(tn["actors"][1],
                                                   _t(obs))),
                        want_a, FWD_TOL_FINAL, "actor")
    assert_close_scaled(to_np(tmaddpg.critic_value(tn["critics"][0],
                                                   _t(jobs), _t(jact))),
                        want_c, FWD_TOL_FINAL, "critic")


def test_az_forward():
    import jax

    rng = np.random.default_rng(3)
    obs = (rng.random((12, 18)) < 0.3).astype(np.float32)
    with jax_reference("rl_final") as ref:
        m = ref.rl_alpha_zero
        net = m.init_az_net(jax.random.PRNGKey(6), 18, 9, 64)
        wl, wv = (np.asarray(x) for x in m.az_forward(net, obs))
    gl, gv = taz.az_forward(_carry(net), _t(obs))
    assert_close_scaled(to_np(gl), wl, FWD_TOL_FINAL, "logits")
    assert_close_scaled(to_np(gv), wv, FWD_TOL_FINAL, "value")


def _maml_batch(rng, n=40):
    return {"obs": rng.normal(size=(n, 2)).astype(np.float32),
            "actions": rng.normal(size=(n, 2)).astype(np.float32),
            "adv": rng.normal(size=(n,)).astype(np.float32)}


@pytest.mark.parametrize("log_std", [(-0.5, -0.5), (-4.0, 1.5)],
                         ids=["inside", "clipped"])
def test_gaussian_logp_and_pg_loss(log_std):
    import jax

    batch = _maml_batch(np.random.default_rng(4))
    with jax_reference("rl_final") as ref:
        m = ref.rl_maml
        params = m.init_maml_policy(jax.random.PRNGKey(7), 32)
        params["log_std"] = jax.numpy.asarray(log_std, jax.numpy.float32)
        want_lp = np.asarray(m.gaussian_logp(params, batch["obs"],
                                             batch["actions"]))
        want_loss = float(m.pg_loss(params, _jnp(batch)))
        want_g = [np.asarray(g) for g in jax.tree_util.tree_leaves(
            jax.grad(m.pg_loss)(params, _jnp(batch)))]
    tp = _carry(params)
    tb = {k: _t(v) for k, v in batch.items()}
    assert_close_scaled(to_np(tmaml.gaussian_logp(tp, tb["obs"],
                                                  tb["actions"])),
                        want_lp, FWD_TOL_FINAL, "logp")
    (loss, _), grads = tcore.value_and_grad(
        lambda p, b: (tmaml.pg_loss(p, b), {}), tp, tb)
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * max(abs(want_loss),
                                                           1.0)
    _assert_grads([[g.numpy() for g in grads]], [want_g])
    if log_std[0] < -3:     # clip's gradient is zero outside [-3, 1]
        assert torch.equal(grads[0], torch.zeros(2))


# --- one update of each learner ---------------------------------------------


def _slate_batch(rng, B=32, N=10, D=4):
    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
    clicked = rng.integers(-1, N, B).astype(np.int32)
    clicked[:2] = -1                     # no-click rows are in the batch
    return {"user": unit(rng.normal(size=(B, D))),
            "docs": unit(rng.normal(size=(B, N, D))),
            "slate": rng.integers(0, N, (B, 3)).astype(np.int32),
            "clicked": clicked,
            "rewards": rng.normal(size=B).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32),
            "next_user": unit(rng.normal(size=(B, D))),
            "next_docs": unit(rng.normal(size=(B, N, D)))}


def test_slateq_update():
    """The TD step of the clicked item's Q against the target's greedy
    slate value (top-k of the click-weighted values), masked to the
    clicked rows; the target differs from the online net."""
    import jax

    mb = _slate_batch(np.random.default_rng(5))
    with jax_reference("rl_final") as ref:
        m = ref.rl_slateq
        rtr = m.SlateQTrainer(m.SlateQConfig(num_rollout_workers=1))
        target = m.init_slateq_net(jax.random.PRNGKey(9), 4, 64)
        net0, target0 = _np_tree(rtr.net), _np_tree(target)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.net)
        out = jax.jit(rtr._make_update())(rtr.net, target, st, _jnp(mb))
        grads, loss, params = [_grads(out[1])], float(out[2]), \
            _np_tree(out[0])
    store = []
    cfg = tslateq.SlateQConfig()
    upd = tslateq.make_q_update(
        tslateq.make_slateq_loss(cfg.gamma, 3, 0.5),
        _RecAdam(cfg.lr, store))
    net, _, tloss, _ = upd(_carry(net0), _carry(target0), None,
                           tcore.minibatch_to_device(mb, "cpu"))
    _assert_terms({"loss": tloss}, {"loss": loss})
    _assert_grads(store, grads)
    assert_params_close(net, params)


def test_top_k_stable_takes_the_lower_index_on_ties():
    """``jax.lax.top_k``'s order on ties, which ``torch.topk`` does not
    promise (nor an unstable sort, on a row wide enough)."""
    import jax

    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 1.0]])
    assert tslateq.top_k_stable(x, 3).tolist() == [[1, 2, 4], [4, 0, 1]]
    wide = torch.zeros(2, 40)
    wide[0, 5] = wide[1, 30] = 1.0
    for row in (x, wide):
        want = np.asarray(jax.lax.top_k(row.numpy(), 3)[1])
        np.testing.assert_array_equal(tslateq.top_k_stable(row, 3).numpy(),
                                      want)


def _qmix_batch(rng, B=32):
    obs = rng.normal(size=(B, 2, 3)).astype(np.float32)
    nobs = rng.normal(size=(B, 2, 3)).astype(np.float32)
    return {"obs": obs, "state": obs.reshape(B, -1),
            "actions": rng.integers(0, 2, (B, 2)).astype(np.int32),
            "rewards": rng.normal(size=B).astype(np.float32),
            "dones": (rng.random(B) < 0.3).astype(np.float32),
            "next_obs": nobs, "next_state": nobs.reshape(B, -1)}


@pytest.mark.parametrize("double_q", [True, False], ids=["double", "plain"])
def test_qmix_update(double_q):
    import jax

    mb = _qmix_batch(np.random.default_rng(6))
    with jax_reference("rl_final") as ref:
        m = ref.rl_qmix
        rtr = m.QMIXTrainer(m.QMIXConfig(num_rollout_workers=1,
                                         double_q=double_q))
        target = m.init_qmix_nets(jax.random.PRNGKey(11), 2, 3, 2, 6, 32,
                                  16)
        net0, target0 = _np_tree(rtr.nets), _np_tree(target)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.nets)
        out = jax.jit(rtr._make_update())(rtr.nets, target, st, _jnp(mb))
        grads, loss, params = [_grads(out[1])], float(out[2]), \
            _np_tree(out[0])
    store = []
    cfg = tqmix.QMIXConfig()
    upd = tqmix.make_q_update(tqmix.make_qmix_loss(cfg.gamma, double_q),
                              _RecAdam(cfg.lr, store))
    nets, _, tloss, _ = upd(_carry(net0), _carry(target0), None,
                            tcore.minibatch_to_device(mb, "cpu"))
    _assert_terms({"loss": tloss}, {"loss": loss})
    _assert_grads(store, grads)
    assert_params_close(nets, params)


def _maddpg_batch(rng, B=64):
    return {"obs": rng.normal(size=(B, 8)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            "rewards": rng.normal(size=B).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32),
            "next_obs": rng.normal(size=(B, 8)).astype(np.float32)}


def test_maddpg_update():
    """Critic i steps first; actor i ascends the updated critic i with the
    other agent's logged action; every target leaf moves by tau toward its
    net. The target starts apart from the nets."""
    import jax

    mb = _maddpg_batch(np.random.default_rng(7))
    with jax_reference("rl_final") as ref:
        m = ref.rl_maddpg
        rtr = m.MADDPGTrainer(m.MADDPGConfig(num_rollout_workers=1))
        target = m.init_maddpg_nets(jax.random.PRNGKey(13), 2, [4, 4],
                                    [1, 1], 64)
        net0, target0 = _np_tree(rtr.nets), _np_tree(target)
        rtr.opt, rtr.copt = _rec_optax(rtr.opt), _rec_optax(rtr.copt)

        def zeros(tree):
            return jax.tree_util.tree_map(lambda x: x * 0, tree)
        aos = [(s, zeros(a)) for s, a in zip(rtr.actor_os,
                                             rtr.nets["actors"])]
        cos = [(s, zeros(c)) for s, c in zip(rtr.critic_os,
                                             rtr.nets["critics"])]
        out = jax.jit(rtr._make_update())(rtr.nets, target, aos, cos,
                                          _jnp(mb))
        want_a = [_grads(s) for s in out[2]]
        want_c = [_grads(s) for s in out[3]]
        terms = {"critic_loss": float(out[4]), "actor_loss": float(out[5])}
        params, tparams = _np_tree(out[0]), _np_tree(out[1])
    astore, cstore = [], []
    cfg = tmaddpg.MADDPGConfig()
    upd = tmaddpg.make_maddpg_update([4, 4], [1, 1], cfg.gamma, cfg.tau,
                                     _RecAdam(cfg.actor_lr, astore),
                                     _RecAdam(cfg.critic_lr, cstore))
    nets = _carry(net0)
    aos_t = [tcore.Adam(0).init(a) for a in nets["actors"]]
    cos_t = [tcore.Adam(0).init(c) for c in nets["critics"]]
    nets, tgt, _, _, closs, aloss = upd(
        nets, _carry(target0), aos_t, cos_t,
        tcore.minibatch_to_device(mb, "cpu"))
    _assert_terms({"critic_loss": closs, "actor_loss": aloss}, terms)
    _assert_grads(cstore, want_c)
    _assert_grads(astore, want_a)
    assert_params_close(nets, params)
    assert_params_close(tgt, tparams)


def _az_batch(rng, B=64):
    logits = rng.normal(size=(B, 9))
    pi = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"obs": (rng.random((B, 18)) < 0.3).astype(np.float32),
            "pi": pi.astype(np.float32),
            "z": rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32)}


def test_alphazero_update():
    import jax

    mb = _az_batch(np.random.default_rng(8))
    with jax_reference("rl_final") as ref:
        m = ref.rl_alpha_zero
        rtr = m.AlphaZeroTrainer(m.AlphaZeroConfig(num_rollout_workers=1))
        net0 = _np_tree(rtr.net)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.net)
        out = jax.jit(rtr._make_update())(rtr.net, st, _jnp(mb))
        grads, params = [_grads(out[1])], _np_tree(out[0])
        terms = {k: float(v) for k, v in out[2].items()}
    store = []
    upd = tcore.make_update(taz.az_loss, _RecAdam(1e-3, store))
    net, _, aux = upd(_carry(net0), None,
                      tcore.minibatch_to_device(mb, "cpu"))
    _assert_terms({"loss": aux["total_loss"], **aux}, terms)
    _assert_grads(store, grads)
    assert_params_close(net, params)


def _maml_tasks(seed, n_tasks=2):
    rng = np.random.default_rng(seed)
    return ([_maml_batch(rng) for _ in range(n_tasks)],
            [_maml_batch(rng) for _ in range(n_tasks)])


def test_maml_meta_update():
    """One meta-update over two tasks: the post-adaptation loss,
    differentiated through each task's inner step."""
    import jax

    pres, posts = _maml_tasks(9)
    with jax_reference("rl_final") as ref:
        m = ref.rl_maml
        rtr = m.MAMLTrainer(m.MAMLConfig(num_rollout_workers=1))
        p0 = _np_tree(rtr.params)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.params)
        out = jax.jit(rtr._make_meta_update())(
            rtr.params, st, [_jnp(b) for b in pres],
            [_jnp(b) for b in posts])
        grads, loss, params = [_grads(out[1])], float(out[2]), \
            _np_tree(out[0])
    store = []
    upd = tmaml.make_meta_update(_RecAdam(1e-3, store), 0.1)
    tp, _, tloss = upd(_carry(p0), None,
                       [tcore.minibatch_to_device(b, "cpu") for b in pres],
                       [tcore.minibatch_to_device(b, "cpu") for b in posts])
    _assert_terms({"meta_loss": tloss}, {"meta_loss": loss})
    _assert_grads(store, grads)
    assert_params_close(tp, params)


def test_maml_meta_gradient_matches_jax_grad_through_inner_step():
    """``jax.grad`` of ``pg_loss(inner_adapt(p, pre), post)`` against the
    port's gradient of the same, with a large inner step so that the
    second-order term is large; the first-order gradient (the inner
    gradient detached) is far from both."""
    import jax

    (pre,), (post,) = _maml_tasks(10, 1)
    with jax_reference("rl_final") as ref:
        m = ref.rl_maml
        params = m.init_maml_policy(jax.random.PRNGKey(2), 32)
        want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jax.grad(
            lambda p: m.pg_loss(m.inner_adapt(p, _jnp(pre), 0.5),
                                _jnp(post)))(params))]
    tb = [{k: _t(v) for k, v in b.items()} for b in (pre, post)]

    def meta(p):
        return tmaml.pg_loss(tmaml.inner_adapt(p, tb[0], 0.5), tb[1]), {}

    def first_order(p):
        leaves = tcore.tree_leaves(p)
        inner = torch.autograd.grad(tmaml.pg_loss(p, tb[0]), leaves)
        return tmaml.pg_loss(tcore.tree_unflatten_like(
            p, [x - 0.5 * g for x, g in zip(leaves, inner)]), tb[1]), {}
    _, got = tcore.value_and_grad(meta, _carry(params))
    _assert_grads([[g.numpy() for g in got]], [want])
    _, first = tcore.value_and_grad(first_order, _carry(params))
    gap = max(np.abs(f.numpy() - w).max() / np.abs(w).max()
              for f, w in zip(first, want))
    assert gap > 100 * 1e-4, gap


@pytest.mark.parametrize("moves", [(), (0, 4, 1), (4, 0, 8, 2)],
                         ids=["empty", "threat", "mid"])
def test_mcts_visits_bit_equal(moves):
    import jax

    with jax_reference("rl_final") as ref:
        m = ref.rl_alpha_zero
        net = m.init_az_net(jax.random.PRNGKey(21), 18, 9, 64)
        g = m.TicTacToe()
        for a in moves:
            g.step(a)
        want = m.mcts_policy(net, g, 25, 1.5, np.random.default_rng(3))
    tg = taz.TicTacToe()
    for a in moves:
        tg.step(a)
    got = taz.mcts_policy(_carry(net), tg, 25, 1.5,
                          np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


# --- one train() of each trainer ---------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(
        num_cpus=8, ignore_reinit_error=True,
        _system_config={"health_check_period_s": 0.2,
                        "worker_idle_timeout_s": 60.0})
    yield info
    ray_tpu_torch.shutdown()


# name: (reference module, its config's kwargs (the reference's widths;
# learning after one iteration's sampling; few updates; QMIX and SlateQ
# sync their target after their first iteration and train a second on
# it), the recorded learner method, the argument indices of what it is
# given, the learner steps of the train() calls, the params attribute, the
# result keys compared exactly, the loss keys)
TRAINERS = {
    "QMIX": ("rl_qmix", dict(num_rollout_workers=2,
                             rollout_fragment_length=32, learning_starts=64,
                             updates_per_iter=3,
                             target_network_update_freq=64),
             "_update", [3], 6, "nets",
             ("timesteps_total", "episodes_total", "num_updates",
              "buffer_size"), ("loss",)),
    "MADDPG": ("rl_maddpg", dict(num_rollout_workers=2,
                                 rollout_fragment_length=50,
                                 learning_starts=100, updates_per_iter=3),
               "_update", [4], 3, "nets",
               ("timesteps_total", "episodes_total", "num_updates",
                "buffer_size"), ("critic_loss", "actor_loss")),
    "SlateQ": ("rl_slateq", dict(num_rollout_workers=2,
                                 rollout_fragment_length=40,
                                 learning_starts=80, updates_per_iter=3,
                                 target_network_update_freq=80),
               "_update", [3], 6, "net",
               ("timesteps_total", "episodes_total", "num_updates",
                "buffer_size", "clicks_this_iter"), ("loss",)),
    "AlphaZero": ("rl_alpha_zero", dict(num_rollout_workers=2,
                                        games_per_worker=1,
                                        updates_per_iter=3),
                  "_update", [2], 3, "net",
                  ("games_total", "buffer_size", "draw_rate"),
                  ("loss", "pi_loss", "v_loss")),
    "MAML": ("rl_maml", dict(num_rollout_workers=2, episodes_per_task=4),
             "_meta_update", [2, 3], 1, "params", ("tasks_total",),
             ("meta_loss",)),
}


def _compare_inputs(name, seen, rseen):
    for step, (got, want) in enumerate(zip(seen, rseen)):
        for g, w in zip(got, want):
            if name == "MAML":          # lists of task batches
                for gt, wt in zip(g, w):
                    for k in wt:
                        assert_close_scaled(gt[k], wt[k], FWD_TOL,
                                            f"{name} step {step} {k}")
                continue
            assert set(g) == set(w), (step, set(g), set(w))
            for k in w:
                np.testing.assert_array_equal(
                    g[k], np.asarray(w[k], g[k].dtype),
                    err_msg=f"{name} step {step} {k}")


@pytest.mark.parametrize("name", list(TRAINERS))
def test_train_iteration(cluster, monkeypatch, name):
    """One train() of the port's trainer against the reference's (two for
    QMIX and SlateQ, across a target sync), from the reference's init."""
    from ray_tpu_torch.rl import get_algorithm

    mod, kw, rec, args, n_steps, attr, exact, losses = TRAINERS[name]
    iters = 2 if "target_network_update_freq" in kw else 1
    with jax_reference("rl_final") as ref:
        m = getattr(ref, mod)
        rtr = getattr(m, f"{name}Trainer")(getattr(m, f"{name}Config")(**kw))
        w0 = _np_tree(rtr.get_weights())
        rseen = []
        _recorder(rtr, rec, args, rseen)
        rres = [rtr.train() for _ in range(iters)][-1]
        rw = _np_tree(getattr(rtr, attr))
    pcfg, ptr = get_algorithm(name)
    monkeypatch.setattr(ray_tpu_torch, "wait", _fifo_wait)
    tr = ptr(pcfg(**kw, device="cpu"))
    try:
        tr.set_weights(tcore.params_from_jax(w0, "cpu"))
        seen = []
        _recorder(tr, rec, args, seen)
        res = [tr.train() for _ in range(iters)][-1]
    finally:
        tr.stop()
    for k in exact:
        assert res[k] == rres[k], (k, res[k], rres[k])
    for k in losses:
        assert abs(res[k] - rres[k]) <= LOSS_RTOL * max(abs(rres[k]), 1.0), \
            (k, res[k], rres[k])
    assert len(seen) == len(rseen) == n_steps, (len(seen), len(rseen))
    _compare_inputs(name, seen, rseen)
    assert_params_close(getattr(tr, attr), rw)
