"""The off-policy, offline and gradient-free RL algorithms
(ray_tpu_torch/rl/{dqn,simple_q,td3,ddpg,apex,r2d2,sac,offline,marwil,dt,
es,bandit}.py) against the JAX reference on the CPU, in f32, as
tests/test_torch_rl_parity.py and test_torch_rl_zoo_parity.py do for the
on-policy family. The reference loads through test_torch_support's stub
packages (a local-mode runtime: its trainers run in this process); weights
cross with ``rl.core.params_from_jax``.

The reference draws its update noise with ``jax.random`` keys; the port
takes it as tensors. Every comparison feeds the port the reference's own
draws, computed here from the same key with the reference's ``split``
sequence (``_sac_noise``, ``_cql_noise``, TD3's one normal draw).

Function level:
- the forwards: ``q_forward`` (dueling and plain), ``rq_unroll`` (the
  fused LSTM cell, from a nonzero state), ``actor_dist``/``sample_action``
  with the key's draw, ``q_value``, TD3/DDPG ``policy_action``,
  ``dt_forward``: within FWD_TOL of each output's largest element;
- one update of every learner (DQN double/dueling and plain, Ape-X DQN
  with its importance weights and |TD|, R2D2 with burn-in, TD3 with and
  without the delayed actor step, DDPG, Ape-X DDPG, SAC, BC discrete and
  continuous, CQL, CRR binary and exp, MARWIL discrete and continuous,
  DT): the reference's update (jitted) with optax's Adam wrapped to hand
  back every gradient it is given in its state, the port's with
  ``core.Adam`` wrapped to keep them; each loss term within LOSS_RTOL,
  every gradient leaf within GRAD_TOL of its largest element, the params
  after within PARAM_MAX (test_torch_rl_parity's);
- ``PrioritizedReplayBuffer``: the indices, weights and priorities equal to
  the reference's from the same seed, across adds, samples and priority
  updates.

Trainer level: one ``train()`` of each of the 18 trainers the slice
registers, the port's over the port's runtime (rollout and replay actors in
worker processes, learners on the CPU) against the reference's in this
process, from the reference's init carried over. The online ones run on
``chip_smoke:CartPole``/``chip_smoke:Pendulum`` (gymnasium's envs in numpy)
with ``action_seed`` seeding the action space on both sides, so epsilon and
warm-up draws agree; ``learning_starts`` is one iteration's sampling so
that updates run; Ape-X's fan-in takes its workers' fragments in dispatch
order in both packages. What each learner step is given is compared (env
data bit for bit; R2D2's stored LSTM states and Ape-X's importance weights,
which follow the priorities the learner's |TD| set, within FWD_TOL), then
the params after the iteration within PARAM_MAX. ES, ARS and the bandits are
numpy on both sides: their weights, arms and results are equal.
"""

import numpy as np
import pytest
import torch

from test_torch_rl_parity import (FWD_TOL, GRAD_TOL, LOSS_RTOL,
                                  assert_close_scaled, assert_params_close)
from test_torch_support import jax_reference, to_np
from torch_runtime_support import reap_orphans  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.rl import apex as tapex
from ray_tpu_torch.rl import core as tcore
from ray_tpu_torch.rl import ddpg as tddpg
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import dt as tdt
from ray_tpu_torch.rl import offline as toff
from ray_tpu_torch.rl import r2d2 as tr2d2
from ray_tpu_torch.rl import sac as tsac
from ray_tpu_torch.rl import td3 as ttd3


# --- shared helpers ----------------------------------------------------------


def _np_tree(tree):
    """A JAX tree (dicts, lists) as numpy copies."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _jnp(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


def _rec_optax(inner):
    """optax transformation `inner` whose state also carries the last
    gradients it was given, so that the reference's update, jitted, hands
    them back in the optimizer state it returns."""
    import jax
    import optax

    def init(params):
        return inner.init(params), jax.tree_util.tree_map(
            lambda x: x * 0, params)

    def update(grads, state, params=None):
        upd, inner_state = inner.update(grads, state[0], params)
        return upd, (inner_state, grads)

    return optax.GradientTransformation(init, update)


def _recording(rtr, attr, state, params):
    """Wrap the reference trainer's optimizer `attr` as ``_rec_optax`` and
    return its `state` (built for `params`) wrapped to match."""
    import jax

    setattr(rtr, attr, _rec_optax(getattr(rtr, attr)))
    return state, jax.tree_util.tree_map(lambda x: x * 0, params)


def _grads(state):
    """The gradients a ``_rec_optax`` state carries, as numpy leaves."""
    import jax

    return [np.asarray(g) for g in jax.tree_util.tree_leaves(state[1])]


class _RecAdam(tcore.Adam):
    """``core.Adam`` keeping each step's gradients (numpy) in `store`."""

    def __init__(self, lr, store):
        super().__init__(lr)
        self.store = store

    def step(self, params, grads, state):
        self.store.append([g.detach().cpu().numpy().copy() for g in grads])
        super().step(params, grads, state)


def _assert_grads(got, want):
    assert len(got) == len(want)
    for s, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws), s
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert_close_scaled(g, w, GRAD_TOL, f"step {s} grad leaf {i}")


def _assert_terms(got, want):
    assert set(want) <= set(got), (set(got), set(want))
    for k, w in want.items():
        g = float(got[k])
        assert abs(g - w) <= LOSS_RTOL * max(abs(w), 1.0), (k, g, w)


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _transitions(n, obs_dim, *, n_actions=None, act_dim=None, seed=1):
    rng = np.random.default_rng(seed)
    mb = {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
          "rewards": rng.normal(size=n).astype(np.float32),
          "dones": (rng.random(n) < 0.2).astype(np.float32),
          "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32)}
    if n_actions:
        mb["actions"] = rng.integers(0, n_actions, n).astype(np.int32)
    else:
        mb["actions"] = rng.uniform(-2, 2, (n, act_dim)).astype(np.float32)
    return mb


def _sac_noise(key, B, A):
    """SACTrainer's update draws from the reference's key: ``k1, k2 =
    split(key)``, a normal [B, A] from each (the next action's, the
    actor's)."""
    import jax

    k1, k2 = jax.random.split(key)
    return {"eps_next": torch.from_numpy(np.array(
                jax.random.normal(k1, (B, A)))),
            "eps_pi": torch.from_numpy(np.array(
                jax.random.normal(k2, (B, A))))}


def _cql_noise(key, B, A, N, act_high):
    """CQL's five draws from the reference's key split five ways: the next
    action's, the policy's N actions', the uniform actions of each critic's
    penalty, the actor's."""
    import jax

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)

    def t(x):
        return torch.from_numpy(np.array(x))
    return {"eps_next": t(jax.random.normal(k1, (B, A))),
            "eps_pol": t(jax.random.normal(k2, (N, B, A))),
            "rand_a1": t(jax.random.uniform(k3, (N, B, A), minval=-act_high,
                                            maxval=act_high)),
            "rand_a2": t(jax.random.uniform(k4, (N, B, A), minval=-act_high,
                                            maxval=act_high)),
            "eps_pi": t(jax.random.normal(k5, (B, A)))}


# --- forwards ---------------------------------------------------------------


@pytest.mark.parametrize("dueling", [True, False], ids=["dueling", "plain"])
def test_q_forward(dueling):
    import jax

    obs = np.random.default_rng(2).normal(size=(9, 4)).astype(np.float32)
    with jax_reference() as ref:
        rn = ref.rl_dqn.init_qnet(jax.random.PRNGKey(0), 4, 3, 16, dueling)
        want = np.asarray(ref.rl_dqn.q_forward(rn, obs))
    got = tdqn.q_forward(tcore.params_from_jax(rn, "cpu"),
                         torch.from_numpy(obs))
    assert_close_scaled(to_np(got), want, FWD_TOL, "q")


def test_rq_unroll():
    """The fused LSTM cell unrolled over T from a nonzero state: Q at every
    step and the final (h, c)."""
    import jax

    rng = np.random.default_rng(3)
    obs = rng.normal(size=(3, 7, 4)).astype(np.float32)
    h0 = rng.normal(size=(3, 8)).astype(np.float32)
    c0 = rng.normal(size=(3, 8)).astype(np.float32)
    with jax_reference() as ref:
        rn = ref.rl_r2d2.init_rqnet(jax.random.PRNGKey(0), 4, 2, 8)
        # a bias away from 0 in every gate
        rn["lstm"]["b"] = jax.numpy.asarray(
            rng.normal(size=32).astype(np.float32))
        q, (h, c) = ref.rl_r2d2.rq_unroll(rn, obs, h0, c0)
        want = [np.asarray(x) for x in (q, h, c)]
    tn = tcore.params_from_jax(rn, "cpu")
    assert tuple(tn["lstm"]["w"].shape) == (16, 32)
    q, (h, c) = tr2d2.rq_unroll(tn, torch.from_numpy(obs),
                                torch.from_numpy(h0), torch.from_numpy(c0))
    for what, g, w in zip(("q", "h", "c"), (q, h, c), want):
        assert_close_scaled(to_np(g), w, FWD_TOL, what)


def test_sac_actor_and_critic_forward():
    """``actor_dist`` with a wide head (log-stds past both ends of [-20,
    2]); ``sample_action`` with the key's draw fed as `eps` and
    ``q_value`` at the init's widths (tanh away from saturation: there
    ``log(1 - a^2 + 1e-6)`` turns one ulp of tanh into 1e-4 of logp, in
    either package)."""
    import jax

    obs = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    with jax_reference() as ref:
        m = ref.rl_sac
        nets = m.init_sac_nets(jax.random.PRNGKey(0), 3, 2, 16)
        wide = dict(nets["actor"], head=[dict(
            nets["actor"]["head"][0], w=nets["actor"]["head"][0]["w"] * 9e3)])
        mu, log_std = m.actor_dist(wide, obs)
        a, logp = m.sample_action(nets["actor"], obs, key, 2.0)
        eps = np.array(jax.random.normal(key, a.shape))
        qv = m.q_value(nets["q1"], obs, np.asarray(a))
        want = [np.asarray(x) for x in (mu, log_std, a, logp, qv)]
        wide_np, nets_np = _np_tree(wide), _np_tree(nets)
    assert want[1].max() == 2.0 and want[1].min() == -20.0
    tw = tcore.params_from_jax(wide_np, "cpu")
    tn = tcore.params_from_jax(nets_np, "cpu")
    x = torch.from_numpy(obs)
    tmu, tls = tsac.actor_dist(tw, x)
    ta, tlogp = tsac.sample_action(tn["actor"], x, torch.from_numpy(eps), 2.0)
    tq = tsac.q_value(tn["q1"], x, torch.from_numpy(want[2].copy()))
    for what, g, w in zip(("mu", "log_std", "a", "logp", "q"),
                          (tmu, tls, ta, tlogp, tq), want):
        assert_close_scaled(to_np(g), w, FWD_TOL, what)


def test_td3_policy_action_and_q_value():
    """TD3's (and DDPG's) deterministic actor and critic."""
    import jax

    rng = np.random.default_rng(5)
    obs = rng.normal(size=(6, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, (6, 1)).astype(np.float32)
    with jax_reference() as ref:
        nets = ref.rl_td3.init_td3_nets(jax.random.PRNGKey(0), 3, 1, 16)
        nets["actor"][-1]["w"] = nets["actor"][-1]["w"] * 300
        want = [np.asarray(ref.rl_td3.policy_action(nets["actor"], obs, 2.0)),
                np.asarray(ref.rl_td3.q_value(nets["q2"], obs, act))]
    tn = tcore.params_from_jax(nets, "cpu")
    got = [ttd3.policy_action(tn["actor"], torch.from_numpy(obs), 2.0),
           ttd3.q_value(tn["q2"], torch.from_numpy(obs),
                        torch.from_numpy(act))]
    for what, g, w in zip(("action", "q"), got, want):
        assert_close_scaled(to_np(g), w, FWD_TOL, what)


def test_dt_forward():
    import jax

    rng = np.random.default_rng(6)
    B, K, O, A = 3, 5, 4, 3
    rtg = rng.normal(size=(B, K, 1)).astype(np.float32)
    obs = rng.normal(size=(B, K, O)).astype(np.float32)
    acts = rng.integers(0, A, (B, K))
    onehot = np.eye(A, dtype=np.float32)[acts]
    with jax_reference() as ref:
        model = ref.rl_dt.init_dt_model(jax.random.PRNGKey(0), O, A, 16, 2,
                                        K)
        want = np.asarray(ref.rl_dt.dt_forward(model, rtg, obs, onehot))
    tm = tcore.params_from_jax(model, "cpu")
    got = tdt.dt_forward(tm, torch.from_numpy(rtg), torch.from_numpy(obs),
                         torch.from_numpy(onehot))
    assert_close_scaled(to_np(got), want, FWD_TOL, "logits")


# --- one update of each learner ---------------------------------------------


def _compare_update(ref_grads, ref_terms, ref_params, port_grads, port_terms,
                    port_params):
    _assert_terms(port_terms, ref_terms)
    _assert_grads(port_grads, ref_grads)
    assert_params_close(port_params, ref_params)


@pytest.mark.parametrize("kind", ["double_dueling", "plain", "apex"])
def test_dqn_update(kind):
    """DQN's TD step (double-Q: the online net's argmax at s', the target
    net's value there; the target differs from the online net) and Ape-X's
    importance-weighted one with its |TD| for the priorities."""
    import jax

    double = kind != "plain"
    mb = _transitions(32, 4, n_actions=2)
    mb["_weights"] = np.random.default_rng(7).uniform(
        0.2, 1, 32).astype(np.float32)
    with jax_reference() as ref:
        if kind == "apex":
            m = ref.rl_apex
            rtr = m.ApexDQNTrainer(m.ApexDQNConfig(num_rollout_workers=1,
                                                   hidden=16))
        else:
            m = ref.rl_dqn
            rtr = m.DQNTrainer(m.DQNConfig(num_rollout_workers=1, hidden=16,
                                           double_q=double, dueling=double))
        target = ref.rl_dqn.init_qnet(jax.random.PRNGKey(5), 4, 2, 16,
                                      double)
        net0, target0 = _np_tree(rtr.net), _np_tree(target)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.net)
        out = jax.jit(rtr._make_update())(rtr.net, target, st, _jnp(mb))
        grads, terms = [_grads(out[1])], {"loss": float(out[2])}
        td = np.asarray(out[3]) if kind == "apex" else None
        params = _np_tree(out[0])
    tstore = []
    if kind == "apex":
        loss = tapex.make_apex_dqn_loss(0.99, True)
    else:
        loss = tdqn.make_dqn_loss(0.99, double)
    upd = tdqn.make_q_update(loss, _RecAdam(1e-3, tstore))
    net, _, tloss, aux = upd(tcore.params_from_jax(net0, "cpu"),
                             tcore.params_from_jax(target0, "cpu"), None,
                             tcore.minibatch_to_device(mb, "cpu"))
    _compare_update(grads, terms, params, tstore, {"loss": tloss}, net)
    if kind == "apex":
        assert_close_scaled(to_np(aux["td"]), td, FWD_TOL, "|td|")


def test_r2d2_update():
    """R2D2's loss through burn-in (no gradient) and the training segment,
    double-Q against a different target net, from stored nonzero states."""
    import jax

    rng = np.random.default_rng(8)
    B, T, burn, H = 5, 6, 3, 8
    L = burn + T
    mb = {"obs": rng.normal(size=(B, L + 1, 4)).astype(np.float32),
          "actions": rng.integers(0, 2, (B, L)).astype(np.int32),
          "rewards": rng.normal(size=(B, L)).astype(np.float32),
          "dones": (rng.random((B, L)) < 0.2).astype(np.float32),
          "h0": rng.normal(size=(B, H)).astype(np.float32),
          "c0": rng.normal(size=(B, H)).astype(np.float32)}
    with jax_reference() as ref:
        m = ref.rl_r2d2
        rtr = m.R2D2Trainer(m.R2D2Config(num_rollout_workers=1, hidden=H,
                                         burn_in=burn, train_len=T))
        target = m.init_rqnet(jax.random.PRNGKey(3), 4, 2, H)
        net0, target0 = _np_tree(rtr.net), _np_tree(target)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.net)
        out = jax.jit(rtr._make_update())(rtr.net, target, st, _jnp(mb))
        grads, terms = [_grads(out[1])], {"loss": float(out[2])}
        params = _np_tree(out[0])
    tstore = []
    upd = tdqn.make_q_update(tr2d2.make_r2d2_loss(burn, T, 0.99),
                             _RecAdam(1e-3, tstore))
    net, _, tloss, _ = upd(tcore.params_from_jax(net0, "cpu"),
                           tcore.params_from_jax(target0, "cpu"), None,
                           tcore.minibatch_to_device(mb, "cpu"))
    _compare_update(grads, terms, params, tstore, {"loss": tloss}, net)


@pytest.mark.parametrize("do_actor", [True, False], ids=["actor", "delay"])
def test_td3_update(do_actor):
    """The twin critics on the smoothed target (the key's normal draw fed
    as `noise`), then the delayed actor step and polyak."""
    import jax

    mb = _transitions(32, 3, act_dim=1)
    key = jax.random.PRNGKey(41)
    with jax_reference() as ref:
        m = ref.rl_td3
        rtr = m.TD3Trainer(m.TD3Config(num_rollout_workers=1, hidden=16))
        target = m.init_td3_nets(jax.random.PRNGKey(9), 3, 1, 16)
        nets0, target0 = _np_tree(rtr.nets), _np_tree(target)
        a_st = _recording(rtr, "actor_opt", rtr.actor_os, rtr.nets["actor"])
        c_st = _recording(rtr, "critic_opt", rtr.critic_os,
                          {"q1": rtr.nets["q1"], "q2": rtr.nets["q2"]})
        out = jax.jit(rtr._make_update(), static_argnames="do_actor")(
            rtr.nets, target, a_st, c_st, _jnp(mb), key, do_actor=do_actor)
        grads = [_grads(out[3])] + ([_grads(out[2])] if do_actor else [])
        terms = _floats(out[4])
        params, tparams = _np_tree(out[0]), _np_tree(out[1])
        noise = torch.from_numpy(np.array(jax.random.normal(key, (32, 1))))
    tstore = []
    a_opt, c_opt = _RecAdam(3e-4, tstore), _RecAdam(3e-4, tstore)
    nets = tcore.params_from_jax(nets0, "cpu")
    tgt = tcore.params_from_jax(target0, "cpu")
    upd = ttd3.make_td3_update(ttd3.TD3Config(), 2.0, a_opt, c_opt)
    nets, tgt, _, _, aux = upd(
        nets, tgt, a_opt.init(nets["actor"]),
        c_opt.init({"q1": nets["q1"], "q2": nets["q2"]}),
        tcore.minibatch_to_device(mb, "cpu"), noise, do_actor)
    _compare_update(grads, terms, params, tstore, aux, nets)
    assert_params_close(tgt, tparams)


@pytest.mark.parametrize("apex", [False, True], ids=["ddpg", "apex_ddpg"])
def test_ddpg_update(apex):
    """DDPG's critic and actor steps and polyak; Ape-X DDPG's critic with
    importance weights and its |TD|."""
    import jax

    mb = _transitions(32, 3, act_dim=1)
    mb["_weights"] = np.random.default_rng(9).uniform(
        0.2, 1, 32).astype(np.float32)
    with jax_reference() as ref:
        if apex:
            m = ref.rl_apex
            rtr = m.ApexDDPGTrainer(m.ApexDDPGConfig(num_rollout_workers=1,
                                                     hidden=16))
        else:
            m = ref.rl_ddpg
            rtr = m.DDPGTrainer(m.DDPGConfig(num_rollout_workers=1,
                                             hidden=16))
        target = ref.rl_ddpg.init_ddpg_nets(jax.random.PRNGKey(9), 3, 1, 16)
        nets0, target0 = _np_tree(rtr.nets), _np_tree(target)
        a_st = _recording(rtr, "actor_opt", rtr.actor_os, rtr.nets["actor"])
        c_st = _recording(rtr, "critic_opt", rtr.critic_os, rtr.nets["q"])
        out = jax.jit(rtr._make_update())(rtr.nets, target, a_st, c_st,
                                          _jnp(mb))
        grads = [_grads(out[3]), _grads(out[2])]
        if apex:
            terms = {"critic_loss": float(out[4])}
            td = np.asarray(out[5])
        else:
            terms = _floats(out[4])
        params, tparams = _np_tree(out[0]), _np_tree(out[1])
    tstore = []
    a_opt, c_opt = _RecAdam(3e-4, tstore), _RecAdam(3e-4, tstore)
    nets = tcore.params_from_jax(nets0, "cpu")
    upd = tddpg.make_ddpg_update(tddpg.DDPGConfig(), 2.0, a_opt, c_opt,
                                 weighted=apex)
    nets, tgt, _, _, closs, aloss, ttd = upd(
        nets, tcore.params_from_jax(target0, "cpu"),
        a_opt.init(nets["actor"]), c_opt.init(nets["q"]),
        tcore.minibatch_to_device(mb, "cpu"))
    _compare_update(grads, terms, params, tstore,
                    {"critic_loss": closs, "actor_loss": aloss}, nets)
    assert_params_close(tgt, tparams)
    if apex:
        assert_close_scaled(to_np(ttd), td, FWD_TOL, "|td|")


def test_sac_update():
    """The twin critics, the actor against the updated critics, the
    temperature, polyak; log-alpha away from 0 and a target apart from
    the critics. The key's two draws fed as the port's noise."""
    import jax

    B = 32
    mb = _transitions(B, 3, act_dim=1)
    key = jax.random.PRNGKey(10007 * 3 + 5)
    with jax_reference() as ref:
        m = ref.rl_sac
        rtr = m.SACTrainer(m.SACConfig(num_rollout_workers=1, hidden=16))
        tq = m.init_sac_nets(jax.random.PRNGKey(4), 3, 1, 16)
        target = {"q1": tq["q1"], "q2": tq["q2"]}
        la = jax.numpy.asarray(-0.3, jax.numpy.float32)
        nets0, target0 = _np_tree(rtr.nets), _np_tree(target)
        a_st = _recording(rtr, "actor_opt", rtr.actor_os, rtr.nets["actor"])
        c_st = _recording(rtr, "critic_opt", rtr.critic_os,
                          {"q1": rtr.nets["q1"], "q2": rtr.nets["q2"]})
        l_st = _recording(rtr, "alpha_opt", rtr.alpha_os, la)
        out = jax.jit(rtr._make_update())(rtr.nets, target, la, a_st, c_st,
                                          l_st, _jnp(mb), key)
        grads = [_grads(out[4]), _grads(out[3]), _grads(out[5])]
        terms = _floats(out[6])
        params, tparams = _np_tree(out[0]), _np_tree(out[1])
        la_after = float(out[2])
    tstore = []
    opts = [_RecAdam(3e-4, tstore) for _ in range(3)]
    a_opt, c_opt, l_opt = opts
    nets = tcore.params_from_jax(nets0, "cpu")
    tla = torch.tensor(-0.3)
    upd = tsac.make_sac_update(tsac.SACConfig(), 2.0, -1.0, a_opt, c_opt,
                               l_opt)
    nets, tgt, tla, _, _, _, aux = upd(
        nets, tcore.params_from_jax(target0, "cpu"), tla,
        a_opt.init(nets["actor"]),
        c_opt.init({"q1": nets["q1"], "q2": nets["q2"]}), l_opt.init(tla),
        tcore.minibatch_to_device(mb, "cpu"), _sac_noise(key, B, 1))
    _compare_update(grads, terms, params, tstore, aux, nets)
    assert_params_close(tgt, tparams)
    assert abs(float(tla) - la_after) <= 1e-6


def _offline_pair(ref, kind, data, **kw):
    """(reference trainer, port trainer on the CPU) of offline algorithm
    `kind` on `data`, the port's weights carried from the reference's."""
    names = {"BC": ("rl_offline", "BCConfig", "BCTrainer"),
             "CQL": ("rl_offline", "CQLConfig", "CQLTrainer"),
             "CRR": ("rl_offline", "CRRConfig", "CRRTrainer"),
             "MARWIL": ("rl_marwil", "MARWILConfig", "MARWILTrainer"),
             "DT": ("rl_dt", "DTConfig", "DTTrainer")}
    mod, c, t = names[kind]
    m = getattr(ref, mod)
    rtr = getattr(m, t)(getattr(m, c)(dataset=data, **kw))
    port = {"rl_offline": toff, "rl_dt": tdt}.get(mod)
    if port is None:
        from ray_tpu_torch.rl import marwil as port
    ttr = getattr(port, t)(getattr(port, c)(dataset=data, device="cpu",
                                            **kw))
    ttr.set_weights(tcore.params_from_jax(_np_tree(rtr.get_weights()),
                                          "cpu"))
    return rtr, ttr


@pytest.mark.parametrize("discrete", [True, False],
                         ids=["discrete", "continuous"])
def test_bc_update(discrete):
    import jax

    data = _transitions(64, 4, **({"n_actions": 3} if discrete
                                  else {"act_dim": 2}))
    if discrete:
        data["actions"] = data["actions"].astype(np.int64)
    mb = {k: data[k][:24] for k in ("obs", "actions")}
    with jax_reference() as ref:
        rtr, ttr = _offline_pair(ref, "BC", {k: data[k] for k in mb},
                                 discrete=discrete, hidden=16)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.params)
        out = jax.jit(rtr._make_update())(rtr.params, st, _jnp(mb))
        grads, terms = [_grads(out[1])], _floats(out[2])
        params = _np_tree(out[0])
    tstore = []
    ttr.opt = _RecAdam(1e-3, tstore)
    tp, _, aux = ttr._update(ttr.params, ttr.opt_state,
                             tcore.minibatch_to_device(mb, "cpu"))
    _compare_update(grads, terms, params, tstore, aux, tp)


def test_cql_update():
    """CQL's critics (Bellman + the logsumexp penalty over uniform and
    frozen-policy actions, one batched forward), then the actor; N = 3
    sampled actions, act_high 2, the key's five draws fed as noise."""
    import jax

    data = _transitions(64, 3, act_dim=1)
    B, N = 16, 3
    mb = {k: v[:B] for k, v in data.items()}
    key = jax.random.PRNGKey(31337 + 2)
    with jax_reference() as ref:
        rtr, ttr = _offline_pair(ref, "CQL", data, act_high=2.0, hidden=16,
                                 train_batch_size=B, cql_n_actions=N)
        tq = ref.rl_sac.init_sac_nets(jax.random.PRNGKey(4), 3, 1, 16)
        target = {"q1": tq["q1"], "q2": tq["q2"]}
        target0 = _np_tree(target)
        c_st = _recording(rtr, "critic_opt", rtr.critic_os,
                          {"q1": rtr.nets["q1"], "q2": rtr.nets["q2"]})
        a_st = _recording(rtr, "actor_opt", rtr.actor_os, rtr.nets["actor"])
        out = jax.jit(rtr._make_update())(rtr.nets, target, c_st, a_st,
                                          _jnp(mb), key)
        grads, terms = [_grads(out[2]), _grads(out[3])], _floats(out[4])
        params, tparams = _np_tree(out[0]), _np_tree(out[1])
    tstore = []
    c_opt, a_opt = _RecAdam(3e-4, tstore), _RecAdam(3e-4, tstore)
    upd = toff.make_cql_update(ttr.config, c_opt, a_opt)
    nets, tgt, _, _, aux = upd(
        ttr.nets, tcore.params_from_jax(target0, "cpu"), ttr.critic_os,
        ttr.actor_os, tcore.minibatch_to_device(mb, "cpu"),
        _cql_noise(key, B, 1, N, 2.0))
    _compare_update(grads, terms, params, tstore, aux, nets)
    assert_params_close(tgt, tparams)


@pytest.mark.parametrize("mode", ["binary", "exp"])
def test_crr_update(mode):
    import jax

    data = _transitions(64, 4, n_actions=3)
    data["actions"] = data["actions"].astype(np.int64)
    mb = {k: v[:32] for k, v in data.items()}
    with jax_reference() as ref:
        rtr, ttr = _offline_pair(ref, "CRR", data, weight_mode=mode,
                                 hidden=16)
        target = ref.rl_core.mlp_init(jax.random.PRNGKey(7),
                                      [4, 16, 16, 3], out_scale=0.5)
        target0 = _np_tree(target)
        st = _recording(rtr, "opt", rtr.opt_state, rtr.nets)
        out = jax.jit(rtr._make_update())(rtr.nets, target, st, _jnp(mb))
        grads, terms = [_grads(out[1])], _floats(out[2])
        params = _np_tree(out[0])
    tstore = []
    upd = tdqn.make_q_update(toff.make_crr_loss(ttr.config),
                             _RecAdam(1e-3, tstore))
    nets, _, loss, aux = upd(ttr.nets, tcore.params_from_jax(target0, "cpu"),
                             None, tcore.minibatch_to_device(mb, "cpu"))
    _compare_update(grads, terms, params, tstore, {"loss": loss, **aux},
                    nets)


@pytest.mark.parametrize("discrete", [True, False],
                         ids=["discrete", "continuous"])
def test_marwil_update(discrete):
    import jax

    data = _transitions(64, 4, **({"n_actions": 3} if discrete
                                  else {"act_dim": 2}))
    if discrete:
        data["actions"] = data["actions"].astype(np.int64)
    data = {k: data[k] for k in ("obs", "actions", "rewards", "dones")}
    with jax_reference() as ref:
        rtr, ttr = _offline_pair(ref, "MARWIL", data, discrete=discrete,
                                 hidden=16)
        np.testing.assert_array_equal(ttr.data["returns"],
                                      rtr.data["returns"])
        mb = {k: v[:32] for k, v in rtr.data.items()}
        st = _recording(rtr, "opt", rtr.opt_state, rtr.params)
        out = jax.jit(rtr._make_update())(rtr.params, st, _jnp(mb), 0.7)
        grads, terms = [_grads(out[1])], _floats(out[2])
        params = _np_tree(out[0])
    tstore = []
    ttr.opt = _RecAdam(1e-3, tstore)
    tp, _, aux = ttr._update(ttr.params, ttr.opt_state,
                             tcore.minibatch_to_device(mb, "cpu"), 0.7)
    _compare_update(grads, terms, params, tstore, aux, tp)


def _assert_dt_params_close(port, ref, lr, steps):
    """``assert_params_close`` on a DT model but for the key third of each
    block's qkv bias. Its gradient is zero in exact arithmetic (a constant
    added to every key's score leaves the softmax as it was); at rounding
    level, Adam moves an element by lr |g| / (|g| + eps) a step, of either
    sign, so those elements are held to 2 lr a step."""
    port = tcore.tree_map(lambda t: t.detach().clone(), port)
    ref = _np_tree(ref)
    for pb, rb in zip(port["blocks"], ref["blocks"]):
        d = rb["qkv"]["b"].shape[0] // 3
        kp, kr = pb["qkv"]["b"][d:2 * d], rb["qkv"]["b"][d:2 * d]
        assert np.abs(kp.numpy() - kr).max() <= 2 * lr * steps
        kp.copy_(torch.from_numpy(kr))
    assert_params_close(port, ref)


def test_dt_update():
    import jax

    rng = np.random.default_rng(12)
    eps = [{"obs": rng.normal(size=(T, 3)).astype(np.float32),
            "actions": rng.integers(0, 2, T),
            "rewards": rng.normal(size=T).astype(np.float32)}
           for T in (5, 9, 3, 7)]
    with jax_reference() as ref:
        rtr, ttr = _offline_pair(ref, "DT", eps, context_len=4, d_model=16,
                                 n_layers=2)
        windows = rtr._sample_windows(6)
        np.testing.assert_array_equal(ttr._sample_windows(6)[1], windows[1])
        st = _recording(rtr, "opt", rtr.opt_state, rtr.model)
        out = jax.jit(rtr._make_update())(rtr.model, st,
                                          *map(jax.numpy.asarray, windows))
        grads = [_grads(out[1])]
        terms = {"loss": float(out[2]), "acc": float(out[3])}
        params = _np_tree(out[0])
    tstore = []
    ttr.opt = _RecAdam(1e-3, tstore)
    rtg, obs, acts, mask = windows
    tm, _, loss, acc = ttr._update(
        ttr.model, ttr.opt_state, torch.from_numpy(rtg),
        torch.from_numpy(obs), torch.from_numpy(acts).long(),
        torch.from_numpy(mask))
    _assert_terms({"loss": loss, "acc": acc}, terms)
    _assert_grads(tstore, grads)
    _assert_dt_params_close(tm, params, 1e-3, 1)


def test_prioritized_replay_buffer():
    """The same adds, samples and priority updates through both buffers
    from one seed: indices, weights, rows and priorities equal."""
    rng = np.random.default_rng(13)
    with jax_reference() as ref:
        rb = ref.rl_apex.PrioritizedReplayBuffer(40, alpha=0.6, seed=3)
        tb = tapex.PrioritizedReplayBuffer(40, alpha=0.6, seed=3)
        for step in range(6):
            batch = {"obs": rng.normal(size=(15, 2)).astype(np.float32),
                     "a": rng.integers(0, 3, 15)}
            rb.add_batch(batch)
            tb.add_batch(batch)
            rs, ts = rb.sample(8, beta=0.4), tb.sample(8, beta=0.4)
            assert set(rs) == set(ts)
            for k in rs:
                np.testing.assert_array_equal(ts[k], rs[k], err_msg=k)
            prios = rng.uniform(0, 5, 8)
            rb.update_priorities(rs["_indices"], prios)
            tb.update_priorities(ts["_indices"], prios)
            np.testing.assert_array_equal(tb._prio, rb._prio)
            assert tb._max_prio == rb._max_prio


# --- one train() of each trainer ---------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(
        num_cpus=8, ignore_reinit_error=True,
        _system_config={"health_check_period_s": 0.2,
                        "worker_idle_timeout_s": 60.0})
    yield info
    ray_tpu_torch.shutdown()


def _fifo_wait(refs, *, num_returns=1, timeout=None):
    """``ray_tpu_torch.wait`` in dispatch order (the reference stub's)."""
    ready = list(refs[:num_returns])
    ray_tpu_torch.get(ready)
    return ready, list(refs[num_returns:])


def _recorder(obj, name, args, store):
    """Wrap ``obj.name`` so that each call's positional arguments at
    `args` are kept as numpy copies before the call."""
    fn = getattr(obj, name)

    def as_np(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy().copy()
        if isinstance(x, dict):
            return {k: as_np(v) for k, v in x.items()}
        return np.array(x)

    def wrapped(*a, **kw):
        store.append([as_np(a[i]) for i in args])
        return fn(*a, **kw)

    setattr(obj, name, wrapped)


def _cartpole_data(n=200, seed=0):
    """Random-policy transitions of the numpy CartPole (offline data)."""
    import chip_smoke

    env = chip_smoke.CartPole()
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in ("obs", "actions", "rewards", "dones",
                            "next_obs")}
    obs, _ = env.reset(seed=seed)
    for _ in range(n):
        a = int(rng.integers(2))
        nobs, rew, term, trunc, _ = env.step(a)
        for k, v in zip(rows, (obs, a, rew, float(term), nobs)):
            rows[k].append(v)
        obs = env.reset()[0] if term or trunc else nobs
    return {"obs": np.stack(rows["obs"]).astype(np.float32),
            "actions": np.asarray(rows["actions"], np.int64),
            "rewards": np.asarray(rows["rewards"], np.float32),
            "dones": np.asarray(rows["dones"], np.float32),
            "next_obs": np.stack(rows["next_obs"]).astype(np.float32)}


def _pendulum_data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    act = np.clip(obs[:, :1] * 0.5 + rng.normal(scale=0.1, size=(n, 1)),
                  -2, 2).astype(np.float32)
    return {"obs": obs, "actions": act,
            "rewards": -np.square(obs[:, 0]).astype(np.float32),
            "dones": (rng.random(n) < 0.05).astype(np.float32),
            "next_obs": (obs + 0.1).astype(np.float32)}


CART = {"env": "chip_smoke:CartPole", "env_config": {"action_seed": 7}}
PEND = {"env": "chip_smoke:Pendulum", "env_config": {"action_seed": 7}}
SMALL = {"hidden": 16, "train_batch_size": 16}

# name: (reference module, its config's kwargs (learning after one
# iteration's sampling), the recorded learner method and the argument
# indices of what it is given (reference, port), the learner steps of one
# train(), the params attribute)
TRAINERS = {
    "DQN": ("rl_dqn", dict(CART, **SMALL, num_rollout_workers=2,
                           rollout_fragment_length=40, learning_starts=80,
                           updates_per_iter=4, epsilon_initial=0.5),
            ("_update", [3], [3]), 4, "net"),
    "SimpleQ": ("rl_simple_q", dict(CART, **SMALL, num_rollout_workers=2,
                                    rollout_fragment_length=40,
                                    learning_starts=80, updates_per_iter=4,
                                    epsilon_initial=0.5),
                ("_update", [3], [3]), 4, "net"),
    "R2D2": ("rl_r2d2", dict(CART, hidden=8, num_rollout_workers=2,
                             seqs_per_worker=2, burn_in=2, train_len=4,
                             learning_starts=4, train_batch_size=4,
                             updates_per_iter=2, epsilon_initial=0.5),
             ("_update", [3], [3]), 2, "net"),
    "TD3": ("rl_td3", dict(PEND, **SMALL, rollout_fragment_length=40,
                           learning_starts=40, updates_per_iter=4),
            ("_update", [4], [4]), 4, "nets"),
    "DDPG": ("rl_ddpg", dict(PEND, **SMALL, rollout_fragment_length=40,
                             learning_starts=40, updates_per_iter=4),
             ("_update", [4], [4]), 4, "nets"),
    "SAC": ("rl_sac", dict(PEND, **SMALL, rollout_fragment_length=40,
                           learning_starts=40, updates_per_iter=4),
            ("_update", [6], [6]), 4, "nets"),
    "ApexDQN": ("rl_apex", dict(CART, **SMALL, num_rollout_workers=2,
                                rollout_fragment_length=30,
                                learning_starts=30, updates_per_iter=4),
                ("_update", [3], [3]), 4, "net"),
    "ApexDDPG": ("rl_apex", dict(PEND, **SMALL, num_rollout_workers=2,
                                 rollout_fragment_length=30,
                                 learning_starts=30, updates_per_iter=4),
                 ("_update", [4], [4]), 4, "nets"),
    "RandomAgent": ("rl_simple_q", dict(CART, num_rollout_workers=2,
                                        rollout_fragment_length=50),
                    None, 0, None),
    "BC": ("rl_offline", dict(hidden=16, train_batch_size=32,
                              updates_per_iter=4),
           ("_update", [2], [2]), 4, "params"),
    "CQL": ("rl_offline", dict(hidden=16, train_batch_size=16,
                               updates_per_iter=3, act_high=2.0),
            ("_update", [4], [4]), 3, "nets"),
    "CRR": ("rl_offline", dict(hidden=16, train_batch_size=32,
                               updates_per_iter=4, target_update_freq=2),
            ("_update", [3], [3]), 4, "nets"),
    "MARWIL": ("rl_marwil", dict(hidden=16, train_batch_size=32,
                                 updates_per_iter=4),
               ("_update", [2, 3], [2, 3]), 4, "params"),
    "DT": ("rl_dt", dict(context_len=4, d_model=16, n_layers=1,
                         train_batch_size=8, updates_per_iter=3),
           ("_update", [2, 3, 4, 5], [2, 3, 4, 5]), 3, "model"),
    "ES": ("rl_es", dict(env="CartPole-v1", num_rollout_workers=2,
                         episodes_per_iter=4, max_episode_steps=30,
                         hidden=8), None, 0, "flat"),
    "ARS": ("rl_es", dict(env="CartPole-v1", num_rollout_workers=2,
                          num_directions=4, top_directions=2,
                          max_episode_steps=30, hidden=8), None, 0, "flat"),
    "BanditLinUCB": ("rl_bandit", dict(steps_per_iter=60, seed=1), None, 0,
                     None),
    "BanditLinTS": ("rl_bandit", dict(steps_per_iter=60, seed=2), None, 0,
                    None),
}
_OFFLINE_DATA = {"BC": lambda: {k: v for k, v in _cartpole_data().items()
                                if k in ("obs", "actions")},
                 "CRR": _cartpole_data,
                 "MARWIL": lambda: {k: v for k, v in _cartpole_data().items()
                                    if k != "next_obs"},
                 "DT": _cartpole_data,
                 "CQL": _pendulum_data}
_ENV_DATA = ("obs", "actions", "rewards", "dones", "next_obs", "returns")


def _patch_noise(name, tr):
    """Feed the port trainer the reference's update draws."""
    import jax

    if name == "TD3":
        tr._noise = lambda u, shape: torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(tr.iteration * 99991 + u),
                              tuple(shape))))
    elif name == "SAC":
        tr._noise = lambda u, batch: _sac_noise(
            jax.random.PRNGKey(tr.iteration * 10007 + u), batch, tr.act_dim)
    elif name == "CQL":
        cfg = tr.config
        tr._noise = lambda u: _cql_noise(
            jax.random.PRNGKey(tr.iteration * 31337 + u), tr.batch_size,
            tr.act_dim, cfg.cql_n_actions, cfg.act_high)


def _compare_steps(name, seen, rseen):
    for step, (got, want) in enumerate(zip(seen, rseen)):
        for j, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, dict):
                assert set(g) == set(w), (step, set(g), set(w))
                for k in w:
                    if k in _ENV_DATA:
                        np.testing.assert_array_equal(
                            g[k], np.asarray(w[k], g[k].dtype),
                            err_msg=f"{name} step {step} {k}")
                    else:   # R2D2's stored LSTM states; Ape-X's weights,
                        # from priorities the learners' |TD| set
                        assert_close_scaled(g[k], w[k], FWD_TOL,
                                            f"{name} step {step} {k}")
            elif np.ndim(w) == 0:   # MARWIL's advantage scale c
                assert abs(float(g) - float(w)) <= 1e-6 * max(
                    abs(float(w)), 1.0), (name, step)
            else:                   # DT's windows
                np.testing.assert_array_equal(
                    np.asarray(g), np.asarray(w).astype(np.asarray(g).dtype),
                    err_msg=f"{name} step {step} arg {j}")


@pytest.mark.parametrize("name", list(TRAINERS))
def test_train_iteration(cluster, monkeypatch, name):
    """One train() of the port's trainer against the reference's, from the
    reference's init."""
    from ray_tpu_torch.rl import get_algorithm

    mod, kw, rec, n_steps, attr = TRAINERS[name]
    kw = dict(kw)
    if name in _OFFLINE_DATA:
        kw["dataset"] = _OFFLINE_DATA[name]()
    learner = rec is not None
    with jax_reference() as ref:
        m = getattr(ref, mod)
        cfg_cls, tr_cls = _ref_classes(m, name)
        rtr = tr_cls(cfg_cls(**kw))
        w0 = _np_tree(rtr.get_weights()) if attr else None
        rseen = []
        if learner:
            _recorder(rtr, rec[0], rec[1], rseen)
        rres = rtr.train()
        rw = _np_tree(getattr(rtr, attr)) if attr else None
        rarms = ([(a.A_inv.copy(), a.b.copy()) for a in rtr.arms]
                 if name.startswith("Bandit") else None)
    pcfg, ptr = get_algorithm(name)
    if learner:
        kw["device"] = "cpu"
    monkeypatch.setattr(ray_tpu_torch, "wait", _fifo_wait)
    tr = ptr(pcfg(**kw))
    try:
        if learner:
            tr.set_weights(tcore.params_from_jax(w0, "cpu"))
            if name == "R2D2":      # its set_weights keeps the target
                tr.target = tcore.clone_tree(tr.net)
            _patch_noise(name, tr)
        elif attr:
            tr.set_weights(w0)
        seen = []
        if learner:
            _recorder(tr, rec[0], rec[2], seen)
        res = tr.train()
    finally:
        tr.stop()
    for k in ("timesteps_total", "episodes_total", "num_samples",
              "num_episodes"):
        if k in rres:
            assert res[k] == rres[k], (k, res[k], rres[k])
    if not learner:
        if attr:
            np.testing.assert_array_equal(tr.get_weights(), rw)
        if rarms is not None:
            for (ta, tb), arm in zip(rarms, tr.arms):
                np.testing.assert_array_equal(arm.A_inv, ta)
                np.testing.assert_array_equal(arm.b, tb)
        for k, v in rres.items():
            if k not in ("time_this_iter_s",):
                assert res[k] == v, (k, res[k], v)
        return
    assert len(seen) == len(rseen) == n_steps, (len(seen), len(rseen))
    _compare_steps(name, seen, rseen)
    if name == "DT":
        _assert_dt_params_close(tr.model, rw, tr.config.lr, n_steps)
    else:
        assert_params_close(getattr(tr, attr), rw)


def _ref_classes(m, name):
    names = {"BanditLinUCB": ("BanditConfig", "LinUCBTrainer"),
             "BanditLinTS": ("BanditConfig", "LinTSTrainer"),
             "RandomAgent": ("RandomAgentConfig", "RandomAgentTrainer"),
             "SimpleQ": ("SimpleQConfig", "SimpleQTrainer"),
             "ApexDQN": ("ApexDQNConfig", "ApexDQNTrainer"),
             "ApexDDPG": ("ApexDDPGConfig", "ApexDDPGTrainer"),
             "ES": ("ESConfig", "ESTrainer"), "ARS": ("ARSConfig",
                                                      "ARSTrainer"),
             "MARWIL": ("MARWILConfig", "MARWILTrainer")}
    c, t = names.get(name, (f"{name}Config", f"{name}Trainer"))
    return getattr(m, c), getattr(m, t)
