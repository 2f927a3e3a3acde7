"""The RL layer (ray_tpu_torch/rl/) against the JAX reference (ray_tpu/rl/)
on the CPU, in f32. The reference loads through test_torch_support's stub
packages, with a local-mode ``remote``/``get``/``kill``, so its trainers
run wholly in this process; weights cross with ``rl.core.params_from_jax``
(conv weights HWIO -> OIHW).

Function level:
- ``policy_forward`` (MLP and CNN) and ``vision_forward`` at 84x84x4 and
  42x42x2, with the gradients of a loss through the CNN: within FWD_TOL /
  GRAD_TOL of each output's / leaf's largest element (f32, the same
  products summed in another order);
- ``make_ppo_loss``'s value, aux and gradients (MLP and CNN): the same;
- ``compute_gae`` (numpy in both), each connector and ``PixelCatcher`` (its
  frames, rewards and ends for a seed, through ``atari_connectors`` too):
  bit for bit;
- IMPALA's V-trace (a reverse loop here, ``lax.scan`` there, the same f32
  operations in the same order): within VTRACE_TOL;
- ``Learner.update`` with and without ``grad_clip`` (clipping and not),
  3 Adam steps: losses within LOSS_RTOL, params within PARAM_TOL.

Trainer level: one ``PPOTrainer.train()`` iteration on CartPole and on
``PixelCatcher`` with a small CNN (42x42, stack 2): the port's trainer
over the port's runtime (rollout actors in worker processes) against the
reference's in-process trainer, from the same carried params: the
fragments' observations and actions equal, their logp within FWD_TOL, the
params after the epochs within PARAM_MAX.
"""

import inspect

import numpy as np
import pytest
import torch

from test_torch_support import jax_reference, to_np
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch.rl import connectors as tconn
from ray_tpu_torch.rl import core as tcore
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import pixel_env as tpix
from ray_tpu_torch.rl import ppo as tppo
from ray_tpu_torch.rl import vision as tvision

# f32, the same products summed in another order (conv windows of up to
# 576 and dense rows of up to 3136): each element within 1e-5 of the
# output's largest, each gradient within 1e-4 of its leaf's largest
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
# V-trace: 100 steps of acc = delta + dc * acc in f32 in both; XLA may
# fuse a multiply-add where torch rounds twice
VTRACE_TOL = 1e-6
# Learner.update: 3 Adam steps of a 4-element regression
PARAM_TOL = 1e-5
# The params after one trainer-level train(): every element within
# PARAM_MAX of the reference's. Adam's first steps are about lr * sign(g),
# so an element whose gradient is at rounding level could move by up to
# 2 lr; none does in these cases. PARAM_MAX is ~5x the largest deviation
# measured over the trainer-level cases here and in
# test_torch_rl_zoo_parity.py (9.2e-7, PG's one Adam step; 3e-8 to 3.3e-7
# in the others).
PARAM_MAX = 5e-6
LR = 3e-4


def ref_layout(tree):
    """A port param tree as numpy in the reference's layout (OIHW conv
    weights back to HWIO)."""
    def one(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return tcore.tree_map(one, tree)


def leaves_np(tree):
    return [np.asarray(x, np.float64) for x in tcore.tree_leaves(tree)]


def assert_close_scaled(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err, tol)


def assert_params_close(port_params, ref_params):
    got, want = leaves_np(ref_layout(port_params)), leaves_np(ref_params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        d = np.abs(g - w).max()
        assert d <= PARAM_MAX, (i, d)


class _Cfg:
    hidden = 32
    cnn_hidden = 64
    network = "auto"


def _ref_policy(ref, obs_shape, n_actions, seed=0):
    import jax

    return ref.rl_ppo.init_any_policy(jax.random.PRNGKey(seed), obs_shape,
                                      n_actions, _Cfg)


def _obs(shape, n, seed=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (n,) + tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("obs_shape", [(6,), (42, 42, 2)],
                         ids=["mlp", "cnn"])
def test_policy_forward(obs_shape):
    with jax_reference() as ref:
        rp = _ref_policy(ref, obs_shape, 3)
        obs = _obs(obs_shape, 5)
        rl, rv = ref.rl_ppo.policy_forward(rp, obs)
        rl, rv = np.asarray(rl), np.asarray(rv)
    tp = tcore.params_from_jax(rp, "cpu")
    assert ("conv" in tp) == (len(obs_shape) == 3)
    tl, tv = tppo.policy_forward(tp, torch.from_numpy(obs))
    assert_close_scaled(to_np(tl), rl, FWD_TOL, "logits")
    assert_close_scaled(to_np(tv), rv, FWD_TOL, "value")


@pytest.mark.parametrize("obs_shape", [(84, 84, 4), (42, 42, 2)],
                         ids=["84x84x4", "42x42x2"])
def test_vision_forward_and_grads(obs_shape):
    """The Nature CNN at the pixel path's input and the small one, with the
    gradients of the reference test's loss (mean logits^2 + value^2)."""
    import jax

    with jax_reference() as ref:
        rp = ref.rl_vision.init_vision_policy(jax.random.PRNGKey(0),
                                              obs_shape, 6)
        obs = _obs(obs_shape, 4)
        rl, rv = ref.rl_vision.vision_forward(rp, obs)

        def loss(p):
            lg, v = ref.rl_vision.vision_forward(p, obs)
            return (lg ** 2).mean() + (v ** 2).mean()

        rg = jax.grad(loss)(rp)
        rl, rv, rg = np.asarray(rl), np.asarray(rv), \
            jax.tree_util.tree_map(np.asarray, rg)
    tp = tcore.params_from_jax(rp, "cpu")
    assert tuple(tp["conv"][0]["w"].shape) == (32, obs_shape[2], 8, 8)
    x = torch.from_numpy(obs)
    tl, tv = tvision.vision_forward(tp, x)
    assert_close_scaled(to_np(tl), rl, FWD_TOL, "logits")
    assert_close_scaled(to_np(tv), rv, FWD_TOL, "value")

    def tloss(p, _):
        lg, v = tvision.vision_forward(p, x)
        return (lg ** 2).mean() + (v ** 2).mean(), {}

    _, grads = tcore.value_and_grad(tloss, tp, None)
    got = leaves_np(ref_layout(tcore.tree_unflatten_like(tp, grads)))
    for i, (g, w) in enumerate(zip(got, leaves_np(rg))):
        assert_close_scaled(g, w, GRAD_TOL, f"grad leaf {i}")


@pytest.mark.parametrize("obs_shape", [(6,), (42, 42, 2)],
                         ids=["mlp", "cnn"])
def test_ppo_loss_value_and_grads(obs_shape):
    import jax

    n = 16
    rng = np.random.default_rng(3)
    mb = {"obs": _obs(obs_shape, n), "actions": rng.integers(
        0, 3, n).astype(np.int32),
        "logp": np.log(rng.uniform(0.2, 0.5, n)).astype(np.float32),
        "adv": rng.standard_normal(n).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32)}
    with jax_reference() as ref:
        rp = _ref_policy(ref, obs_shape, 3)
        # scale the pi head so some ratios leave [0.8, 1.2] (both clip arms)
        rp["pi"]["w"] = rp["pi"]["w"] * 30.0
        loss_fn = ref.rl_ppo.make_ppo_loss(0.2, 0.5, 0.01)
        (rt, raux), rg = jax.value_and_grad(loss_fn, has_aux=True)(rp, mb)
        rt, raux = float(rt), {k: float(v) for k, v in raux.items()}
        rg = jax.tree_util.tree_map(np.asarray, rg)
    tp = tcore.params_from_jax(rp, "cpu")
    (tt, taux), grads = tcore.value_and_grad(
        tppo.make_ppo_loss(0.2, 0.5, 0.01), tp,
        tppo.batch_to_device(mb, "cpu"))
    assert abs(float(tt) - rt) <= LOSS_RTOL * max(abs(rt), 1.0)
    for k, v in raux.items():
        assert abs(float(taux[k]) - v) <= LOSS_RTOL * max(abs(v), 1.0), k
    got = leaves_np(ref_layout(tcore.tree_unflatten_like(tp, grads)))
    for i, (g, w) in enumerate(zip(got, leaves_np(rg))):
        assert_close_scaled(g, w, GRAD_TOL, f"grad leaf {i}")


def test_compute_gae_bit_exact():
    rng = np.random.default_rng(4)
    T = 200
    b = {"rewards": rng.standard_normal(T).astype(np.float32),
         "dones": rng.random(T) < 0.05,
         "values": rng.standard_normal(T).astype(np.float32),
         "last_value": 0.37}
    with jax_reference() as ref:
        ra, rr = ref.rl_ppo.compute_gae(b, 0.99, 0.95)
        rtg = ref.rl_core.reward_to_go(b, 0.99)
    ta, tr = tppo.compute_gae(b, 0.99, 0.95)
    np.testing.assert_array_equal(ta, ra)
    np.testing.assert_array_equal(tr, rr)
    np.testing.assert_array_equal(tcore.reward_to_go(b, 0.99), rtg)


CONNECTORS = {
    "flatten": lambda m: m.FlattenObs(),
    "clip": lambda m: m.ClipObs(-0.5, 0.7),
    "normalize": lambda m: m.NormalizeObs(),
    "grayscale": lambda m: m.GrayscaleObs(),
    "resize_divisible": lambda m: m.ResizeObs(21, 21),
    "resize_nearest": lambda m: m.ResizeObs(16, 13),
    "scale": lambda m: m.ScaleObs(1 / 255.0),
    "frame_stack": lambda m: m.FrameStack(3),
    "pipeline": lambda m: m.build_pipeline(
        [m.GrayscaleObs, lambda: m.ResizeObs(21, 21), m.NormalizeObs,
         lambda: m.FrameStack(2)]),
}


@pytest.mark.parametrize("name", list(CONNECTORS))
def test_connector_bit_exact(name):
    """Each connector over a stream of 12 RGB frames with an episode start
    in the middle: every output and the reported state bit for bit, and
    the merge of two workers' states."""
    frames = np.random.default_rng(5).uniform(
        -1, 300, (12, 42, 42, 3)).astype(np.float32)
    with jax_reference() as ref:
        m = ref.rl_connectors
        rc, rc2 = CONNECTORS[name](m), CONNECTORS[name](m)
        rout = []
        for i, f in enumerate(frames):
            if i == 6:
                rc.on_episode_start()
            rout.append(rc(f))
            rc2(f[::-1])
        rstate = rc.get_state()
        rmerged = (rc.merge_pipeline_states([rstate, rc2.get_state()])
                   if name == "pipeline" else
                   type(rc).merge_states([rstate, rc2.get_state()]))
    tc, tc2 = CONNECTORS[name](tconn), CONNECTORS[name](tconn)
    for i, f in enumerate(frames):
        if i == 6:
            tc.on_episode_start()
        out = tc(f)
        tc2(f[::-1])
        assert out.dtype == rout[i].dtype
        np.testing.assert_array_equal(out, rout[i])
    tmerged = (tc.merge_pipeline_states([tc.get_state(), tc2.get_state()])
               if name == "pipeline" else
               type(tc).merge_states([tc.get_state(), tc2.get_state()]))
    for got, want in ((tc.get_state(), rstate), (tmerged, rmerged)):
        assert repr(got) == repr(want)


@pytest.mark.parametrize("env_config", [
    {"balls_per_episode": 3},
    {"size": 42, "dense_reward": True, "balls_per_episode": 2}],
    ids=["84", "42-dense"])
def test_pixel_catcher_bit_exact(env_config):
    """300 steps of seeded actions through both envs and both
    atari_connectors pipelines: frames, rewards, ends and connected
    observations bit for bit (resets at episode ends)."""
    acts = np.random.default_rng(6).integers(0, 3, 300)
    with jax_reference() as ref:
        renv = ref.rl_pixel_env.PixelCatcher(seed=7, **env_config)
        rpipe = ref.rl_connectors.build_pipeline(
            ref.rl_pixel_env.atari_connectors(stack=4, out_size=42))
        rtrace = [renv.reset(seed=7)[0]]
        rconn = [rpipe(rtrace[0])]
        for a in acts:
            obs, r, term, trunc, _ = renv.step(a)
            rtrace.append((obs, r, term, trunc))
            if term:
                rpipe.on_episode_start()
                obs, _ = renv.reset()
                rtrace.append(obs)
            rconn.append(rpipe(obs))
    env = tpix.PixelCatcher(seed=7, **env_config)
    assert env.observation_space.shape == renv.observation_space.shape
    assert env.observation_space.dtype == renv.observation_space.dtype
    assert env.action_space.n == renv.action_space.n
    pipe = tconn.build_pipeline(tpix.atari_connectors(stack=4, out_size=42))
    trace = [env.reset(seed=7)[0]]
    conn = [pipe(trace[0])]
    ends = 0
    for a in acts:
        obs, r, term, trunc, _ = env.step(a)
        trace.append((obs, r, term, trunc))
        if term:
            ends += 1
            pipe.on_episode_start()
            obs, _ = env.reset()
            trace.append(obs)
        conn.append(pipe(obs))
    assert ends >= 2 and len(trace) == len(rtrace)
    for got, want in zip(trace, rtrace):
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        else:
            np.testing.assert_array_equal(got, want)
    for got, want in zip(conn, rconn):
        np.testing.assert_array_equal(got, want)


def _ref_vtrace(ref, cfg):
    """The reference's V-trace: a closure inside ImpalaTrainer's update
    (built without the trainer's workers)."""
    t = object.__new__(ref.rl_impala.ImpalaTrainer)
    t.config = cfg
    update = t._make_update()
    loss_fn = inspect.getclosurevars(update).nonlocals["loss_fn"]
    return inspect.getclosurevars(loss_fn).nonlocals["vtrace"]


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace(clips):
    import jax.numpy as jnp

    T = 100
    rng = np.random.default_rng(8)
    values = rng.standard_normal(T).astype(np.float32)
    rewards = rng.standard_normal(T).astype(np.float32)
    dones = (rng.random(T) < 0.05).astype(np.float32)
    rhos = rng.uniform(0.4, 1.8, T).astype(np.float32)
    last = np.float32(0.3)
    with jax_reference() as ref:
        cfg = ref.rl_impala.ImpalaConfig(vtrace_rho_clip=clips[0],
                                         vtrace_c_clip=clips[1])
        vt = _ref_vtrace(ref, cfg)
        rvs, radv = vt(jnp.asarray(values), jnp.asarray(rewards),
                       jnp.asarray(dones), jnp.asarray(rhos),
                       jnp.asarray(last))
        rvs, radv = np.asarray(rvs), np.asarray(radv)
    tvs, tadv = timpala.vtrace(
        *(torch.from_numpy(x) for x in (values, rewards, dones, rhos)),
        torch.tensor(last), gamma=cfg.gamma, rho_clip=clips[0],
        c_clip=clips[1])
    assert_close_scaled(to_np(tvs), rvs, VTRACE_TOL, "vs")
    assert_close_scaled(to_np(tadv), radv, VTRACE_TOL, "pg_adv")


@pytest.mark.parametrize("grad_clip", [None, 0.5, 1e3],
                         ids=["no-clip", "clipping", "under-clip"])
def test_learner_update(grad_clip):
    """3 Adam steps of a linear regression through ``Learner.update``: the
    losses and the params after each step. At 0.5 optax's clip rescales
    every step's gradient; at 1e3 it leaves them."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    batch = {"x": x, "y": x @ np.asarray([1.0, -2.0, 0.5, 0.0], np.float32)}

    def tinit(gen):
        return {"w": torch.randn((4, 1), generator=gen)}

    def tloss(params, b):
        return torch.square((b["x"] @ params["w"])[:, 0] - b["y"]).mean()

    with jax_reference() as ref:
        import jax
        import jax.numpy as jnp

        def rinit(key):
            return {"w": jax.random.normal(key, (4, 1))}

        def rloss(params, b):
            return jnp.square((b["x"] @ params["w"])[:, 0] - b["y"]).mean()

        rl = ref.rl_learner.Learner(ref.rl_learner.LearnerSpec(
            init_fn=rinit, loss_fn=rloss, lr=0.1, grad_clip=grad_clip))
        w0 = rl.get_weights()
        rsteps = []
        for _ in range(3):
            loss = rl.update(batch)
            rsteps.append((loss, np.asarray(rl.get_weights()["w"])))
    tl = tlearner.Learner(tlearner.LearnerSpec(
        init_fn=tinit, loss_fn=tloss, lr=0.1, grad_clip=grad_clip,
        device="cpu"))
    tl.set_weights(tcore.params_from_jax(w0, "cpu"))
    for loss, w in rsteps:
        got = tl.update(batch)
        assert abs(got - loss) <= LOSS_RTOL * abs(loss), (got, loss)
        np.testing.assert_allclose(to_np(tl.get_weights()["w"]), w,
                                   rtol=0, atol=PARAM_TOL)


def _trainer_case(case, pkg):
    """PPOConfig kwargs of a trainer-level case for the package `pkg`
    ("ray_tpu" or "ray_tpu_torch")."""
    if case == "cartpole":
        return dict(env="CartPole-v1", num_rollout_workers=2,
                    rollout_fragment_length=64, num_epochs=2,
                    minibatch_size=64, seed=0, lr=LR)
    return dict(env=f"{pkg}.rl.pixel_env:PixelCatcher",
                env_config={"balls_per_episode": 2},
                num_rollout_workers=2, rollout_fragment_length=32,
                num_epochs=2, minibatch_size=32, cnn_hidden=64, seed=0,
                lr=LR)


class _Recording(tppo.PPOTrainer):
    """The port's trainer, keeping the batch each train() sampled."""

    def _sample_batch(self):
        self.batch = super()._sample_batch()
        return self.batch


@pytest.mark.parametrize("case", ["cartpole", "pixels"])
def test_ppo_train_iteration(ray_start_regular, case):
    """One train() of the port's PPOTrainer (rollout actors over the
    port's runtime, learner on the CPU) against the reference's trainer
    in this process, both from the reference's init."""
    with jax_reference() as ref:
        kw = _trainer_case(case, "ray_tpu")
        if case == "pixels":
            kw["obs_connectors"] = ref.rl_pixel_env.atari_connectors(
                stack=2, out_size=42)
        rtr = ref.rl_ppo.PPOTrainer(ref.rl_ppo.PPOConfig(**kw))
        p0 = jax_params = rtr.params
        seen = {}
        run = ref.rl_ppo.run_ppo_epochs

        def recording(update, params, opt_state, **b):
            seen.update(b)
            return run(update, params, opt_state, **b)

        ref.rl_ppo.run_ppo_epochs = recording
        try:
            rres = rtr.train()
        finally:
            ref.rl_ppo.run_ppo_epochs = run
        rparams = rtr.params
        del jax_params

    kw = _trainer_case(case, "ray_tpu_torch")
    if case == "pixels":
        kw["obs_connectors"] = tpix.atari_connectors(stack=2, out_size=42)
    tr = _Recording(tppo.PPOConfig(device="cpu", **kw))
    try:
        assert ("conv" in tr.params) == (case == "pixels")
        tr.params = tcore.params_from_jax(p0, "cpu")
        res = tr.train()
    finally:
        tr.stop()
    b = tr.batch
    np.testing.assert_array_equal(b["obs"], seen["obs"])
    np.testing.assert_array_equal(b["actions"], seen["actions"])
    np.testing.assert_allclose(b["logp"], seen["logp"], rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_allclose(b["adv"], seen["adv"], rtol=0, atol=1e-4)
    assert res["timesteps_this_iter"] == rres["timesteps_this_iter"]
    for k in ("pg_loss", "vf_loss", "entropy", "total_loss"):
        assert abs(res[k] - rres[k]) <= 1e-4 * max(abs(rres[k]), 1.0), k
    assert_params_close(tr.params, rparams)


def test_multi_agent_ppo_train_iteration(ray_start_regular):
    """One train() of MultiAgentPPOTrainer (two policies on context_match,
    rollout actors over the port's runtime) against the reference's in
    this process, from the reference's init: each policy's batch (the
    agents' observations and actions equal) and its params after the
    epochs."""
    from ray_tpu_torch.rl import multi_agent as tma

    kw = dict(num_rollout_workers=2, rollout_fragment_length=64,
              num_epochs=2, minibatch_size=64, lr=LR, seed=0)
    with jax_reference() as ref:
        m = ref.rl_multi_agent
        rtr = m.MultiAgentPPOTrainer(m.MultiAgentPPOConfig(**kw))
        p0 = dict(rtr.policies)
        seen = []
        run = m.run_ppo_epochs

        def recording(update, params, opt_state, **b):
            seen.append(b)
            return run(update, params, opt_state, **b)

        m.run_ppo_epochs = recording
        try:
            rres = rtr.train()
        finally:
            m.run_ppo_epochs = run
        rpolicies = rtr.policies

    got = []
    run_port = tma.run_ppo_epochs

    def recording_port(update, params, opt_state, **b):
        got.append(b)
        return run_port(update, params, opt_state, **b)

    tr = tma.MultiAgentPPOTrainer(tma.MultiAgentPPOConfig(device="cpu",
                                                          **kw))
    tma.run_ppo_epochs = recording_port
    try:
        tr.set_weights({pid: tcore.params_from_jax(p, "cpu")
                        for pid, p in p0.items()})
        res = tr.train()
    finally:
        tma.run_ppo_epochs = run_port
        tr.stop()
    assert sorted(res["policies"]) == sorted(rres["policies"]) == ["a", "b"]
    assert len(got) == len(seen) == 2
    for b, r in zip(got, seen):
        np.testing.assert_array_equal(b["obs"], r["obs"])
        np.testing.assert_array_equal(b["actions"], r["actions"])
        np.testing.assert_allclose(b["logp"], r["logp"], rtol=0,
                                   atol=FWD_TOL)
    for pid in rpolicies:
        assert_params_close(tr.policies[pid], rpolicies[pid])
