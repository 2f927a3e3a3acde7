"""Multi-agent RL + Learner/LearnerGroup on the port, mirroring
tests/test_rl_multi_agent.py (ref: rllib/tests/test_multi_agent_env.py —
dict in/out, per-policy batches, "__all__" termination — and
rllib/core/learner/tests — an update moves weights, group replicas stay
in sync). Learners on the CPU (``device="cpu"``)."""

import numpy as np
import pytest
import torch

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

import ray_tpu_torch


def test_multi_agent_env_protocol():
    from ray_tpu_torch.rl.multi_agent import ContextMatchEnv

    env = ContextMatchEnv(n_context=3, episode_len=2, seed=0)
    obs, _ = env.reset(seed=0)
    assert set(obs) == {"a", "b"}
    assert obs["a"].shape == (3,) and obs["a"].sum() == 1.0
    ctx = {aid: int(o.argmax()) for aid, o in obs.items()}
    obs, rew, term, trunc, _ = env.step(ctx)
    assert rew["a"] == 1.0 and rew["b"] >= 1.0
    assert term["__all__"] is False
    _, _, term, _, _ = env.step({"a": 0, "b": 0})
    assert term["__all__"] is True


def _reference_init(seed, hidden, specs):
    """The JAX trainer's init of each policy (``init_policy`` of
    ``fold_in(PRNGKey(seed), i)`` over the sorted policy ids), as the
    port's trees: the learning check starts where the reference's does
    (the two packages' generators draw different numbers). Whether 8
    iterations pass the check depends on the draw: the JAX trainer fails
    it on some seeds of its own, and from the port's draw of a seed it
    fails wherever the port's trainer does (tests/rl_learning_sweep.py
    runs both trainers from both draws over many seeds)."""
    from test_torch_support import jax_reference

    from ray_tpu_torch.rl.core import params_from_jax

    with jax_reference() as ref:
        import jax

        key = jax.random.PRNGKey(seed)
        return {pid: params_from_jax(ref.rl_ppo.init_policy(
            jax.random.fold_in(key, i), od, na, hidden), "cpu")
            for i, (pid, (od, na)) in enumerate(sorted(specs.items()))}


@pytest.mark.slow
def test_multi_agent_ppo_learns(ray_start_regular):
    from ray_tpu_torch.rl import MultiAgentPPOConfig, MultiAgentPPOTrainer

    cfg = MultiAgentPPOConfig(num_rollout_workers=2,
                              rollout_fragment_length=128,
                              minibatch_size=64, lr=1e-2, seed=0,
                              device="cpu")
    t = MultiAgentPPOTrainer(cfg)
    t.set_weights(_reference_init(0, cfg.hidden, {"a": (4, 4),
                                                  "b": (4, 4)}))
    try:
        r = None
        for _ in range(8):
            r = t.train()
        # both policies trained, losses finite
        assert set(r["policies"]) == {"a", "b"}
        for aux in r["policies"].values():
            assert np.isfinite(aux["total_loss"])
        # context_match is learnable: greedy actions should match context
        obs = {"a": np.eye(4, dtype=np.float32)[2],
               "b": np.eye(4, dtype=np.float32)[1]}
        acts = t.compute_actions(obs)
        assert acts["a"] == 2 and acts["b"] == 1
        # episode return trends up (max is ~37.5/ep for len-25 episodes)
        assert r["episode_return_mean"] > 25
    finally:
        t.stop()


def test_multi_agent_shared_policy(ray_start_regular):
    """Two agents mapped onto ONE shared policy (rllib's param-sharing
    pattern via policy_mapping_fn)."""
    from ray_tpu_torch.rl import MultiAgentPPOConfig, MultiAgentPPOTrainer

    cfg = MultiAgentPPOConfig(
        policy_mapping={"a": "shared", "b": "shared"},
        num_rollout_workers=1, rollout_fragment_length=64, seed=1,
        device="cpu")
    t = MultiAgentPPOTrainer(cfg)
    try:
        r = t.train()
        assert list(r["policies"]) == ["shared"]
        assert set(t.get_weights()) == {"shared"}
        assert np.isfinite(r["policies"]["shared"]["total_loss"])
        acts = t.compute_actions({"a": np.eye(4, dtype=np.float32)[0]})
        assert acts["a"] in range(4)
    finally:
        t.stop()


def _spec(lr=1e-1):
    from ray_tpu_torch.rl import LearnerSpec

    def init_fn(gen):
        return {"w": torch.randn((4, 1), generator=gen)}

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.square(pred[:, 0] - batch["y"]).mean()

    return LearnerSpec(init_fn=init_fn, loss_fn=loss_fn, lr=lr,
                       grad_clip=10.0, seed=0, device="cpu")


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w_true = np.asarray([1.0, -2.0, 0.5, 0.0], np.float32)
    return {"x": x, "y": x @ w_true}


def test_learner_update_converges():
    from ray_tpu_torch.rl import Learner

    lrn = Learner(_spec())
    batch = _data()
    losses = [lrn.update(batch) for _ in range(60)]
    assert losses[-1] < 0.05 * losses[0]
    st = lrn.get_state()
    lrn2 = Learner(_spec())
    lrn2.set_state(st)
    assert torch.allclose(lrn2.get_weights()["w"], lrn.get_weights()["w"])
    # the restored optimizer state continues the same trajectory
    assert lrn2.update(batch) == lrn.update(batch)


def test_learner_gradients_split_matches_update():
    """compute_gradients + apply_gradients is update()."""
    from ray_tpu_torch.rl import Learner

    a, b = Learner(_spec()), Learner(_spec())
    batch = _data()
    for _ in range(3):
        la = a.update(batch)
        lb, grads = b.compute_gradients(batch)
        b.apply_gradients(grads)
        assert la == lb
    assert torch.equal(a.get_weights()["w"], b.get_weights()["w"])


def test_learner_group_ddp_equivalence(ray_start_regular):
    """Group replicas stay bit-identical and converge
    (ref: learner_group DDP semantics)."""
    from ray_tpu_torch.rl import LearnerGroup

    g = LearnerGroup(_spec(), num_learners=2, num_cpus_per_learner=0.5)
    try:
        batch = _data(n=64)
        first = g.update(batch)
        for _ in range(40):
            last = g.update(batch)
        assert last < 0.1 * first
        # replicas in sync after many updates
        states = ray_tpu_torch.get([a.get_weights.remote()
                                    for a in g._actors])
        assert torch.equal(states[0]["w"], states[1]["w"])
    finally:
        g.shutdown()
