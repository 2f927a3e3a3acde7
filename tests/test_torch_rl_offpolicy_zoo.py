"""The ported online off-policy and gradient-free algorithms
(ray_tpu_torch/rl/{dqn,sac,td3,ddpg,apex,simple_q,r2d2,es}.py), mirroring
the JAX package's zoo cases of them: test_dqn_trains, test_sac_trains,
test_td3_trains and test_bc_from_ray_dataset (tests/test_rl_zoo.py),
test_ddpg_trains, test_es_improves_cartpole, test_ars_trains,
test_registry_has_new_algos and test_apex_dqn_trains (test_rl_zoo2.py),
test_registry_has_new_algorithms (test_rl_zoo3.py), test_simple_q_trains,
test_simple_q_rejects_extensions, test_random_agent_baseline,
test_r2d2_trains (slow, as there), test_r2d2_burn_in_isolated_from_gradient,
test_apex_ddpg_trains and test_registry_has_new_algos (test_rl_zoo4.py).
Same contract (ref: rllib/algorithms/*/tests/): a few iterations run,
metrics are finite, weights move, save/restore round-trips. Learners on
the CPU (``device="cpu"``), rollout and replay actors in worker processes
of the port's runtime."""

import numpy as np
import pytest
import torch

from torch_runtime_support import reap_orphans  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.rl.core import clone_tree, to_host, tree_leaves


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True,
                       _system_config={"health_check_period_s": 0.2,
                                       "worker_idle_timeout_s": 60.0})
    yield
    ray_tpu_torch.shutdown()


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
        for x, y in zip(la, lb))


def test_dqn_trains(cluster):
    from ray_tpu_torch.rl import DQNConfig, DQNTrainer

    cfg = DQNConfig(num_rollout_workers=2, rollout_fragment_length=100,
                    learning_starts=150, updates_per_iter=8,
                    target_network_update_freq=200, device="cpu")
    t = DQNTrainer(cfg)
    try:
        w_init = to_host(t.get_weights())
        t.train()
        r2 = t.train()
        assert r2["timesteps_total"] == 400
        assert r2["num_updates"] == 8
        assert np.isfinite(r2["loss"])
        assert 0 < r2["epsilon"] <= 1
        # weights must have moved once updates started
        assert not _tree_equal(t.get_weights(), w_init)

        ckpt = t.save()
        w0 = to_host(t.get_weights())
        t.train()
        assert not _tree_equal(t.get_weights(), w0)
        t.restore(ckpt)
        assert _tree_equal(t.get_weights(), w0)
        assert _tree_equal(t.target, w0)
    finally:
        t.stop()


def test_sac_trains(cluster):
    from ray_tpu_torch.rl import SACConfig, SACTrainer

    cfg = SACConfig(num_rollout_workers=1, rollout_fragment_length=120,
                    learning_starts=100, updates_per_iter=4, device="cpu")
    t = SACTrainer(cfg)
    try:
        t.train()
        r2 = t.train()
        assert r2["timesteps_total"] == 240
        assert np.isfinite(r2["critic_loss"])
        assert np.isfinite(r2["actor_loss"])
        assert r2["alpha"] > 0
        # the second iteration sampled with the actor (not warm-up)
        assert r2["sample_time_s"] > 0 and r2["learn_time_s"] > 0
    finally:
        t.stop()


def test_td3_trains(cluster):
    from ray_tpu_torch.rl import TD3Config, TD3Trainer

    cfg = TD3Config(num_rollout_workers=1, rollout_fragment_length=80,
                    learning_starts=100, updates_per_iter=8, policy_delay=2,
                    device="cpu")
    t = TD3Trainer(cfg)
    try:
        w0 = to_host(t.get_weights())
        t.train()
        r = t.train()
        assert r["timesteps_total"] == 160
        # buffer crosses learning_starts only in iter 2 -> 8 updates total
        assert r["num_updates"] == 8
        assert np.isfinite(r["critic_loss"])
        assert not _tree_equal(t.get_weights(), w0)
        ckpt = t.save()
        w1 = to_host(t.get_weights())
        t.train()
        t.restore(ckpt)
        assert _tree_equal(t.get_weights(), w1)
    finally:
        t.stop()


def test_bc_from_ray_dataset(cluster):
    """Offline input through the port's data layer (ref: rllib/offline
    readers feed SampleBatches from ray.data)."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.rl import BCConfig, BCTrainer

    rng = np.random.default_rng(1)
    obs = rng.normal(size=(256, 4)).astype(np.float32)
    actions = (obs[:, 1] > 0).astype(np.int64)
    ds = rd.from_numpy({"obs": obs, "actions": actions}, num_blocks=4)
    t = BCTrainer(BCConfig(dataset=ds, discrete=True, updates_per_iter=64,
                           device="cpu"))
    for _ in range(4):
        r = t.train()
    assert r["accuracy"] > 0.85


def test_ddpg_trains(cluster):
    from ray_tpu_torch.rl import DDPGConfig, DDPGTrainer

    cfg = DDPGConfig(num_rollout_workers=1, rollout_fragment_length=100,
                     learning_starts=100, updates_per_iter=8, device="cpu")
    t = DDPGTrainer(cfg)
    try:
        for _ in range(2):
            r = t.train()
        assert r["num_updates"] > 0
        assert np.isfinite(r["critic_loss"])
        assert np.isfinite(r["actor_loss"])
    finally:
        t.stop()


def test_es_improves_cartpole(cluster):
    from ray_tpu_torch.rl import ESConfig, ESTrainer

    cfg = ESConfig(num_rollout_workers=2, episodes_per_iter=8,
                   max_episode_steps=100, seed=3)
    t = ESTrainer(cfg)
    try:
        r = None
        for _ in range(3):
            r = t.train()
        assert r["episodes_total"] == 3 * 8 * 2  # antithetic pairs
        assert np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
        # deterministic noise regeneration: weights changed
        assert np.linalg.norm(t.get_weights()) > 0
    finally:
        t.stop()


def test_ars_trains(cluster):
    from ray_tpu_torch.rl import ARSConfig, ARSTrainer

    cfg = ARSConfig(num_rollout_workers=2, num_directions=8,
                    top_directions=4, max_episode_steps=100)
    t = ARSTrainer(cfg)
    try:
        w0 = t.get_weights().copy()
        r = t.train()
        assert r["episodes_total"] == 2 * 8
        assert np.isfinite(r["sigma_r"])
        assert not np.allclose(w0, t.get_weights())
    finally:
        t.stop()


def test_apex_dqn_trains(cluster):
    from ray_tpu_torch.rl import ApexDQNConfig, ApexDQNTrainer

    cfg = ApexDQNConfig(num_rollout_workers=2, num_replay_shards=1,
                        rollout_fragment_length=50, learning_starts=100,
                        updates_per_iter=8, device="cpu")
    t = ApexDQNTrainer(cfg)
    try:
        r = None
        for _ in range(6):
            r = t.train()
        assert r["timesteps_total"] > 0
        assert r["num_updates"] > 0
        assert np.isfinite(r["loss"])
        # per-worker epsilons differ (the APEX exploration ladder)
        assert len(set(t._eps)) == 2
        # the replay shards run on the CPU, the card hidden from them
        where = ray_tpu_torch.get(t.shards[0].placement.remote())
        assert not where["cuda_available"]
    finally:
        t.stop()


def test_simple_q_trains(cluster):
    from ray_tpu_torch.rl import SimpleQConfig, SimpleQTrainer

    t = SimpleQTrainer(SimpleQConfig(
        num_rollout_workers=2, rollout_fragment_length=40,
        learning_starts=60, updates_per_iter=8, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        assert "q" in t.net and "adv" not in t.net  # plain head, no dueling
        for _ in range(2):
            r = t.train()
        assert r["timesteps_total"] == 160
        assert np.isfinite(r["loss"])
        assert not _tree_equal(t.get_weights(), w0)
    finally:
        t.stop()


def test_simple_q_rejects_extensions(cluster):
    from ray_tpu_torch.rl import SimpleQConfig, SimpleQTrainer

    with pytest.raises(AssertionError):
        SimpleQTrainer(SimpleQConfig(double_q=True, device="cpu"))


def test_random_agent_baseline(cluster):
    from ray_tpu_torch.rl import RandomAgentConfig, RandomAgentTrainer

    t = RandomAgentTrainer(RandomAgentConfig(num_rollout_workers=2,
                                             rollout_fragment_length=100))
    try:
        r = t.train()
        assert r["timesteps_total"] == 200
        assert r["episodes_total"] > 0
        # CartPole under random actions: short episodes, low return
        assert 0 < r["episode_return_mean"] < 100
    finally:
        t.stop()


@pytest.mark.slow
def test_r2d2_trains(cluster):
    from ray_tpu_torch.rl import R2D2Config, R2D2Trainer

    t = R2D2Trainer(R2D2Config(
        num_rollout_workers=2, seqs_per_worker=4, burn_in=4, train_len=8,
        learning_starts=8, train_batch_size=8, updates_per_iter=4,
        hidden=16, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        r1 = t.train()
        r2 = t.train()
        assert r2["timesteps_total"] == 2 * 2 * 4 * 12   # iters*W*seqs*T
        assert r2["num_updates"] == 4 and np.isfinite(r2["loss"])
        assert not _tree_equal(t.get_weights(), w0)
        assert r1["buffer_size"] == 8 and r2["buffer_size"] == 16
    finally:
        t.stop()


def test_r2d2_burn_in_isolated_from_gradient(cluster):
    """Burn-in steps warm the LSTM state but must not contribute TD loss:
    perturbing rewards inside the burn-in window leaves the loss
    unchanged. The port's update steps the net in place, so each call gets
    its own copy of the starting net."""
    from ray_tpu_torch.rl import R2D2Config, R2D2Trainer
    from ray_tpu_torch.rl.core import minibatch_to_device

    t = R2D2Trainer(R2D2Config(num_rollout_workers=1, seqs_per_worker=1,
                               burn_in=4, train_len=4, hidden=8,
                               learning_starts=10**9, device="cpu"))
    try:
        rng = np.random.default_rng(0)
        T = t.seq_len
        mb = {"obs": rng.normal(size=(3, T + 1, 4)).astype(np.float32),
              "actions": rng.integers(0, 2, (3, T)).astype(np.int32),
              "rewards": rng.normal(size=(3, T)).astype(np.float32),
              "dones": np.zeros((3, T), np.float32),
              "h0": np.zeros((3, 8), np.float32),
              "c0": np.zeros((3, 8), np.float32)}
        _, _, loss_a, _ = t._update(clone_tree(t.net), t.target, None,
                                    minibatch_to_device(mb, "cpu"))
        mb2 = dict(mb)
        mb2["rewards"] = mb["rewards"].copy()
        mb2["rewards"][:, :4] += 100.0          # burn-in rewards only
        _, _, loss_b, _ = t._update(clone_tree(t.net), t.target, None,
                                    minibatch_to_device(mb2, "cpu"))
        assert np.allclose(float(loss_a), float(loss_b))
    finally:
        t.stop()


def test_apex_ddpg_trains(cluster):
    from ray_tpu_torch.rl import ApexDDPGConfig, ApexDDPGTrainer

    t = ApexDDPGTrainer(ApexDDPGConfig(
        num_rollout_workers=2, rollout_fragment_length=40,
        learning_starts=80, train_batch_size=32, updates_per_iter=8,
        hidden=32, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        for _ in range(6):
            r = t.train()
            if r["updates_this_iter"]:
                break
        assert r["num_updates"] > 0
        assert np.isfinite(r["critic_loss"])
        assert not _tree_equal(t.get_weights(), w0)
        # exploration-noise ladder is strictly decreasing in worker index
        assert t._noise == sorted(t._noise, reverse=True)
    finally:
        t.stop()


@pytest.mark.parametrize("names", [
    ("DQN", "SAC", "TD3", "BC", "CQL"),
    ("APPO", "DDPG", "ES", "ARS", "BanditLinUCB", "BanditLinTS"),
    ("PG", "A3C", "MARWIL"),
    ("SimpleQ", "RandomAgent", "R2D2", "CRR", "ApexDDPG", "DDPPO"),
    ("DT", "ApexDQN")], ids=["zoo", "zoo2", "zoo3", "zoo4", "zoo5"])
def test_registry_has_new_algos(names):
    from ray_tpu_torch.rl import get_algorithm

    for name in names:
        cfg_cls, trainer_cls = get_algorithm(name)
        assert cfg_cls is not None and trainer_cls is not None
        assert cfg_cls.__name__.endswith("Config")
        assert trainer_cls.__name__.endswith("Trainer")


def test_learners_refuse_cuda_without_it(monkeypatch):
    """A learner asked for CUDA on a machine without it raises; it never
    carries on on the CPU."""
    from ray_tpu_torch.rl import BCConfig, BCTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"obs": np.zeros((8, 3), np.float32),
            "actions": np.zeros(8, np.int64)}
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BCTrainer(BCConfig(dataset=data, device=device))
