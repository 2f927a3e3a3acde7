"""The ported offline and bandit algorithms and the prioritized replay
buffer (ray_tpu_torch/rl/{offline,marwil,dt,bandit,apex}.py), mirroring
the JAX package's zoo cases of them: test_bc_discrete_and_continuous and
test_cql_trains_offline (tests/test_rl_zoo.py), test_linucb_regret_shrinks,
test_lints_learns and test_prioritized_replay_buffer (test_rl_zoo2.py),
test_marwil_upweights_good_actions (test_rl_zoo3.py),
test_crr_trains_offline (test_rl_zoo4.py), test_dt_trains_and_imitates and
test_dt_from_flat_transitions (test_rl_zoo5.py). Same contract: a few
iterations run, metrics are finite, weights move, the algorithm's defining
property holds. Learners on the CPU (``device="cpu"``); none of these
trainers starts an actor."""

import numpy as np
import torch

from ray_tpu_torch.rl.core import to_host, tree_leaves


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x.cpu(), y.cpu())
                                      for x, y in zip(la, lb))


def _pendulum_offline_data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    act = np.clip(obs[:, :1] * 0.5 + rng.normal(scale=0.1, size=(n, 1)),
                  -2, 2).astype(np.float32)
    rew = -np.square(obs[:, 0]).astype(np.float32)
    done = (rng.random(n) < 0.02).astype(np.float32)
    nobs = (obs + rng.normal(scale=0.1, size=obs.shape)).astype(np.float32)
    return {"obs": obs, "actions": act, "rewards": rew, "dones": done,
            "next_obs": nobs}


def _cartpole_offline_data(n=600, seed=0):
    """Random-policy CartPole transitions for discrete offline algos."""
    import gymnasium as gym

    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(seed)
    obs_l, act_l, rew_l, done_l, nobs_l = [], [], [], [], []
    obs, _ = env.reset(seed=seed)
    for _ in range(n):
        a = int(rng.integers(2))
        nobs, rew, term, trunc, _ = env.step(a)
        obs_l.append(np.asarray(obs, np.float32))
        act_l.append(a)
        rew_l.append(float(rew))
        done_l.append(float(term))
        nobs_l.append(np.asarray(nobs, np.float32))
        obs = nobs
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    return {"obs": np.stack(obs_l), "actions": np.asarray(act_l, np.int64),
            "rewards": np.asarray(rew_l, np.float32),
            "dones": np.asarray(done_l, np.float32),
            "next_obs": np.stack(nobs_l)}


def _offline_discrete_data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    good = (obs[:, 0] > 0).astype(np.int64)
    # half the actions follow the good rule (rewarded), half are noise
    noise = rng.integers(0, 2, n)
    follow = rng.random(n) < 0.5
    actions = np.where(follow, good, noise)
    rewards = (actions == good).astype(np.float32)
    # bandit-style episodes (every row terminal): returns == rewards
    dones = np.ones(n, np.float32)
    return {"obs": obs, "actions": actions, "rewards": rewards,
            "dones": dones}


def test_bc_discrete_and_continuous():
    from ray_tpu_torch.rl import BCConfig, BCTrainer

    # Discrete: learn an obs->action rule to near-perfect accuracy.
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    actions = (obs[:, 0] > 0).astype(np.int64)
    t = BCTrainer(BCConfig(dataset={"obs": obs, "actions": actions},
                           discrete=True, updates_per_iter=64, device="cpu"))
    r = None
    for _ in range(5):
        r = t.train()
    assert r["accuracy"] > 0.9
    assert t.compute_action(obs[0]) in (0, 1)

    # Continuous: NLL decreases, MSE small on a linear rule.
    data = _pendulum_offline_data()
    t2 = BCTrainer(BCConfig(dataset={"obs": data["obs"],
                                     "actions": data["actions"]},
                            discrete=False, updates_per_iter=64,
                            device="cpu"))
    for _ in range(5):
        r2 = t2.train()
    assert r2["mse"] < 0.3
    assert t2.compute_action(data["obs"][0]).shape == (1,)


def test_cql_trains_offline():
    from ray_tpu_torch.rl import CQLConfig, CQLTrainer

    t = CQLTrainer(CQLConfig(dataset=_pendulum_offline_data(),
                             act_high=2.0, updates_per_iter=8, device="cpu"))
    w0 = to_host(t.get_weights())
    t.train()
    r2 = t.train()
    assert np.isfinite(r2["loss"]) and np.isfinite(r2["cql_penalty"])
    assert not _tree_equal(t.get_weights(), w0)
    a = t.compute_action(np.zeros(3, np.float32))
    assert a.shape == (1,) and np.all(np.abs(a) <= 2.0)
    a = t.compute_action(np.zeros(3, np.float32), deterministic=False)
    assert a.shape == (1,) and np.all(np.abs(a) <= 2.0)
    ckpt = t.save()
    w1 = to_host(t.get_weights())
    t.train()
    t.restore(ckpt)
    assert _tree_equal(t.get_weights(), w1)


def test_linucb_regret_shrinks():
    from ray_tpu_torch.rl import BanditConfig, LinUCBTrainer

    t = LinUCBTrainer(BanditConfig(steps_per_iter=200, seed=1))
    r1 = t.train()
    regret_1 = r1["cumulative_regret"]
    for _ in range(3):
        r = t.train()
    # per-iter regret must decay as posteriors concentrate
    last_iter_regret = r["cumulative_regret"] - regret_1
    assert last_iter_regret / 3 < regret_1
    ckpt = t.save()
    t2 = LinUCBTrainer(BanditConfig(steps_per_iter=200, seed=1))
    t2.restore(ckpt)
    assert np.allclose(t2.arms[0].b, t.arms[0].b)


def test_lints_learns():
    from ray_tpu_torch.rl import BanditConfig, LinTSTrainer

    t = LinTSTrainer(BanditConfig(steps_per_iter=300, seed=2))
    first = t.train()["episode_return_mean"]
    for _ in range(3):
        last = t.train()["episode_return_mean"]
    assert last > first  # mean reward rises as TS exploits


def test_prioritized_replay_buffer():
    from ray_tpu_torch.rl import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(capacity=256, alpha=0.6, seed=0)
    buf.add_batch({"obs": np.zeros((100, 4), np.float32),
                   "r": np.arange(100, dtype=np.float32)})
    mb = buf.sample(32, beta=0.4)
    assert mb["obs"].shape == (32, 4)
    assert mb["_weights"].max() == 1.0
    # raise priority of one index far above the rest; it should dominate
    buf.update_priorities(np.array([7]), np.array([100.0]))
    counts = 0
    for _ in range(20):
        mb = buf.sample(32, beta=0.4)
        counts += int((mb["_indices"] == 7).sum())
    assert counts > 40  # ~1/256 uniform would give ~2.5 expected


def test_marwil_upweights_good_actions():
    """The defining MARWIL property, asserted mechanically: after
    training, imitation weights exp(beta*adv/c) are systematically
    higher for rewarded transitions than unrewarded ones, and beta=0
    collapses to plain BC (all weights exactly 1)."""
    from ray_tpu_torch.rl import MARWILConfig, MARWILTrainer
    from ray_tpu_torch.rl.core import mlp_forward

    data = _offline_discrete_data()
    t = MARWILTrainer(MARWILConfig(dataset=data, beta=1.0,
                                   updates_per_iter=64, device="cpu"))
    r = None
    for _ in range(6):
        r = t.train()
    assert np.isfinite(r["loss"]) and np.isfinite(r["mean_weight"])
    assert r["accuracy"] > 0.6        # still imitates the majority signal

    # recompute the weights the loss used: rewarded samples must carry
    # more imitation mass than unrewarded ones
    with torch.no_grad():
        values = mlp_forward(t.params["vf"], torch.from_numpy(
            data["obs"]))[:, 0].numpy()
    adv = t.data["returns"] - values
    c = float(np.sqrt(t.c2) + 1e-8)
    w = np.exp(np.minimum(1.0 * adv / c, 5.0))
    rewarded = data["rewards"] > 0.5
    assert w[rewarded].mean() > w[~rewarded].mean() * 1.05, \
        "advantage weighting does not favor rewarded actions"

    # beta=0 is exactly BC: every weight is 1
    t0 = MARWILTrainer(MARWILConfig(dataset=data, beta=0.0,
                                    updates_per_iter=8, device="cpu"))
    r0 = t0.train()
    assert abs(r0["mean_weight"] - 1.0) < 1e-6

    a = t.compute_action(data["obs"][0])
    assert a in (0, 1)


def test_crr_trains_offline():
    from ray_tpu_torch.rl import CRRConfig, CRRTrainer

    data = _cartpole_offline_data()
    t = CRRTrainer(CRRConfig(dataset=data, updates_per_iter=16,
                             device="cpu"))
    w0 = to_host(t.get_weights())
    r = t.train()
    assert np.isfinite(r["loss"]) and np.isfinite(r["critic_loss"])
    # binary filter: weights are in [0, 1] and some actions pass
    assert 0.0 < r["mean_weight"] <= 1.0
    assert not _tree_equal(t.get_weights(), w0)
    a = t.compute_action(data["obs"][0])
    assert a in (0, 1)

    # exp-weighted variant also runs
    t2 = CRRTrainer(CRRConfig(dataset=data, weight_mode="exp",
                              updates_per_iter=4, device="cpu"))
    r2 = t2.train()
    assert np.isfinite(r2["loss"]) and r2["mean_weight"] > 0


def _toy_episodes(n=40, T=12, seed=0):
    """Scripted data: action = sign of obs[0]; rewards favor following
    the script, so a trained DT should imitate it."""
    rng = np.random.default_rng(seed)
    eps = []
    for _ in range(n):
        obs = rng.normal(size=(T, 3)).astype(np.float32)
        acts = (obs[:, 0] > 0).astype(np.int64)
        rews = np.ones(T, np.float32)
        eps.append({"obs": obs, "actions": acts, "rewards": rews})
    return eps


def test_dt_trains_and_imitates():
    from ray_tpu_torch.rl import DTConfig, DTTrainer

    t = DTTrainer(DTConfig(dataset=_toy_episodes(), context_len=6,
                           d_model=32, n_layers=1,
                           train_batch_size=32, updates_per_iter=40,
                           device="cpu"))
    r = None
    for _ in range(4):
        r = t.train()
    assert np.isfinite(r["loss"])
    assert r["action_accuracy"] > 0.8, r
    # evaluation API: greedy next action from a running history
    hist = {"rtg": [10.0, 9.0], "obs": [np.ones(3, np.float32),
                                        -np.ones(3, np.float32)],
            "actions": [1]}
    a = t.compute_action(hist)
    assert a in (0, 1)


def test_dt_from_flat_transitions():
    from ray_tpu_torch.rl import DTConfig, DTTrainer
    from ray_tpu_torch.rl.dt import _episodes_from

    flat = {"obs": np.zeros((10, 2), np.float32),
            "actions": np.zeros(10, np.int64),
            "rewards": np.ones(10, np.float32),
            "dones": np.asarray([0, 0, 0, 1, 0, 0, 0, 0, 0, 1],
                                np.float32)}
    eps = _episodes_from(flat)
    assert [len(e["actions"]) for e in eps] == [4, 6]
    # returns-to-go computed per-episode at setup
    t = DTTrainer(DTConfig(dataset=flat, context_len=4, d_model=16,
                           n_layers=1, updates_per_iter=1, device="cpu"))
    assert t.episodes[0]["rtg"][0] == 4.0 and t.episodes[1]["rtg"][0] == 6.0
