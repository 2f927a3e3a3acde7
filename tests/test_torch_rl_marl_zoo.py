"""The cooperative multi-agent, meta-learning, planning and recommender
algorithms of the port (ray_tpu_torch/rl/{qmix,maddpg,alpha_zero,maml,
slateq}.py), mirroring the JAX package's cases of them: every case of
tests/test_rl_multi_agent2.py (QMIX, MADDPG, their envs and the registry)
and the AlphaZero, MAML and SlateQ cases of tests/test_rl_zoo5.py (its DT
cases are re-aimed in tests/test_torch_rl_offline_zoo.py). Same contract
(ref: rllib/algorithms/*/tests/): the envs' rules, a few training
iterations run, metrics are finite, weights move. Learners on the CPU
(``device="cpu"``); rollout actors in the port's worker processes."""

import numpy as np
import pytest
import torch

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch.rl.core import to_host, tree_leaves


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x.cpu(), y.cpu())
                                      for x, y in zip(la, lb))


# --- QMIX and MADDPG (tests/test_rl_multi_agent2.py) -------------------------


def test_two_step_game_env():
    from ray_tpu_torch.rl import TwoStepGame

    env = TwoStepGame()
    obs, _ = env.reset()
    assert set(obs) == {"a", "b"}
    # picking game 2B then both playing action 1 pays the team 8
    _, rew, term, _, _ = env.step({"a": 1, "b": 0})
    assert not term["__all__"] and sum(rew.values()) == 0
    _, rew, term, _, _ = env.step({"a": 1, "b": 1})
    assert term["__all__"] and sum(rew.values()) == 8.0
    # game 2A pays 7 regardless
    env.reset()
    env.step({"a": 0, "b": 0})
    _, rew, term, _, _ = env.step({"a": 0, "b": 0})
    assert sum(rew.values()) == 7.0


def test_qmix_mixer_monotonic():
    """dQ_tot/dq_i must be non-negative for every agent — the QMIX
    structural constraint the hypernet abs() enforces."""
    from ray_tpu_torch.rl.qmix import init_qmix_nets, mix

    nets = init_qmix_nets(torch.Generator().manual_seed(0), n_agents=2,
                          obs_dim=3, n_actions=2, state_dim=6, hidden=16,
                          embed=8)
    rng = np.random.default_rng(0)
    qs = torch.tensor(rng.normal(size=(32, 2)), dtype=torch.float32,
                      requires_grad=True)
    state = torch.tensor(rng.normal(size=(32, 6)), dtype=torch.float32)
    # each row's Q_tot depends on its own qs only: the sum's gradient is
    # the per-row gradient
    (grads,) = torch.autograd.grad(mix(nets, qs, state).sum(), qs)
    assert torch.all(grads >= 0)


def test_qmix_trains(ray_start_regular):
    from ray_tpu_torch.rl import QMIXConfig, QMIXTrainer

    t = QMIXTrainer(QMIXConfig(num_rollout_workers=2,
                               rollout_fragment_length=32,
                               learning_starts=64, train_batch_size=32,
                               updates_per_iter=8, hidden=16,
                               mixing_embed=8, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        t.train()
        r2 = t.train()
        assert r2["timesteps_total"] == 128
        assert r2["num_updates"] == 8 and np.isfinite(r2["loss"])
        assert not _tree_equal(t.get_weights(), w0)
        assert r2["episodes_total"] > 0
    finally:
        t.stop()


def test_qmix_learns_two_step_game(ray_start_regular):
    """QMIX on its paper's coordination game: mean return should climb
    well above random play (random play averages ~3)."""
    from ray_tpu_torch.rl import QMIXConfig, QMIXTrainer

    t = QMIXTrainer(QMIXConfig(num_rollout_workers=2,
                               rollout_fragment_length=64,
                               learning_starts=128, train_batch_size=64,
                               updates_per_iter=32, lr=5e-3,
                               epsilon_timesteps=1500,
                               target_network_update_freq=100,
                               device="cpu"))
    try:
        best = -np.inf
        for _ in range(12):
            r = t.train()
            if r["episode_return_mean"]:
                best = max(best, r["episode_return_mean"])
        assert best >= 6.0, f"QMIX failed to coordinate, best={best}"
    finally:
        t.stop()


def test_line_spread_env():
    from ray_tpu_torch.rl import LineSpreadEnv

    env = LineSpreadEnv(episode_len=3, seed=1)
    obs, _ = env.reset(seed=1)
    assert obs["a"].shape == (4,)
    total = 0.0
    for _ in range(3):
        _, rew, term, _, _ = env.step({"a": np.asarray([0.5]),
                                       "b": np.asarray([-0.5])})
        total += sum(rew.values())
    assert term["__all__"]
    assert total < 0  # distances are penalties


def test_maddpg_trains(ray_start_regular):
    from ray_tpu_torch.rl import MADDPGConfig, MADDPGTrainer

    t = MADDPGTrainer(MADDPGConfig(num_rollout_workers=2,
                                   rollout_fragment_length=40,
                                   learning_starts=120,
                                   train_batch_size=64,
                                   updates_per_iter=8, hidden=32,
                                   device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        for _ in range(4):
            r = t.train()
            if r["num_updates"]:
                break
        assert r["num_updates"] > 0
        assert np.isfinite(r["critic_loss"]) and np.isfinite(r["actor_loss"])
        assert not _tree_equal(t.get_weights(), w0)
        # centralized critic input = all obs + all actions
        joint = sum(t.obs_dims) + sum(t.act_dims)
        assert t.nets["critics"][0][0]["w"].shape[0] == joint
    finally:
        t.stop()


def test_registry_has_marl_algos():
    from ray_tpu_torch.rl import get_algorithm

    for name in ("QMIX", "MADDPG"):
        assert get_algorithm(name) is not None


# --- AlphaZero, MAML, SlateQ (tests/test_rl_zoo5.py) -------------------------


def test_tictactoe_rules():
    from ray_tpu_torch.rl import TicTacToe

    g = TicTacToe()
    for a in (0, 3, 1, 4):
        g.step(a)
    assert g.outcome() is None
    g.step(2)                      # X completes 0-1-2
    assert g.outcome() == 1
    g2 = TicTacToe()
    for a in (0, 1, 2, 4, 3, 7):   # O completes 1-4-7
        g2.step(a)
    assert g2.outcome() == -1


def test_mcts_blocks_immediate_loss():
    """With enough simulations MCTS must play the forced move (block a
    completed line) even with an untrained network."""
    from ray_tpu_torch.rl.alpha_zero import (TicTacToe, init_az_net,
                                             mcts_policy)

    net = init_az_net(torch.Generator().manual_seed(0), TicTacToe.OBS_DIM,
                      TicTacToe.N_ACTIONS, 16)
    g = TicTacToe()
    # X: 0, O: 4, X: 1 -> X threatens 0-1-2; O (to move) must play 2
    for a in (0, 4, 1):
        g.step(a)
    pi = mcts_policy(net, g, num_sims=200, c_puct=1.5,
                     rng=np.random.default_rng(0), root_noise_frac=0.0)
    assert pi.argmax() == 2, pi


def test_alphazero_trains(ray_start_regular):
    from ray_tpu_torch.rl import AlphaZeroConfig, AlphaZeroTrainer

    t = AlphaZeroTrainer(AlphaZeroConfig(
        num_rollout_workers=2, games_per_worker=2, num_sims=12,
        train_batch_size=64, updates_per_iter=8, hidden=32, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        r = t.train()
        assert r["games_total"] == 4
        assert np.isfinite(r["loss"]) and np.isfinite(r["v_loss"])
        assert r["buffer_size"] >= 4 * 5    # >= 5 plies per game
        assert not _tree_equal(t.get_weights(), w0)
    finally:
        t.stop()


def test_maml_trains_and_adapts(ray_start_regular):
    from ray_tpu_torch.rl import MAMLConfig, MAMLTrainer

    t = MAMLTrainer(MAMLConfig(num_rollout_workers=2,
                               episodes_per_task=3, hidden=16,
                               device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        r = t.train()
        assert r["tasks_total"] == 2
        assert np.isfinite(r["meta_loss"])
        assert not _tree_equal(t.get_weights(), w0)
        # one inner PG step on a fresh task; adapt() keeps no graph
        adapted, pre, post = t.adapt([0.8, 0.0], episodes=6)
        assert np.isfinite(pre) and np.isfinite(post)
        assert not any(x.requires_grad for x in tree_leaves(adapted))
    finally:
        t.stop()


def test_maml_meta_gradient_flows_through_inner_step():
    """The meta-gradient must differ from the plain gradient at the same
    point — i.e. the inner adaptation is differentiated through, not
    detached. (The JAX package marks its case slow; here it takes well
    under a second.)"""
    from ray_tpu_torch.rl.core import (tree_unflatten_like,
                                       value_and_grad)
    from ray_tpu_torch.rl.maml import init_maml_policy, inner_adapt, pg_loss

    params = init_maml_policy(torch.Generator().manual_seed(0), 8)
    rng = np.random.default_rng(0)

    def mk():
        return {"obs": torch.tensor(rng.normal(size=(30, 2)),
                                    dtype=torch.float32),
                "actions": torch.tensor(rng.normal(size=(30, 2)),
                                        dtype=torch.float32),
                "adv": torch.tensor(rng.normal(size=(30,)),
                                    dtype=torch.float32)}
    pre, post = mk(), mk()

    def meta(p):
        return pg_loss(inner_adapt(p, pre, 0.1), post), {}

    def detached(p):
        adapted = inner_adapt(p, pre, 0.1)
        leaves = [a.detach() + b * 0 for a, b in zip(tree_leaves(adapted),
                                                      tree_leaves(p))]
        return pg_loss(tree_unflatten_like(p, leaves), post), {}

    _, la = value_and_grad(meta, params)
    _, lb = value_and_grad(detached, params)
    assert any(not torch.allclose(x, y, atol=1e-8) for x, y in zip(la, lb))


def test_slate_rec_env():
    from ray_tpu_torch.rl import SlateRecEnv

    env = SlateRecEnv(n_docs=6, slate_size=2, episode_len=3, seed=0)
    obs = env.reset(seed=0)
    assert obs["user"].shape == (4,) and obs["docs"].shape == (6, 4)
    for _ in range(3):
        obs, rew, clicked, done = env.step([0, 1])
        if clicked >= 0:
            assert clicked in (0, 1)
    assert done
    with pytest.raises(AssertionError):
        env.reset()
        env.step([2, 2])        # duplicate docs rejected


def test_slateq_decomposition_value():
    from ray_tpu_torch.rl.slateq import slate_value

    q = np.asarray([1.0, 2.0, 3.0])
    scores = np.asarray([1.0, 1.0, 1.0])
    # uniform scores, null_bias=0 -> v = (1+2)/(2+1) over slate [0,1]
    assert np.isclose(slate_value(q, scores, [0, 1], 0.0), 3.0 / 3.0)


def test_slateq_trains(ray_start_regular):
    from ray_tpu_torch.rl import SlateQConfig, SlateQTrainer

    t = SlateQTrainer(SlateQConfig(
        env_config={"n_docs": 8, "slate_size": 2, "episode_len": 10},
        num_rollout_workers=2, rollout_fragment_length=40,
        learning_starts=80, train_batch_size=32, updates_per_iter=8,
        hidden=32, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        t.train()
        r2 = t.train()
        assert r2["timesteps_total"] == 160
        assert r2["num_updates"] > 0 and np.isfinite(r2["loss"])
        assert r2["clicks_this_iter"] > 0
        assert not _tree_equal(t.get_weights(), w0)
    finally:
        t.stop()


def test_registry_final_count():
    from ray_tpu_torch.rl import _REGISTRY, get_algorithm

    for name in ("DT", "AlphaZero", "MAML", "SlateQ"):
        assert get_algorithm(name) is not None
    # breadth parity: the reference registers 31 algorithms
    assert len(_REGISTRY) >= 31
