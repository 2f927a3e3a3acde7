"""External env / policy server+client on the port, mirroring
tests/test_rl_policy_server.py (ref: rllib's policy_server_input +
policy_client tests and the cartpole server/client example pair)."""

import math
import threading

import pytest
import torch


def test_policy_server_protocol():
    from ray_tpu_torch.rl.policy_server import PolicyClient, PolicyServer
    from ray_tpu_torch.rl.ppo import init_policy

    srv = PolicyServer(port=0)
    srv.set_weights(init_policy(torch.Generator().manual_seed(0), 4, 2, 32))
    try:
        c = PolicyClient(("127.0.0.1", srv.port))
        eid = c.start_episode()
        a1 = c.get_action(eid, [0.1, 0.2, 0.3, 0.4])
        assert a1 in (0, 1)
        c.log_returns(eid, 1.0)
        c.log_returns(eid, 0.5)          # rewards accumulate per step
        a2 = c.get_action(eid, [0.0, 0.0, 0.0, 0.0])
        assert a2 in (0, 1)
        c.log_returns(eid, 2.0)
        c.end_episode(eid)
        eps = srv.drain_episodes(min_steps=1, timeout_s=5)
        assert len(eps) == 1
        ep = eps[0]
        assert len(ep.actions) == 2
        assert list(ep.rewards) == [1.5, 2.0]
        c.close()
    finally:
        srv.shutdown()


def test_policy_server_reports_errors():
    """A request the server cannot serve comes back as an error frame and
    the connection stays usable."""
    from ray_tpu_torch.rl.policy_server import PolicyClient, PolicyServer

    srv = PolicyServer(port=0)
    try:
        c = PolicyClient(f"127.0.0.1:{srv.port}")
        eid = c.start_episode()
        with pytest.raises(RuntimeError, match="no policy weights"):
            c.get_action(eid, [0.0] * 4)
        with pytest.raises(RuntimeError, match="unknown method"):
            c._call("nope")
        assert c.start_episode() == eid + 1
        c.close()
    finally:
        srv.shutdown()


def _cartpole_simulator(address, stop):
    """External CartPole episodes against the server until `stop`."""
    import gymnasium as gym

    from ray_tpu_torch.rl.policy_server import PolicyClient

    env = gym.make("CartPole-v1")
    c = PolicyClient(address)
    while not stop.is_set():
        eid = c.start_episode()
        obs, _ = env.reset()
        while True:
            a = c.get_action(eid, obs)
            obs, rew, term, trunc, _ = env.step(a)
            c.log_returns(eid, float(rew))
            if term or trunc:
                c.end_episode(eid)
                break
    c.close()


def test_external_ppo_trains_one_iteration():
    """One train() of the server-side learner on external episodes: the
    update ran (finite losses, weights moved) and the server serves the
    new weights."""
    from ray_tpu_torch.rl.policy_server import (ExternalPPOConfig,
                                                ExternalPPOTrainer)

    t = ExternalPPOTrainer(ExternalPPOConfig(
        obs_dim=4, n_actions=2, train_batch_size=64, minibatch_size=32,
        num_epochs=2, device="cpu"))
    w0 = t.get_weights()["pi"]["w"].clone()
    stop = threading.Event()
    sim = threading.Thread(target=_cartpole_simulator,
                           args=(t.address, stop), daemon=True)
    sim.start()
    try:
        r = t.train()
        assert r["episodes_this_iter"] > 0 and r["timesteps_total"] >= 64
        assert all(math.isfinite(r[k]) for k in ("total_loss", "entropy"))
        assert not torch.equal(t.get_weights()["pi"]["w"], w0)
        assert torch.equal(t.server.params["pi"]["w"],
                           t.get_weights()["pi"]["w"])
    finally:
        stop.set()
        t.stop()
        sim.join(timeout=10)
    assert not sim.is_alive()


@pytest.mark.slow
def test_external_ppo_learns_cartpole():
    """An external CartPole simulator (the client) drives episodes
    against the learning server — the reference's cartpole_server /
    cartpole_client pair in one process."""
    from ray_tpu_torch.rl.policy_server import (ExternalPPOConfig,
                                                ExternalPPOTrainer)

    # The learner here runs on the CPU, in this process, while the
    # server's handler threads run the policy for the simulator: two
    # Python threads running torch at once, each with an OpenMP team of a
    # thread per core spinning between regions, starve each other (an
    # iteration took 20.8 s against 0.15 s on one thread, the drained
    # batches growing with it). One intra-op thread for the test; the
    # card's learner does not compete for the host's cores this way.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t = ExternalPPOTrainer(ExternalPPOConfig(obs_dim=4, n_actions=2,
                                             train_batch_size=400,
                                             minibatch_size=128, lr=1e-2,
                                             device="cpu"))
    stop = threading.Event()
    sim = threading.Thread(target=_cartpole_simulator,
                           args=(t.address, stop), daemon=True)
    sim.start()
    try:
        best = 0.0
        for _ in range(12):
            r = t.train()
            if r.get("episodes_this_iter"):
                best = max(best, r["episode_return_mean"])
        # random CartPole is ~20/ep; learning shows clearly above that
        assert best > 50, best
        assert t.timesteps > 1000
    finally:
        stop.set()
        t.stop()
        sim.join(timeout=10)
        torch.set_num_threads(threads)
