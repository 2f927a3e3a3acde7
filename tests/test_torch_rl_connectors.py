"""Connector pipelines on the port (ray_tpu_torch/rl/connectors.py),
mirroring tests/test_rl_connectors.py (ref: rllib/connectors tests —
transforms compose, stateful filters merge across workers, PPO
integrates)."""

import numpy as np
import pytest

from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)

from ray_tpu_torch.rl.connectors import (ClipObs, ConnectorPipeline,
                                         FlattenObs, FrameStack,
                                         NormalizeObs, build_pipeline)


def test_flatten_clip_compose():
    p = ConnectorPipeline([FlattenObs(), ClipObs(-1, 1)])
    out = p(np.array([[0.5, -3.0], [7.0, 0.0]]))
    assert out.shape == (4,)
    assert list(out) == [0.5, -1.0, 1.0, 0.0]


def test_normalize_obs_stats():
    rng = np.random.default_rng(0)
    n = NormalizeObs()
    xs = rng.normal(loc=5.0, scale=2.0, size=(500, 3))
    outs = np.stack([n(x) for x in xs])
    # after warmup the output distribution is ~standardized
    assert abs(outs[100:].mean()) < 0.3
    assert 0.5 < outs[100:].std() < 1.6
    st = n.get_state()
    assert st["count"] == 500
    np.testing.assert_allclose(st["mean"], xs.mean(0), rtol=1e-6)


def test_normalize_merge_matches_pooled():
    """Parallel Welford merge == stats of the pooled stream."""
    rng = np.random.default_rng(1)
    a, b = NormalizeObs(), NormalizeObs()
    xa = rng.normal(1.0, 1.0, size=(200, 2))
    xb = rng.normal(-2.0, 3.0, size=(300, 2))
    for x in xa:
        a(x)
    for x in xb:
        b(x)
    merged = NormalizeObs.merge_states([a.get_state(), b.get_state()])
    pooled = np.concatenate([xa, xb])
    np.testing.assert_allclose(merged["mean"], pooled.mean(0), rtol=1e-6)
    np.testing.assert_allclose(
        np.sqrt(merged["m2"] / (merged["count"] - 1)),
        pooled.std(0, ddof=1), rtol=1e-6)
    # round-trips into a fresh connector
    c = NormalizeObs()
    c.set_state(merged)
    assert c.count == 500


def test_frame_stack_resets_per_episode():
    fs = FrameStack(k=3)
    o1 = fs(np.array([1.0]))
    o2 = fs(np.array([2.0]))
    assert list(o1) == [0.0, 0.0, 1.0]
    assert list(o2) == [0.0, 1.0, 2.0]
    fs.on_episode_start()
    assert list(fs(np.array([9.0]))) == [0.0, 0.0, 9.0]


def test_normalize_delta_sync_counts_once():
    """Worker deltas + trainer absolute merge count every sample exactly
    once (reporting absolutes would double the shared baseline each
    sync -> geometric growth)."""
    rng = np.random.default_rng(2)
    trainer_abs = None
    workers = [NormalizeObs(), NormalizeObs()]
    total = 0
    for it in range(4):
        for w in workers:
            if trainer_abs is not None:
                w.set_state(trainer_abs)
            for x in rng.normal(size=(50, 2)):
                w(x)
            total += 50
        deltas = [w.get_state() for w in workers]
        cand = ([trainer_abs] if trainer_abs else []) + deltas
        trainer_abs = NormalizeObs.merge_states(cand)
    assert trainer_abs["count"] == total == 400


def test_build_pipeline_factories():
    p = build_pipeline([NormalizeObs, FlattenObs()])
    assert isinstance(p.connectors[0], NormalizeObs)
    assert isinstance(p.connectors[1], FlattenObs)


@pytest.mark.slow
def test_ppo_with_connectors(ray_start_regular):
    """PPO trains through a Normalize+FrameStack pipeline; worker stats
    merge and broadcast each iteration."""
    from ray_tpu_torch.rl import PPOConfig, PPOTrainer

    cfg = PPOConfig(num_rollout_workers=2, rollout_fragment_length=64,
                    obs_connectors=[NormalizeObs, lambda: FrameStack(2)],
                    device="cpu")
    t = PPOTrainer(cfg)
    try:
        r = t.train()
        assert np.isfinite(r["total_loss"])
        # policy input dim doubled by FrameStack(2): CartPole 4 -> 8
        assert t.params["torso"][0]["w"].shape[0] == 8
        # trainer-side absolute state counts every sample once
        c1 = t._conn_abs[0]["count"]
        assert c1 >= 128
        t.train()
        c2 = t._conn_abs[0]["count"]
        # linear growth (geometric would be ~4x by now)
        assert 1.5 * c1 < c2 < 3 * c1
    finally:
        t.stop()
