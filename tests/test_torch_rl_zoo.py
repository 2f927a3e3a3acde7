"""The ported on-policy algorithms (ray_tpu_torch/rl/), mirroring the JAX
package's zoo cases of them: test_impala_trains and test_a2c_trains
(tests/test_rl_zoo.py), test_appo_trains (test_rl_zoo2.py), test_pg_trains
and test_a3c_trains_async (test_rl_zoo3.py), test_ddppo_trains
(test_rl_zoo4.py), with the registry and the replay buffer (test_rl_zoo.py).
Same contract (ref: rllib/algorithms/*/tests/): a few training iterations
run, metrics are finite, weights move, save/restore round-trips. Learners
on the CPU (``device="cpu"``)."""

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


def test_registry():
    from ray_tpu_torch.rl import get_algorithm

    for name in ("PPO", "IMPALA", "A2C", "MultiAgentPPO", "APPO", "PG",
                 "A3C", "DDPPO"):
        cfg_cls, trainer_cls = get_algorithm(name)
        assert cfg_cls.__name__.endswith("Config")
        assert trainer_cls.__name__.endswith("Trainer")
    with pytest.raises(ValueError):
        get_algorithm("NOPE")


@pytest.mark.parametrize("name", ["QMIX", "MADDPG", "MAML", "AlphaZero",
                                  "SlateQ"])
def test_registry_unported_raises(name):
    """The five names that were the last to port (they raised
    NotImplementedError until then) resolve to the port's own config and
    trainer, in the module that ports the reference's."""
    import ray_tpu_torch.rl as rl

    cfg_cls, trainer_cls = rl.get_algorithm(name)
    assert trainer_cls.__name__ == f"{name}Trainer"
    assert cfg_cls.__name__ == f"{name}Config"
    assert trainer_cls.__module__.startswith("ray_tpu_torch.rl.")
    assert getattr(rl, f"{name}Trainer") is trainer_cls


def test_registry_covers_the_reference():
    """The port's registered names and the ones still to port (none now)
    are, together, the reference's registry (ray_tpu/rl/__init__.py's
    ``_REGISTRY`` keys, read from its source), and the two never
    overlap."""
    import ast
    from pathlib import Path

    from ray_tpu_torch.rl import _NOT_PORTED, _REGISTRY

    src = Path(__file__).resolve().parents[1] / "ray_tpu" / "rl" / \
        "__init__.py"
    tree = ast.parse(src.read_text())
    reg = next(n.value for n in tree.body if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "_REGISTRY")
    ref_names = {k.value for k in reg.keys}
    assert len(ref_names) == 31
    assert not set(_REGISTRY) & set(_NOT_PORTED)
    assert set(_REGISTRY) | set(_NOT_PORTED) == ref_names
    assert len(_REGISTRY) == 31 and not _NOT_PORTED


def test_replay_buffer_roundtrip():
    from ray_tpu_torch.rl import ReplayBuffer

    buf = ReplayBuffer(capacity=5, seed=0)
    for i in range(3):
        buf.add_batch({"x": np.full((3, 2), i, np.float32),
                       "a": np.arange(3)})
    assert len(buf) == 5
    s = buf.sample(16)
    assert s["x"].shape == (16, 2) and s["a"].shape == (16,)
    # FIFO: the first batch's rows are overwritten but for none
    assert set(np.unique(s["x"])) <= {1.0, 2.0}


def test_impala_trains(ray_start_regular):
    from ray_tpu_torch.rl import ImpalaConfig, ImpalaTrainer

    cfg = ImpalaConfig(num_rollout_workers=2, rollout_fragment_length=80,
                       batches_per_iter=3, device="cpu")
    t = ImpalaTrainer(cfg)
    try:
        r = t.train()
        assert r["batches_consumed"] == 3
        assert r["timesteps_total"] == 240
        assert np.isfinite(r["total_loss"])
        r = t.train()
        assert r["timesteps_total"] == 480
    finally:
        t.stop()


def test_a2c_trains(ray_start_regular):
    from ray_tpu_torch.rl import A2CConfig, A2CTrainer

    cfg = A2CConfig(num_rollout_workers=2, rollout_fragment_length=64,
                    device="cpu")
    t = A2CTrainer(cfg)
    try:
        w0 = to_host(t.get_weights())
        r = t.train()
        assert r["timesteps_total"] == 128
        assert np.isfinite(r["loss"]) and np.isfinite(r["entropy"])
        assert not _tree_equal(t.get_weights(), w0)
        ckpt = t.save()
        w1 = to_host(t.get_weights())
        t.train()
        assert not _tree_equal(t.get_weights(), w1)
        t.restore(ckpt)
        assert _tree_equal(t.get_weights(), w1)
        assert t.iteration == 1
    finally:
        t.stop()


def test_appo_trains(ray_start_regular):
    from ray_tpu_torch.rl import APPOConfig, APPOTrainer

    cfg = APPOConfig(num_rollout_workers=2, rollout_fragment_length=50,
                     batches_per_iter=3, target_update_freq=2, device="cpu")
    t = APPOTrainer(cfg)
    try:
        for _ in range(2):
            r = t.train()
        assert r["timesteps_total"] > 0
        assert np.isfinite(r["total_loss"])
        assert r["num_updates"] >= 2
        # the target network is a copy, refreshed every 2 updates: after
        # 6 it equals the params
        assert _tree_equal(t.target, t.params)
        assert t.target["pi"]["w"] is not t.params["pi"]["w"]
        ckpt = t.save()
        t.set_weights({k: v for k, v in ckpt["params"].items()})
        assert _tree_equal(t.target, ckpt["params"])
    finally:
        t.stop()


def test_pg_trains(ray_start_regular):
    from ray_tpu_torch.rl import PGConfig, PGTrainer

    t = PGTrainer(PGConfig(num_rollout_workers=2,
                           rollout_fragment_length=64, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        r = t.train()
        assert r["timesteps_total"] == 128
        assert np.isfinite(r["loss"]) and np.isfinite(r["entropy"])
        assert not _tree_equal(t.get_weights(), w0)
    finally:
        t.stop()


def test_a3c_trains_async(ray_start_regular):
    from ray_tpu_torch.rl import A3CConfig, A3CTrainer

    t = A3CTrainer(A3CConfig(num_rollout_workers=2,
                             rollout_fragment_length=32,
                             grads_per_step=4, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        r = t.train()
        # 4 async applies x 32-step fragments
        assert r["timesteps_total"] == 4 * 32
        assert np.isfinite(r["loss"])
        assert not _tree_equal(t.get_weights(), w0)
        r2 = t.train()
        assert r2["timesteps_total"] == 8 * 32
    finally:
        t.stop()


@pytest.mark.parametrize("backend", [None, "auto"],
                         ids=["star", "collective"])
def test_ddppo_trains(ray_start_regular, backend):
    """Driver-side mean (star) and the workers' allreduce over a
    ray_tpu_torch.collective group."""
    from ray_tpu_torch.rl import DDPPOConfig, DDPPOTrainer

    t = DDPPOTrainer(DDPPOConfig(num_rollout_workers=2,
                                 rollout_fragment_length=64,
                                 num_sgd_iter=4, minibatch_size=32,
                                 collective_backend=backend, device="cpu"))
    try:
        w0 = to_host(t.get_weights())
        r = t.train()
        assert r["timesteps_total"] == 128
        assert np.isfinite(r["loss"]) and np.isfinite(r["entropy"])
        assert not _tree_equal(t.get_weights(), w0)
        r2 = t.train()
        assert r2["timesteps_total"] == 256
    finally:
        t.stop()
