"""The rl_offpolicy phase's fixtures, ``chip_smoke.CartPole`` and
``chip_smoke.Pendulum`` (gymnasium's CartPole-v1 and Pendulum-v1 in numpy:
gymnasium is not installed beside the card), against gymnasium's own envs
step for step; and ``ray_tpu_torch.rl.pixel_env.Box``/``Discrete``'s
``seed``/``sample`` against gymnasium's spaces.

Each env pair is reset with the same seed, its action spaces seeded alike,
and stepped 500 times with the same sampled actions, across several
episodes (a reset without a seed after each end, as the rollout workers
do): observations within OBS_TOL, rewards and terminated/truncated equal.
"""

import numpy as np
import pytest

import chip_smoke
from ray_tpu_torch.rl.pixel_env import Box, Discrete

# the same float64 dynamics in numpy on both sides, the observation cast
# to f32: equal in practice; 1e-6 leaves room for a libm's last bit
OBS_TOL = 1e-6


@pytest.mark.parametrize("name,cls,min_episodes", [
    ("CartPole-v1", chip_smoke.CartPole, 10),
    ("Pendulum-v1", chip_smoke.Pendulum, 2)], ids=["cartpole", "pendulum"])
@pytest.mark.parametrize("seed", [0, 7])
def test_env_steps_like_gymnasium(name, cls, min_episodes, seed):
    import gymnasium as gym

    ref, env = gym.make(name), cls()
    ref.action_space.seed(seed + 100)
    env.action_space.seed(seed + 100)
    ro, _ = ref.reset(seed=seed)
    eo, _ = env.reset(seed=seed)
    np.testing.assert_allclose(eo, ro, rtol=0, atol=OBS_TOL)
    assert eo.dtype == ro.dtype == np.float32
    episodes = 0
    for t in range(500):
        a, b = ref.action_space.sample(), env.action_space.sample()
        np.testing.assert_array_equal(b, a)
        ro, rr, rterm, rtrunc, _ = ref.step(a)
        eo, er, eterm, etrunc, _ = env.step(b)
        np.testing.assert_allclose(eo, ro, rtol=0, atol=OBS_TOL,
                                   err_msg=f"step {t}")
        assert float(er) == float(rr), t
        assert (bool(eterm), bool(etrunc)) == (rterm, rtrunc), t
        if rterm or rtrunc:
            episodes += 1
            ro, _ = ref.reset()
            eo, _ = env.reset()
            np.testing.assert_allclose(eo, ro, rtol=0, atol=OBS_TOL)
    assert episodes >= min_episodes
    for space in ("observation_space", "action_space"):
        r, e = getattr(ref, space), getattr(env, space)
        assert e.shape == r.shape and e.dtype == r.dtype
        if hasattr(r, "n"):
            assert e.n == r.n
        else:
            np.testing.assert_array_equal(e.low, r.low)
            np.testing.assert_array_equal(e.high, r.high)


@pytest.mark.parametrize("low,high,shape,dtype", [
    (-2.0, 2.0, (1,), np.float32), (0, 255, (3, 2), np.uint8),
    (-np.inf, np.inf, (4,), np.float32), (-3, 5, (2,), np.int64),
    (0.0, np.inf, (3,), np.float32)],
    ids=["bounded", "uint8", "unbounded", "int64", "half"])
def test_box_sample_like_gymnasium(low, high, shape, dtype):
    import gymnasium as gym

    ours, ref = Box(low, high, shape, dtype), gym.spaces.Box(low, high, shape,
                                                            dtype)
    assert ours.seed(5) == ref.seed(5)
    for _ in range(10):
        a, b = ours.sample(), ref.sample()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_discrete_sample_like_gymnasium():
    import gymnasium as gym

    ours, ref = Discrete(5), gym.spaces.Discrete(5)
    assert ours.seed(9) == ref.seed(9)
    got = [ours.sample() for _ in range(50)]
    assert got == [ref.sample() for _ in range(50)]
    assert all(isinstance(a, np.int64) for a in got)
    # an unseeded space draws from fresh entropy
    assert 0 <= Discrete(3).sample() < 3
