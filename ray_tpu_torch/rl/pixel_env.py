"""PixelCatcher: a procedurally generated Atari-class pixel environment.

Port of ``ray_tpu/rl/pixel_env.py`` (numpy; the same frames and rewards
for a seed). ALE is not installed, so the Atari north star (BASELINE.json
target 5: PPO Atari, a learner on the card and CPU rollout actors) is
exercised on this env instead: RGB uint8 frames at an Atari-like
resolution, discrete actions, rewards that demand reading ball/paddle
positions out of pixels — the same observation/connector/CNN pipeline an
ALE env would use (grayscale -> resize -> scale -> frame-stack ->
Nature-CNN).

Mechanics: a ball falls from the top at a random column; the agent slides
a paddle along the bottom (left/stay/right). +1 for a catch, -1 for a
miss; `dense_reward=True` adds a small per-step alignment shaping term
(useful for CI-speed learning tests). An episode is `balls_per_episode`
drops.

The reference takes its spaces from ``gymnasium.spaces``; gymnasium is not
known to be installed beside the card, so ``Box`` and ``Discrete`` here
carry what the probes and connectors read (shape, dtype, low/high, n) and
gymnasium's ``seed``/``sample`` (the same draws for a seed), which the
off-policy workers' epsilon and warm-up actions call.

Reference: rllib/env/wrappers/atari_wrappers.py documents the pipeline
this env is designed to feed (WarpFrame/FrameStack); the env itself is
original (the reference ships no procedural pixel env).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class _Space:
    """gymnasium.spaces.Space's generator: ``seed(seed)`` makes
    ``np.random.default_rng(seed)`` (what ``seeding.np_random`` builds);
    an unseeded space seeds itself from fresh entropy at its first
    ``sample``."""

    _np_random: Optional[np.random.Generator] = None

    def seed(self, seed: Optional[int] = None) -> int:
        seq = np.random.SeedSequence(seed)
        self._np_random = np.random.Generator(np.random.PCG64(seq))
        return seq.entropy

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self.seed()
        return self._np_random


class Box(_Space):
    """gymnasium.spaces.Box's fields: a bounded array space."""

    def __init__(self, low, high, shape: Tuple[int, ...], dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def sample(self) -> np.ndarray:
        """gymnasium's Box.sample: uniform on a bounded coordinate, a
        shifted exponential on a half-bounded one, normal on an unbounded
        one, floored and clipped for integer types."""
        high = (self.high if self.dtype.kind == "f"
                else self.high.astype("int64") + 1)
        below, above = -np.inf < self.low, np.inf > self.high
        sample = np.empty(self.shape)
        unbounded, upp = ~below & ~above, ~below & above
        low_b, bounded = below & ~above, below & above
        rng = self.np_random
        sample[unbounded] = rng.normal(size=unbounded[unbounded].shape)
        sample[low_b] = (rng.exponential(size=low_b[low_b].shape)
                         + self.low[low_b])
        sample[upp] = -rng.exponential(size=upp[upp].shape) + high[upp]
        sample[bounded] = rng.uniform(low=self.low[bounded],
                                      high=high[bounded],
                                      size=bounded[bounded].shape)
        if self.dtype.kind in ("i", "u", "b"):
            sample = np.floor(sample)
        if np.issubdtype(self.dtype, np.signedinteger):
            info = np.iinfo(self.dtype)
            sample = sample.clip(info.min + 2, info.max - 2)
        elif np.issubdtype(self.dtype, np.unsignedinteger):
            info = np.iinfo(self.dtype)
            sample = sample.clip(info.min, info.max)
        sample = sample.astype(self.dtype)
        if self.dtype == np.int64:
            sample = sample.clip(self.low, self.high)
        return sample


class Discrete(_Space):
    """gymnasium.spaces.Discrete's fields: actions 0 .. n - 1."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def sample(self) -> np.int64:
        """gymnasium's uniform Discrete.sample."""
        return self.np_random.integers(self.n, dtype=self.dtype.type)


class PixelCatcher:
    """gymnasium-shaped env (reset/step/observation_space/action_space)
    without requiring the gymnasium registry — core.make_env constructs
    it via the "module:Class" path."""

    metadata = {"render_modes": []}

    def __init__(self, size: int = 84, paddle_width: int = 13,
                 ball_size: int = 5, fall_speed: int = 4,
                 paddle_speed: int = 4, balls_per_episode: int = 8,
                 dense_reward: bool = False, seed: Optional[int] = None):
        self.size = size
        self.paddle_width = paddle_width
        self.ball_size = ball_size
        self.fall_speed = fall_speed
        self.paddle_speed = paddle_speed
        self.balls_per_episode = balls_per_episode
        self.dense_reward = dense_reward
        self._rng = np.random.default_rng(seed)
        self.observation_space = Box(0, 255, (size, size, 3), np.uint8)
        self.action_space = Discrete(3)
        self._frame = np.zeros((size, size, 3), np.uint8)

    # -- gymnasium API --------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.paddle_x = self.size // 2
        self.balls_done = 0
        self._new_ball()
        return self._render(), {}

    def step(self, action: int):
        a = int(action)
        if a == 0:
            self.paddle_x -= self.paddle_speed
        elif a == 2:
            self.paddle_x += self.paddle_speed
        half = self.paddle_width // 2
        self.paddle_x = int(np.clip(self.paddle_x, half,
                                    self.size - 1 - half))

        self.ball_y += self.fall_speed
        reward = 0.0
        if self.dense_reward:
            # alignment shaping: in [-0.05, 0.05] per step
            reward += 0.05 * (1.0 - 2.0 * abs(self.ball_x - self.paddle_x)
                              / self.size)
        terminated = False
        if self.ball_y >= self.size - 3 - self.ball_size:
            caught = abs(self.ball_x - self.paddle_x) <= \
                (half + self.ball_size // 2)
            reward += 1.0 if caught else -1.0
            self.balls_done += 1
            if self.balls_done >= self.balls_per_episode:
                terminated = True
            else:
                self._new_ball()
        return self._render(), reward, terminated, False, {}

    def close(self):
        pass

    # -- internals ------------------------------------------------------

    def _new_ball(self):
        m = self.ball_size // 2 + 1
        self.ball_x = int(self._rng.integers(m, self.size - m))
        self.ball_y = 0

    def _render(self) -> np.ndarray:
        f = self._frame
        f[:] = 0
        s, bs = self.size, self.ball_size
        # paddle: light bar on the bottom rows
        half = self.paddle_width // 2
        f[s - 3:s, self.paddle_x - half:self.paddle_x + half + 1] = \
            (64, 192, 255)
        # ball: bright square
        y0 = int(np.clip(self.ball_y, 0, s - bs))
        x0 = int(np.clip(self.ball_x - bs // 2, 0, s - bs))
        f[y0:y0 + bs, x0:x0 + bs] = (255, 255, 64)
        return f.copy()


def atari_connectors(stack: int = 4, out_size: int = 42):
    """The standard pixel pipeline as connector factories (ref:
    atari_wrappers.py WarpFrame+FrameStack): grayscale -> resize ->
    [0,1] scale -> stack along channels. Returns a list suitable for
    PPOConfig.obs_connectors / ImpalaConfig.obs_connectors."""
    from ray_tpu_torch.rl.connectors import (FrameStack, GrayscaleObs,
                                             ResizeObs, ScaleObs)

    return [GrayscaleObs, lambda: ResizeObs(out_size, out_size),
            lambda: ScaleObs(1.0 / 255.0), lambda: FrameStack(stack)]
