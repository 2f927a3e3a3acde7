"""Connectors: composable obs/action transform pipelines for RL.

A copy of ``ray_tpu/rl/connectors.py`` (numpy only). Reference:
rllib/connectors/ — agent connectors (obs preprocessing attached between
env and policy), action connectors (between policy and env), built from
config, stateful (e.g. running mean/std), serializable,
and synchronized from the trainer to every rollout worker
(rllib/connectors/connector.py Connector/ConnectorPipeline;
agent/obs_preproc.py; util/filter.py MeanStdFilter's sync pattern).

Connectors run CPU-side in rollout actors on numpy (the learner on the
card never sees python transforms); stateful connectors expose
mergeable state so the trainer can combine per-worker statistics each
iteration and broadcast the merged state back — the same
collect/merge/broadcast cycle rllib uses for MeanStdFilter.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class Connector:
    """One transform stage. Stateless unless get_state/set_state say
    otherwise; merge_states combines per-worker states trainer-side."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def on_episode_start(self) -> None:
        """Reset per-episode internals (e.g. frame stacks)."""

    def get_state(self) -> Optional[dict]:
        return None

    def set_state(self, state: Optional[dict]) -> None:
        pass

    @staticmethod
    def merge_states(states: Sequence[Optional[dict]]) -> Optional[dict]:
        return states[0] if states else None


class FlattenObs(Connector):
    """ref: rllib flatten preprocessor."""

    def __call__(self, x):
        return np.asarray(x, np.float32).reshape(-1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, x):
        return np.clip(x, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std normalization (ref: rllib MeanStdFilter,
    util/filter.py — parallel Welford merge across workers).

    Sync protocol mirrors rllib's filter buffers: __call__ accumulates
    into BOTH the applied stats and a since-last-sync delta buffer;
    get_state() reports only the delta, set_state() installs the merged
    absolute stats and clears the delta. Reporting absolute states and
    re-merging them every iteration would double-count the shared
    baseline each sync (geometric count growth)."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.eps = eps
        self.clip = clip
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self._d_count = 0.0
        self._d_mean: Optional[np.ndarray] = None
        self._d_m2: Optional[np.ndarray] = None

    @staticmethod
    def _welford(x, count, mean, m2):
        count += 1.0
        delta = x - mean
        mean = mean + delta / count
        m2 = m2 + delta * (x - mean)
        return count, mean, m2

    def __call__(self, x):
        x = np.asarray(x, np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.zeros_like(x)
        if self._d_mean is None:
            self._d_mean = np.zeros_like(x)
            self._d_m2 = np.zeros_like(x)
        self.count, self.mean, self.m2 = self._welford(
            x, self.count, self.mean, self.m2)
        self._d_count, self._d_mean, self._d_m2 = self._welford(
            x, self._d_count, self._d_mean, self._d_m2)
        std = np.sqrt(self.m2 / max(self.count - 1, 1.0)) + self.eps
        out = (x - self.mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        """Delta since the last set_state (rllib's 'buffer')."""
        if self._d_mean is None:
            return {"count": 0.0}
        return {"count": self._d_count, "mean": self._d_mean.copy(),
                "m2": self._d_m2.copy()}

    def set_state(self, state):
        """Install merged ABSOLUTE stats; the delta buffer resets (its
        samples are part of the merge now)."""
        self._d_count = 0.0
        self._d_mean = None
        self._d_m2 = None
        if not state or state.get("count", 0) == 0:
            return
        self.count = float(state["count"])
        self.mean = np.array(state["mean"], np.float64)
        self.m2 = np.array(state["m2"], np.float64)

    @staticmethod
    def merge_states(states):
        """Chan et al. parallel variance combine (what rllib's filters do
        on sync)."""
        states = [s for s in states if s and s.get("count", 0) > 0]
        if not states:
            return {"count": 0.0}
        count = states[0]["count"]
        mean = np.array(states[0]["mean"], np.float64)
        m2 = np.array(states[0]["m2"], np.float64)
        for s in states[1:]:
            nb = s["count"]
            delta = np.asarray(s["mean"], np.float64) - mean
            tot = count + nb
            m2 = m2 + np.asarray(s["m2"], np.float64) \
                + delta ** 2 * count * nb / tot
            mean = mean + delta * nb / tot
            count = tot
        return {"count": count, "mean": mean, "m2": m2}


class GrayscaleObs(Connector):
    """RGB [H, W, 3] -> luma [H, W, 1] (ref: atari_wrappers.py WarpFrame
    grayscale step). Keeps a trailing channel axis so FrameStack stacks
    frames along channels."""

    WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        if x.ndim == 3 and x.shape[-1] == 3:
            x = x @ self.WEIGHTS
        return x[..., None] if x.ndim == 2 else x


class ResizeObs(Connector):
    """Spatial resize for image obs (ref: WarpFrame's cv2.resize — done
    here with block-mean pooling when the ratio divides evenly, else
    nearest-neighbor sampling; no cv2 in the image)."""

    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[..., None]
        H, W, C = x.shape
        if (H, W) == (self.h, self.w):
            out = x
        elif H % self.h == 0 and W % self.w == 0:
            fh, fw = H // self.h, W // self.w
            out = x.reshape(self.h, fh, self.w, fw, C).mean((1, 3))
        else:
            ri = (np.arange(self.h) * H // self.h)
            ci = (np.arange(self.w) * W // self.w)
            out = x[ri][:, ci]
        return out[..., 0] if squeeze else out


class ScaleObs(Connector):
    """Multiply by a constant (e.g. 1/255 for uint8 pixels)."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def __call__(self, x):
        return np.asarray(x, np.float32) * self.scale


class FrameStack(Connector):
    """Stack the last k observations along the feature axis
    (ref: rllib frame-stacking agent connector)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: deque = deque(maxlen=k)

    def on_episode_start(self):
        self._frames.clear()

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        while len(self._frames) < self.k - 1:
            self._frames.append(np.zeros_like(x))
        self._frames.append(x)
        return np.concatenate(list(self._frames), axis=-1)


class ConnectorPipeline(Connector):
    """Ordered composition (ref: ConnectorPipeline in
    rllib/connectors/connector.py)."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def on_episode_start(self):
        for c in self.connectors:
            c.on_episode_start()

    def get_state(self):
        return [c.get_state() for c in self.connectors]

    def set_state(self, state):
        if state is None:
            return
        for c, s in zip(self.connectors, state):
            c.set_state(s)

    def merge_pipeline_states(self, states: Sequence[list],
                              prev: Optional[list] = None) -> list:
        """Combine per-worker DELTA states (get_state lists) with the
        authoritative previous absolute state into the new absolute
        state. Every sample is counted exactly once: history lives only
        in `prev`, workers report only what's new."""
        merged = []
        for i, c in enumerate(self.connectors):
            cand = [prev[i]] if prev is not None else []
            cand += [s[i] for s in states if s is not None]
            merged.append(type(c).merge_states(
                [x for x in cand if x is not None]))
        return merged


def build_pipeline(specs: Optional[List[Any]]) -> ConnectorPipeline:
    """specs: Connector instances or zero-arg factories (configs ship
    factories so each worker gets its own stateful instances)."""
    out = []
    for s in specs or []:
        out.append(s() if callable(s) and not isinstance(s, Connector)
                   else s)
    return ConnectorPipeline(out)
