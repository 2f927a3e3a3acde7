"""AlphaZero: MCTS self-play with a policy/value network.

Port of ``ray_tpu/rl/alpha_zero.py`` (reference: rllib/algorithms/
alpha_zero/ (alpha_zero.py, mcts.py, ranked_rewards.py — Silver et al.:
rollout workers run PUCT tree search guided by the current network to
generate (state, visit-distribution, outcome) targets; the learner fits
policy cross-entropy + value MSE)). The game (``TicTacToe``, the
reference tests' env, rllib/examples/env/tic_tac_toe.py) and the tree
search stay numpy on CPU self-play actors, whose network evaluations run
as torch on the CPU under ``torch.inference_mode()``; the network and its
Adam state live on the learner's device (CUDA unless
``AlphaZeroConfig.device`` is "cpu").
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import (CPU_WORKER_ENV, Adam, Algorithm,
                                   ReplayBuffer, make_update,
                                   minibatch_to_device, mlp_forward,
                                   mlp_init, placement, to_device,
                                   to_host)


# --- game: TicTacToe ---------------------------------------------------------


class TicTacToe:
    """Two-player zero-sum board game with the minimal interface MCTS
    needs: clone/step/legal_actions/outcome, canonical obs from the
    current player's perspective."""

    def __init__(self):
        self.board = np.zeros(9, np.int8)   # +1 / -1 / 0
        self.player = 1

    def clone(self) -> "TicTacToe":
        g = TicTacToe()
        g.board = self.board.copy()
        g.player = self.player
        return g

    def legal_actions(self) -> np.ndarray:
        return np.flatnonzero(self.board == 0)

    def step(self, action: int):
        assert self.board[action] == 0
        self.board[action] = self.player
        self.player = -self.player

    _LINES = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
              (2, 5, 8), (0, 4, 8), (2, 4, 6)]

    def outcome(self) -> Optional[int]:
        """+1/-1 for the winning MARK, 0 draw, None if ongoing."""
        for a, b, c in self._LINES:
            s = int(self.board[a]) + int(self.board[b]) + int(self.board[c])
            if s == 3:
                return 1
            if s == -3:
                return -1
        return 0 if not (self.board == 0).any() else None

    def obs(self) -> np.ndarray:
        """Canonical: current player's stones, opponent's stones."""
        mine = (self.board == self.player).astype(np.float32)
        theirs = (self.board == -self.player).astype(np.float32)
        return np.concatenate([mine, theirs])

    N_ACTIONS = 9
    OBS_DIM = 18


# --- network -----------------------------------------------------------------


def init_az_net(gen: torch.Generator, obs_dim: int, n_actions: int,
                hidden: int):
    return {"torso": mlp_init(gen, [obs_dim, hidden, hidden]),
            "pi": mlp_init(gen, [hidden, n_actions], out_scale=0.01),
            "v": mlp_init(gen, [hidden, 1], out_scale=0.01)}


def az_forward(net, obs):
    h = mlp_forward(net["torso"], obs, final_activation=True)
    return mlp_forward(net["pi"], h), torch.tanh(
        mlp_forward(net["v"], h))[..., 0]


def az_loss(net, mb):
    """Policy cross-entropy against the visit distribution plus value MSE
    against the game's outcome; aux holds both terms."""
    logits, v = az_forward(net, mb["obs"])
    pi_loss = -(mb["pi"] * torch.log_softmax(logits, -1)).sum(-1).mean()
    v_loss = torch.square(v - mb["z"]).mean()
    return pi_loss + v_loss, {"pi_loss": pi_loss, "v_loss": v_loss}


# --- MCTS (numpy, worker-side) ----------------------------------------------


class _Node:
    __slots__ = ("prior", "visits", "value_sum", "children")

    def __init__(self, prior: float):
        self.prior = prior
        self.visits = 0
        self.value_sum = 0.0
        self.children: Dict[int, "_Node"] = {}

    def q(self) -> float:
        return self.value_sum / self.visits if self.visits else 0.0


@torch.inference_mode()
def mcts_policy(net, game: TicTacToe, num_sims: int, c_puct: float,
                rng, dirichlet_alpha: float = 0.3,
                root_noise_frac: float = 0.25) -> np.ndarray:
    """PUCT search from `game`; returns the visit distribution over
    actions (ref: rllib mcts.py compute_action). `net`: CPU tensors."""

    def evaluate(g: TicTacToe) -> Tuple[np.ndarray, float]:
        out = g.outcome()
        if out is not None:
            # terminal value from the CURRENT player's perspective:
            # out is for the mark; current player is about to move, so a
            # decided game means the PREVIOUS mover won -> value -1
            return np.zeros(g.N_ACTIONS, np.float32), \
                (0.0 if out == 0 else -1.0)
        logits, v = az_forward(net, torch.from_numpy(g.obs()[None]))
        logits = logits.numpy()[0]
        p = np.exp(logits - logits.max())
        legal = np.zeros(g.N_ACTIONS, np.float32)
        legal[g.legal_actions()] = 1.0
        p = p * legal
        p = p / p.sum() if p.sum() > 0 else legal / legal.sum()
        return p, float(v[0])

    priors, _ = evaluate(game)
    legal = game.legal_actions()
    noise = rng.dirichlet([dirichlet_alpha] * len(legal))
    for i, a in enumerate(legal):
        priors[a] = ((1 - root_noise_frac) * priors[a]
                     + root_noise_frac * noise[i])
    root = _Node(0.0)
    for a in legal:
        root.children[int(a)] = _Node(float(priors[a]))

    for _ in range(num_sims):
        g = game.clone()
        node = root
        path = [root]
        # select
        while node.children:
            total = sum(ch.visits for ch in node.children.values())
            best, best_score = None, -np.inf
            for a, ch in node.children.items():
                u = c_puct * ch.prior * np.sqrt(total + 1) / (1 + ch.visits)
                # child value is from the opponent's perspective
                score = -ch.q() + u
                if score > best_score:
                    best, best_score = a, score
            g.step(best)
            node = node.children[best]
            path.append(node)
        # expand + evaluate
        p, v = evaluate(g)
        if g.outcome() is None:
            for a in g.legal_actions():
                node.children[int(a)] = _Node(float(p[a]))
        # backup: v is from the perspective of the player to move at the
        # leaf; alternate signs up the path
        for n_ in reversed(path):
            n_.visits += 1
            n_.value_sum += v
            v = -v

    visits = np.zeros(game.N_ACTIONS, np.float32)
    for a, ch in root.children.items():
        visits[a] = ch.visits
    return visits / visits.sum()


@ray_tpu_torch.remote
class _SelfPlayWorker:
    def __init__(self, seed: int, num_sims: int, c_puct: float,
                 temperature: float):
        self.rng = np.random.default_rng(seed)
        self.num_sims = num_sims
        self.c_puct = c_puct
        self.temperature = temperature
        self.outcomes: List[int] = []

    def play_games(self, net, n_games: int):
        """`net`: the network's CPU tensors."""
        obs_l, pi_l, z_l = [], [], []
        for _ in range(n_games):
            g = TicTacToe()
            traj = []                      # (obs, pi, player)
            while g.outcome() is None:
                pi = mcts_policy(net, g, self.num_sims, self.c_puct,
                                 self.rng)
                traj.append((g.obs(), pi, g.player))
                if self.temperature > 0:
                    t = pi ** (1.0 / self.temperature)
                    a = int(self.rng.choice(g.N_ACTIONS, p=t / t.sum()))
                else:
                    a = int(pi.argmax())
                g.step(a)
            out = g.outcome()
            self.outcomes.append(out)
            for obs, pi, player in traj:
                obs_l.append(obs)
                pi_l.append(pi)
                z_l.append(float(out * player))   # outcome from mover's view
        return {"obs": np.stack(obs_l), "pi": np.stack(pi_l),
                "z": np.asarray(z_l, np.float32)}

    def placement(self):
        return placement()

    def stats(self):
        o = self.outcomes[-50:]
        return {"games": len(self.outcomes),
                "draw_rate": float(np.mean([x == 0 for x in o]))
                if o else 0.0}


# --- trainer -----------------------------------------------------------------


@dataclass
class AlphaZeroConfig:
    num_rollout_workers: int = 2
    games_per_worker: int = 4
    num_sims: int = 25
    c_puct: float = 1.5
    temperature: float = 1.0
    replay_capacity: int = 10_000
    train_batch_size: int = 128
    updates_per_iter: int = 16
    lr: float = 1e-3
    hidden: int = 64
    seed: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class AlphaZeroTrainer(Algorithm):
    """ref: rllib/algorithms/alpha_zero/alpha_zero.py training_step —
    self-play games into replay, train pi to the visit counts and v to
    the game outcome."""

    def _setup(self, cfg: AlphaZeroConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self.net = to_device(init_az_net(
            torch.Generator().manual_seed(cfg.seed), TicTacToe.OBS_DIM,
            TicTacToe.N_ACTIONS, cfg.hidden), self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = self.opt.init(self.net)
        self.buffer = ReplayBuffer(cfg.replay_capacity, cfg.seed)
        self.workers = [
            _SelfPlayWorker.options(num_cpus=0.5,
                                    runtime_env=CPU_WORKER_ENV).remote(
                cfg.seed + i * 1000, cfg.num_sims, cfg.c_puct,
                cfg.temperature)
            for i in range(cfg.num_rollout_workers)]
        self.games_total = 0
        # aux["total_loss"] is the reference's "loss"
        self._update = make_update(az_loss, self.opt)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        net_host = to_host(self.net)
        refs = [w.play_games.remote(net_host, cfg.games_per_worker)
                for w in self.workers]
        for b in ray_tpu_torch.get(refs):
            self.buffer.add_batch(b)
        self.games_total += cfg.games_per_worker * len(self.workers)
        t1 = time.time()

        aux = {}
        for _ in range(cfg.updates_per_iter):
            # a fixed batch size, sampling with replacement while the
            # buffer is small (as the reference)
            mb = minibatch_to_device(
                self.buffer.sample(cfg.train_batch_size), self.device)
            self.net, self.opt_state, aux = self._update(
                self.net, self.opt_state, mb)
        losses = {}
        if aux:                             # waits for the device
            losses = {"loss": float(aux["total_loss"]),
                      "pi_loss": float(aux["pi_loss"]),
                      "v_loss": float(aux["v_loss"])}
        t2 = time.time()
        stats = ray_tpu_torch.get([w.stats.remote() for w in self.workers])
        return {"games_total": self.games_total,
                "draw_rate": float(np.mean([s["draw_rate"]
                                            for s in stats])),
                "buffer_size": len(self.buffer),
                **losses,
                "sample_time_s": t1 - t0,
                "learn_time_s": t2 - t1}

    def get_weights(self):
        return self.net

    def set_weights(self, weights):
        self.net = to_device(weights, self.device)
