"""Policy server/client: RL where the environment lives OUTSIDE the
cluster.

Port of ``ray_tpu/rl/policy_server.py``. Reference: rllib's external-env stack — env/external_env.py,
env/policy_server_input.py (REST server the trainer reads experiences
from) and env/policy_client.py (external simulator asks for actions,
logs rewards). The classic example: a game server calls
start_episode/get_action/log_returns/end_episode against a learning
cluster (rllib/examples/serving/cartpole_server.py).

Shape here: the PolicyServer is a TCP JSON-frame service (same framing
as the client gateway) embedded in the trainer process; external
PolicyClients drive episodes; the trainer consumes completed episodes
per iteration and pushes fresh weights back into the server. Inference
stays on the CPU (tiny policies, CPU copies of the weights); the learner
update is the same PPO step as everywhere else, on the learner's device.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.core import Adam, Algorithm, to_device, to_host
from ray_tpu_torch.rl.ppo import (categorical_sample, compute_gae,
                                  init_policy, make_ppo_update,
                                  policy_forward, read_aux, run_ppo_epochs)


class _Episode:
    def __init__(self, eid: int):
        self.eid = eid
        self.obs: List[np.ndarray] = []
        self.actions: List[int] = []
        self.logps: List[float] = []
        self.values: List[float] = []
        self.rewards: List[float] = []
        self.pending_reward = 0.0


class PolicyServer:
    """Serves get_action to external clients and accumulates completed
    episodes for the trainer (ref: PolicyServerInput)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.params = None        # CPU tensors, set by the trainer
        self.lock = threading.Lock()
        self._episodes: Dict[int, _Episode] = {}
        self._completed: List[_Episode] = []
        self._next_eid = 0
        self._rng = np.random.default_rng(0)

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                session: set = set()   # episode ids opened on this conn
                try:
                    while True:
                        line = self.rfile.readline()
                        if not line:
                            return
                        try:
                            req = json.loads(line)
                            out = outer._dispatch(req, session)
                        except Exception as e:
                            out = {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"}
                        self.wfile.write((json.dumps(out) + "\n").encode())
                        self.wfile.flush()
                finally:
                    # a disconnecting client abandons its open episodes;
                    # drop them or they leak forever
                    outer._abandon(session)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- protocol

    def _dispatch(self, req: dict, session: Optional[set] = None) -> dict:
        m = req.get("method")
        if m == "start_episode":
            with self.lock:
                eid = self._next_eid
                self._next_eid += 1
                self._episodes[eid] = _Episode(eid)
            if session is not None:
                session.add(eid)
            return {"ok": True, "episode_id": eid}
        if m == "get_action":
            return self._get_action(int(req["episode_id"]),
                                    np.asarray(req["obs"], np.float32))
        if m == "log_returns":
            with self.lock:
                ep = self._episodes[int(req["episode_id"])]
                ep.pending_reward += float(req["reward"])
            return {"ok": True}
        if m == "end_episode":
            with self.lock:
                ep = self._episodes.pop(int(req["episode_id"]))
                if ep.actions:
                    ep.rewards.append(ep.pending_reward)
                    self._completed.append(ep)
            if session is not None:
                session.discard(int(req["episode_id"]))
            return {"ok": True}
        raise ValueError(f"unknown method {m!r}")

    def _abandon(self, eids: set):
        with self.lock:
            for eid in eids:
                self._episodes.pop(eid, None)

    def _get_action(self, eid: int, obs: np.ndarray) -> dict:
        # Forward + sample FIRST; episode state only mutates on success
        # (a failed call must not desync rewards from actions).
        with self.lock:
            params = self.params
        if params is None:
            raise RuntimeError("server has no policy weights yet")
        with torch.inference_mode():
            logits, value = policy_forward(params,
                                           torch.as_tensor(obs)[None])
        with self.lock:
            # the shared Generator must not race across handler threads
            a, logp = categorical_sample(logits[0].numpy(), self._rng)
            ep = self._episodes[eid]
            if ep.actions:
                # reward accumulated since the last action closes that step
                ep.rewards.append(ep.pending_reward)
            ep.pending_reward = 0.0
            ep.obs.append(obs)
            ep.actions.append(a)
            ep.logps.append(logp)
            ep.values.append(float(value[0]))
        return {"ok": True, "action": a}

    # -------------------------------------------------------- trainer side

    def set_weights(self, params):
        """`params`: the policy's CPU tensors (the server's forwards run
        on the CPU, one observation at a time)."""
        with self.lock:
            self.params = params

    def drain_episodes(self, min_steps: int = 1,
                       timeout_s: float = 60.0) -> List[_Episode]:
        """Block until at least min_steps of completed experience exist,
        then take everything (ref: PolicyServerInput.next batching)."""
        import time

        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self.lock:
                steps = sum(len(e.actions) for e in self._completed)
                if steps >= min_steps:
                    out, self._completed = self._completed, []
                    return out
            time.sleep(0.02)
        with self.lock:
            out, self._completed = self._completed, []
        return out

    def shutdown(self):
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass


class PolicyClient:
    """External-simulator side (ref: env/policy_client.py). Line-JSON
    over TCP; one connection, synchronous."""

    def __init__(self, address: Tuple[str, int] | str):
        if isinstance(address, str):
            h, _, p = address.rpartition(":")
            address = (h, int(p))
        self._sock = socket.create_connection(address)
        self._f = self._sock.makefile("rw", encoding="utf-8")

    def _call(self, method: str, **kw) -> dict:
        kw["method"] = method
        self._f.write(json.dumps(kw) + "\n")
        self._f.flush()
        resp = json.loads(self._f.readline())
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "policy server error"))
        return resp

    def start_episode(self) -> int:
        return self._call("start_episode")["episode_id"]

    def get_action(self, episode_id: int, obs) -> int:
        return self._call("get_action", episode_id=episode_id,
                          obs=np.asarray(obs, np.float32).tolist())["action"]

    def log_returns(self, episode_id: int, reward: float):
        self._call("log_returns", episode_id=episode_id,
                   reward=float(reward))

    def end_episode(self, episode_id: int):
        self._call("end_episode", episode_id=episode_id)

    def close(self):
        try:
            self._sock.close()
        except Exception:
            pass


@dataclass
class ExternalPPOConfig:
    obs_dim: int = 0
    n_actions: int = 0
    train_batch_size: int = 256
    num_epochs: int = 4
    minibatch_size: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    host: str = "0.0.0.0"
    port: int = 0
    # the learner's device: None means CUDA (an error without it)
    device: Optional[str] = None


class ExternalPPOTrainer(Algorithm):
    """PPO learning from external clients (ref: the server half of
    rllib's cartpole_server example — same update as PPOTrainer,
    experiences arrive over the wire instead of from rollout actors)."""

    def _setup(self, cfg: ExternalPPOConfig):
        self.device = ray_tpu_torch.resolve_device(cfg.device)
        self.params = to_device(init_policy(
            torch.Generator().manual_seed(cfg.seed), cfg.obs_dim,
            cfg.n_actions, cfg.hidden), self.device)
        self.opt = Adam(cfg.lr)
        self.opt_state = None
        self._update = make_ppo_update(cfg, self.opt)
        self.server = PolicyServer(cfg.host, cfg.port)
        self.server.set_weights(to_host(self.params))
        self.workers = []
        self.timesteps = 0

    @property
    def address(self) -> Tuple[str, int]:
        return ("127.0.0.1" if self.config.host == "0.0.0.0"
                else self.config.host, self.server.port)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        episodes = self.server.drain_episodes(cfg.train_batch_size)
        if not episodes:
            return {"timesteps_total": self.timesteps, "episodes_this_iter": 0}

        obs, acts, logps, advs, rets, ep_returns = [], [], [], [], [], []
        for ep in episodes:
            b = {"rewards": np.asarray(ep.rewards, np.float32),
                 "dones": np.zeros(len(ep.actions), np.bool_),
                 "values": np.asarray(ep.values, np.float32),
                 "last_value": 0.0}
            b["dones"][-1] = True        # episodes arrive complete
            adv, ret = compute_gae(b, cfg.gamma, cfg.lam)
            obs.append(np.stack(ep.obs))
            acts.append(np.asarray(ep.actions, np.int32))
            logps.append(np.asarray(ep.logps, np.float32))
            advs.append(adv)
            rets.append(ret)
            ep_returns.append(float(np.sum(ep.rewards)))
        obs = np.concatenate(obs)
        self.timesteps += len(obs)
        self.params, self.opt_state, aux = run_ppo_epochs(
            self._update, self.params, self.opt_state,
            obs=obs, actions=np.concatenate(acts),
            logp=np.concatenate(logps), adv=np.concatenate(advs),
            returns=np.concatenate(rets), num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size, seed=self.iteration)
        self.server.set_weights(to_host(self.params))
        return {
            "timesteps_total": self.timesteps,
            "episodes_this_iter": len(episodes),
            "episode_return_mean": float(np.mean(ep_returns)),
            **read_aux(aux),
        }

    def get_weights(self):
        return self.params

    def set_weights(self, weights):
        self.params = to_device(weights, self.device)
        self.server.set_weights(to_host(self.params))

    def stop(self):
        self.server.shutdown()
