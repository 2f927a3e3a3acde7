"""DeploymentHandle + Router: client-side replica scheduling.

Reference: python/ray/serve/handle.py:86 (RayServeHandle) and
_private/router.py:262 (PowerOfTwoChoicesReplicaScheduler). The router
keeps a local in-flight counter per replica and picks the less-loaded of
two random candidates. Replica-set changes are PUSHED from the controller
over a pending long-poll call (ref: _private/long_poll.py:69 LongPollClient
— one blocking RPC held open per channel instead of a 5 s timer), so a
deploy/scale/replica-death propagates to every router in one RPC round
trip rather than a poll interval.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

# the longest a router waits for the controller's replica set
REFRESH_TIMEOUT_S = 10.0


class Router:
    """In-flight counts are keyed by replica ACTOR ID, not list index:
    the pushed replacement set reorders/reuses indices, so an index-keyed
    count stranded by a replica death (its done() never ran) would
    permanently bias the power-of-two picker away from whichever healthy
    replica later occupies that slot. Keyed by identity, a dead replica's
    count dies with it (evict pops the key) and survivors keep their real
    counts across set pushes."""

    def __init__(self, deployment_name: str, controller_name: str = "_serve_controller"):
        self.deployment_name = deployment_name
        self.controller_name = controller_name
        self._replicas: List[Any] = []
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._gen = 0
        self._poller_started = False

    @staticmethod
    def _key(replica) -> str:
        return replica._actor_id.hex()

    def _set_replicas(self, replicas: List[Any]):
        """Adopt a new replica set (caller holds self._lock): keep live
        counts for replicas still in the set, drop counts of the gone
        (decrement-on-evict — their in-flight work died with them)."""
        keep = {self._key(r) for r in replicas}
        self._replicas = replicas
        self._inflight = {k: v for k, v in self._inflight.items()
                          if k in keep}

    def _ensure_poller(self):
        if self._poller_started:
            return
        self._poller_started = True
        threading.Thread(target=self._poll_loop, daemon=True).start()

    def _poll_loop(self):
        """Long-poll push loop: one pending controller call per router;
        returns immediately when the replica set changes (see
        ServeController.long_poll)."""
        key = f"replicas:{self.deployment_name}"
        while True:
            try:
                controller = ray_tpu_torch.get_actor(self.controller_name,
                                                     namespace="serve")
                res = ray_tpu_torch.get(
                    controller.long_poll.remote(key, self._gen, 10.0),
                    timeout=30)
                changed = res["gen"] != self._gen
                self._gen = res["gen"]
                if changed and res["value"] is not None:
                    with self._lock:
                        self._set_replicas(res["value"])
                        self._last_refresh = time.time()
            except Exception:
                # controller down/restarting: back off, then re-resolve
                # the (possibly restarted) named actor and re-subscribe
                time.sleep(1.0)

    def _refresh(self, force: bool = False):
        now = time.time()
        if not force and self._replicas:
            return
        controller = ray_tpu_torch.get_actor(self.controller_name, namespace="serve")
        # bounded (the reference waits without one): a controller that
        # does not answer fails this request instead of hanging it past
        # its client's deadline
        replicas = ray_tpu_torch.get(
            controller.get_replicas.remote(self.deployment_name),
            timeout=REFRESH_TIMEOUT_S)
        with self._lock:
            self._set_replicas(replicas)
            self._last_refresh = now

    def pick(self) -> tuple:
        self._ensure_poller()
        self._refresh()
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                raise RuntimeError(
                    f"no replicas for deployment {self.deployment_name!r}")
            if n == 1:
                i = 0
            else:
                a, b = random.sample(range(n), 2)
                ka = self._key(self._replicas[a])
                kb = self._key(self._replicas[b])
                i = (a if self._inflight.get(ka, 0)
                     <= self._inflight.get(kb, 0) else b)
            key = self._key(self._replicas[i])
            self._inflight[key] = self._inflight.get(key, 0) + 1
            return key, self._replicas[i]

    def done(self, key: str):
        with self._lock:
            if self._inflight.get(key, 0) > 0:
                self._inflight[key] -= 1

    def evict(self, actor_hex: Optional[str]):
        """Drop a dead replica from the local set IMMEDIATELY (ref:
        router.py on-ActorDiedError eviction): a retry must not wait for
        the controller's next health probe to stop targeting it. The
        pushed replacement set supersedes this on arrival; survivors keep
        their in-flight counts, the dead replica's count is discarded."""
        if not actor_hex:
            return
        with self._lock:
            keep = [r for r in self._replicas
                    if r._actor_id.hex() != actor_hex]
            if len(keep) != len(self._replicas):
                self._set_replicas(keep)


class DeploymentHandle:
    """Serializable; rebuilds its router lazily in the holding process."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        self._router: Optional[Router] = None
        self._context: dict = {}
        self._stream = False

    def _get_router(self) -> Router:
        if self._router is None:
            self._router = Router(self.deployment_name)
        return self._router

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                tenant: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        """Per-call options (ref: handle.options(multiplexed_model_id=...,
        stream=True)). stream=True makes .remote() return an
        ObjectRefGenerator of the handler's yielded items. tenant tags
        the call for the router's weighted-fair admission and rides the
        same context channel as the model id."""
        h = DeploymentHandle(self.deployment_name)
        h._router = self._get_router()     # share router state
        h._context = dict(self._context)
        h._stream = self._stream if stream is None else stream
        if multiplexed_model_id is not None:
            h._context["multiplexed_model_id"] = multiplexed_model_id
        if tenant is not None:
            h._context["tenant"] = tenant
        return h

    def remote(self, *args, **kwargs):
        return self._call("__call__", args, kwargs)

    def method(self, name: str):
        handle = self

        class _M:
            def remote(self, *args, **kwargs):
                return handle._call(name, args, kwargs)

        return _M()

    def _call(self, method: str, args, kwargs):
        router = self._get_router()
        entry = ("handle_request_streaming" if getattr(self, "_stream", False)
                 else "handle_request")
        for attempt in range(3):
            key, replica = router.pick()
            try:
                ref = getattr(replica, entry).remote(
                    method, args, kwargs, self._context or None)
                router.done(key)
                return ref
            except (ray_tpu_torch.exceptions.ActorDiedError,
                    ray_tpu_torch.exceptions.ActorUnavailableError) as e:
                router.done(key)
                router.evict(getattr(e, "actor_id", None))
                if not router._replicas:
                    router._refresh(force=True)
        raise RuntimeError(
            f"could not reach a replica of {self.deployment_name}")

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name,))

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_name!r})"
