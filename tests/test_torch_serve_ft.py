"""Serve control-plane fault tolerance + long-poll push.

Reference behaviors under test:
- controller checkpoint/recover (python/ray/serve/controller.py:74,
  _private/deployment_state.py:1097): killing the controller mid-serving
  must lose no deployments, routes, or LIVE replicas (zero redeploys).
- long-poll push (_private/long_poll.py:69,187): config/replica changes
  reach routers in one RPC round trip, not a poll interval.
- router/proxy retry-on-dead-replica (_private/router.py assign+retry).

Port of tests/test_serve_ft.py, aimed at ray_tpu_torch.
"""

import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def _controller():
    return ray_tpu_torch.get_actor("_serve_controller", namespace="serve")


@serve.deployment
class Echo:
    def __call__(self, req):
        if hasattr(req, "query_params"):
            return {"hello": req.query_params.get("name", "world")}
        return {"hello": req}


def test_controller_restart_recovers_without_redeploy(ray_start_regular):
    app = Echo.options(num_replicas=2).bind()
    handle = serve.run(app, route_prefix="/echo")
    assert ray_tpu_torch.get(handle.remote("a"), timeout=60) == {"hello": "a"}

    controller = _controller()
    before = ray_tpu_torch.get(controller.get_replicas.remote("Echo"))
    before_ids = sorted(r._actor_id.hex() for r in before)
    routes_before = ray_tpu_torch.get(controller.get_routes.remote())
    assert routes_before == {"/echo": "Echo"}

    # kill WITHOUT no_restart: max_restarts=-1 brings it back, __init__
    # restores from the GCS KV checkpoint
    ray_tpu_torch.kill(controller, no_restart=False)

    deadline = time.time() + 60
    recovered = None
    while time.time() < deadline:
        try:
            c2 = _controller()
            if ray_tpu_torch.get(c2.ping.remote(), timeout=5) == "pong":
                recovered = c2
                break
        except Exception:
            time.sleep(0.2)
    assert recovered is not None, "controller did not restart"

    # deployments + routes recovered, replicas ADOPTED (same actor ids —
    # zero redeploys)
    deadline = time.time() + 30
    after_ids = []
    while time.time() < deadline:
        after = ray_tpu_torch.get(recovered.get_replicas.remote("Echo"))
        after_ids = sorted(r._actor_id.hex() for r in after)
        if len(after_ids) == 2:
            break
        time.sleep(0.2)
    assert after_ids == before_ids, "replicas were redeployed, not adopted"
    assert ray_tpu_torch.get(recovered.get_routes.remote()) == {"/echo": "Echo"}
    # and it still serves
    assert ray_tpu_torch.get(handle.remote("b"), timeout=60) == {"hello": "b"}


def test_longpoll_pushes_replica_changes_fast(ray_start_regular):
    app = Echo.options(name="EchoPush", num_replicas=1).bind()
    handle = serve.run(app)
    assert ray_tpu_torch.get(handle.remote("x"), timeout=60) == {"hello": "x"}
    router = handle._get_router()
    assert len(router._replicas) == 1

    # scale 1 -> 3 by redeploying with a new num_replicas; the router must
    # see the change via push, far faster than the old 5 s poll timer
    serve.run(Echo.options(name="EchoPush", num_replicas=3).bind())
    deadline = time.time() + 4.0
    t0 = time.time()
    while time.time() < deadline and len(router._replicas) != 3:
        time.sleep(0.05)
    waited = time.time() - t0
    assert len(router._replicas) == 3, "router never saw the scale-up"
    assert waited < 4.0, f"push took {waited:.2f}s (poll-timer territory)"


def test_kill_replica_requests_survive_http(ray_start_regular):
    app = Echo.options(name="EchoHttp", num_replicas=2).bind()
    serve.run(app, route_prefix="/ehttp")
    port = serve.start()

    def get_ok():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/ehttp?name=z", timeout=30) as r:
            assert r.status == 200
            return r.read()

    assert b"z" in get_ok()

    controller = _controller()
    victim = ray_tpu_torch.get(controller.get_replicas.remote("EchoHttp"))[0]
    ray_tpu_torch.kill(victim)

    # every request through the dead-replica window must still succeed
    # (proxy retry-on-dead + pushed replacement set)
    for _ in range(10):
        assert b"z" in get_ok()

    # the control loop replaces the dead replica
    deadline = time.time() + 30
    while time.time() < deadline:
        if len(ray_tpu_torch.get(
                controller.get_replicas.remote("EchoHttp"))) == 2:
            break
        time.sleep(0.2)
    assert len(ray_tpu_torch.get(
        controller.get_replicas.remote("EchoHttp"))) == 2


def test_kill_replica_queued_posts_survive_http(ray_start_regular):
    """Non-idempotent requests that were never dispatched to the dead
    replica re-route instead of surfacing a 500 (ref: router.py
    re-dispatches queued-but-unsent requests regardless of verb), and
    each executes exactly once — no drops, no duplicates."""

    @ray_tpu_torch.remote(num_cpus=0)
    class HitCounter:
        def __init__(self):
            self.n = 0

        def hit(self):
            self.n += 1
            return self.n

        def count(self):
            return self.n

    counter = HitCounter.options(name="post_hits", lifetime="detached",
                                 namespace="serve_test").remote()
    ray_tpu_torch.get(counter.count.remote(), timeout=60)

    @serve.deployment
    class Writer:
        def __init__(self):
            self._c = ray_tpu_torch.get_actor("post_hits",
                                        namespace="serve_test")

        def __call__(self, req):
            n = ray_tpu_torch.get(self._c.hit.remote(), timeout=30)
            return {"wrote": n}

    serve.run(Writer.options(name="Writer", num_replicas=2).bind(),
              route_prefix="/writer")
    port = serve.start()

    def post_ok():
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/writer", data=b'{"v": 1}',
            method="POST"), timeout=60)
        assert r.status == 200
        return r.read()

    assert b"wrote" in post_ok()
    base = ray_tpu_torch.get(counter.count.remote(), timeout=30)

    controller = _controller()
    victim = ray_tpu_torch.get(controller.get_replicas.remote("Writer"))[0]
    ray_tpu_torch.kill(victim)
    # wait until the replica is provably DEAD so the proxy's next pick of
    # the corpse fails at SEND time (dispatched=False ⇒ retryable verb-
    # independently); a request racing the in-flight window would rightly
    # surface instead (may-have-executed)
    deadline = time.time() + 60
    dead = False
    while time.time() < deadline and not dead:
        try:
            # nonexistent method: RemoteError while alive (side-effect
            # free), ActorDiedError once the kill has landed
            ray_tpu_torch.get(victim.handle_request.remote(
                "__no_such_method__", (), {}, None), timeout=5)
        except ray_tpu_torch.exceptions.ActorDiedError:
            dead = True
        except Exception:
            time.sleep(0.2)
    assert dead, "victim replica never died"

    # every POST through the dead-replica window succeeds exactly once
    n_posts = 8
    for _ in range(n_posts):
        assert b"wrote" in post_ok()
    final = ray_tpu_torch.get(counter.count.remote(), timeout=30)
    assert final - base == n_posts, (
        f"expected exactly {n_posts} post hits, got {final - base} "
        "(drop or duplicate)")
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("post_hits", namespace="serve_test"))


def test_autoscale_windows_unit():
    """Windowed autoscale decision logic: look-back average + up/down
    delays (ref: _private/autoscaling_policy.py), no cluster needed."""
    from ray_tpu_torch.serve.controller import ServeController

    cls = ServeController._cls
    c = object.__new__(cls)
    c._qhist, c._pending_scale = {}, {}
    d = {"config": {"autoscaling_config": {
        "target_num_ongoing_requests_per_replica": 2,
        "min_replicas": 1, "max_replicas": 8,
        "look_back_period_s": 10.0,
        "upscale_delay_s": 0.2, "downscale_delay_s": 0.4}},
        "replicas": [object()]}

    # sustained load: first ticks arm the delay, then the decision fires
    assert cls._autoscale_decision(c, "d", d, 8) is None   # pending up
    time.sleep(0.25)
    want = cls._autoscale_decision(c, "d", d, 8)
    assert want is not None and want > 1

    # a momentary spike must NOT scale (delay not yet served)
    c2 = object.__new__(cls)
    c2._qhist, c2._pending_scale = {}, {}
    assert cls._autoscale_decision(c2, "d", d, 100) is None

    # downscale honors its own (longer) delay
    d3 = {"config": d["config"], "replicas": [object()] * 4}
    c3 = object.__new__(cls)
    c3._qhist, c3._pending_scale = {}, {}
    assert cls._autoscale_decision(c3, "d", d3, 0) is None  # pending down
    time.sleep(0.25)
    assert cls._autoscale_decision(c3, "d", d3, 0) is None  # still pending
    time.sleep(0.25)
    want = cls._autoscale_decision(c3, "d", d3, 0)
    assert want == 1


def test_router_refresh_has_a_deadline(ray_start_regular, monkeypatch):
    """Q5 (ROADMAP.md queue 3): a router's replica-set refresh against a
    controller that never answers raises within REFRESH_TIMEOUT_S (the
    reference's get has no timeout, so a request could hang past its
    client's deadline)."""
    from ray_tpu_torch.core.status import GetTimeoutError
    from ray_tpu_torch.serve import handle

    monkeypatch.setattr(handle, "REFRESH_TIMEOUT_S", 1.0)

    @ray_tpu_torch.remote(max_concurrency=4)
    class Silent:
        def ping(self):
            return True

        def get_replicas(self, name):
            time.sleep(60)

    ctl = Silent.options(name="_silent_ctl", namespace="serve").remote()
    ray_tpu_torch.get(ctl.ping.remote(), timeout=60)
    router = handle.Router("d", controller_name="_silent_ctl")
    t0 = time.time()
    with pytest.raises(GetTimeoutError):
        router._refresh(force=True)
    assert time.time() - t0 < 5.0
    ray_tpu_torch.kill(ctl)


def test_call_to_actor_stuck_restarting_has_a_deadline(ray_start_regular,
                                                       monkeypatch,
                                                       tmp_path):
    """Q5: a call to an actor the GCS holds in RESTARTING (its restarted
    __init__ hangs) fails with ActorUnavailableError, naming the actor,
    after ACTOR_RESTART_WAIT_S, so that the HTTP proxy's retry loop
    re-picks a replica; the reference waits until the restart ends."""
    import os
    import signal

    from ray_tpu_torch.core import runtime as _rt
    from ray_tpu_torch.core.status import ActorUnavailableError

    monkeypatch.setattr(_rt, "ACTOR_RESTART_WAIT_S", 2.0)
    marker = tmp_path / "started"

    @ray_tpu_torch.remote(max_restarts=1)
    class Flaky:
        def __init__(self, marker):
            import os
            import time

            if os.path.exists(marker):
                time.sleep(40)          # the restart hangs
            open(marker, "w").close()

        def pid(self):
            import os

            return os.getpid()

    a = Flaky.remote(str(marker))
    pid = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 30
    while time.time() < deadline and _rt.get_runtime().gcs_call(
            "get_actor", actor_id=a._actor_id)["state"] != "RESTARTING":
        time.sleep(0.1)
    t0 = time.time()
    with pytest.raises(ActorUnavailableError) as ei:
        ray_tpu_torch.get(a.pid.remote(), timeout=30)
    assert time.time() - t0 < 10.0
    assert ei.value.actor_id == a._actor_id.hex()
    ray_tpu_torch.kill(a)
