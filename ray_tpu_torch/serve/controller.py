"""ServeController + Replica actors.

Reference: python/ray/serve/controller.py:74 (checkpointed controller state
machine), _private/deployment_state.py:1097 (replica FSM, rolling updates,
_scale_deployment_replicas:1537), _private/replica.py, long-poll
control-plane push (_private/long_poll.py:69,187), autoscaling on replica
queue metrics with look-back + up/down delays
(_private/autoscaling_policy.py).

Fault tolerance: the controller persists its deployment table (blobs,
configs, routes, versions, replica ACTOR NAMES) to GCS KV on every
mutation and runs with max_restarts=-1. Replicas are named actors, so a
restarted controller re-adopts the live ones by name — no redeploys, no
dropped replicas (the reference recovers the same way from its KV
checkpoints, controller.py:74-79).
"""

from __future__ import annotations

import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

STATE_KEY = b"controller_state"
_KV_NS = "serve"


@ray_tpu_torch.remote
class Replica:
    """Wraps one instance of the user's deployment callable. Requests enter
    via handle_request; an async-capable wrapper lets @serve.batch and
    async __call__ work; queue depth is tracked for autoscaling."""

    def __init__(self, import_blob: bytes, init_args, init_kwargs,
                 user_config=None):
        import cloudpickle

        cls_or_fn = cloudpickle.loads(import_blob)
        if isinstance(cls_or_fn, type):
            self.instance = cls_or_fn(*init_args, **(init_kwargs or {}))
        else:
            self.instance = cls_or_fn
        self.inflight = 0
        if user_config is not None and hasattr(self.instance,
                                               "reconfigure"):
            self.instance.reconfigure(user_config)

    async def handle_request(self, method: str, args, kwargs,
                             context: dict | None = None):
        self.inflight += 1
        try:
            if context:
                from ray_tpu_torch.serve.multiplex import (_set_multiplexed_model_id,
                                                           _set_request_tenant)

                if "multiplexed_model_id" in context:
                    _set_multiplexed_model_id(context["multiplexed_model_id"])
                if "tenant" in context:
                    _set_request_tenant(context["tenant"])
            import asyncio
            import inspect

            fn = getattr(self.instance, method)
            if inspect.iscoroutinefunction(fn):
                out = await fn(*args, **kwargs)
            else:
                # Sync handlers run on an executor thread (ref:
                # _private/replica.py runs sync callables off the event
                # loop) so they may issue blocking runtime calls — e.g.
                # a composed deployment ray_tpu_torch.get()-ing a child handle.
                out = await asyncio.to_thread(fn, *args, **kwargs)
                if asyncio.iscoroutine(out):
                    out = await out
            return out
        finally:
            self.inflight -= 1

    @ray_tpu_torch.method(num_returns="streaming")
    async def handle_request_streaming(self, method: str, args, kwargs,
                                       context: dict | None = None):
        """Streaming twin of handle_request (ref: the proxy's
        obj-ref-generator calls for response streaming): drives the user
        method — async generator, sync generator, or iterable-returning —
        and yields each item as a stream element."""
        self.inflight += 1
        try:
            if context:
                from ray_tpu_torch.serve.multiplex import (_set_multiplexed_model_id,
                                                           _set_request_tenant)

                if "multiplexed_model_id" in context:
                    _set_multiplexed_model_id(context["multiplexed_model_id"])
                if "tenant" in context:
                    _set_request_tenant(context["tenant"])
            import asyncio
            import inspect

            fn = getattr(self.instance, method)
            if inspect.isasyncgenfunction(fn):
                async for item in fn(*args, **kwargs):
                    yield item
                return
            if inspect.iscoroutinefunction(fn):
                out = await fn(*args, **kwargs)
            else:
                out = await asyncio.to_thread(fn, *args, **kwargs)
            if inspect.isgenerator(out) or (
                    hasattr(out, "__iter__")
                    and not isinstance(out, (str, bytes, dict, list,
                                             tuple))):
                loop = asyncio.get_running_loop()
                _end = object()
                it = iter(out)
                while True:   # sync generator: step off-loop per item
                    item = await loop.run_in_executor(None, next, it, _end)
                    if item is _end:
                        return
                    yield item
            else:
                yield out
        finally:
            self.inflight -= 1

    def queue_len(self) -> int:
        """RPC in-flight count, plus the instance's own backlog when it
        exposes one (LLMServer.queue_len: engine pending + active slots).
        A streaming LLM replica parks few RPCs but can hold many
        generations — autoscaling and drain must see those too."""
        n = self.inflight
        ql = getattr(self.instance, "queue_len", None)
        if callable(ql):
            try:
                n += int(ql())
            except Exception:
                pass
        return n

    def drain(self) -> bool:
        """Tell the instance to stop accepting new work (scale-down
        protocol); returns immediately, in-flight work keeps running."""
        fn = getattr(self.instance, "drain", None)
        if callable(fn):
            try:
                fn()
            except Exception:
                pass
        return True

    def reconfigure(self, user_config):
        if hasattr(self.instance, "reconfigure"):
            self.instance.reconfigure(user_config)
        return True


def _kv_put(key: bytes, value: bytes):
    from ray_tpu_torch.core import runtime as _rt

    _rt.get_runtime().kv_put(_KV_NS, key, value)


def _kv_get(key: bytes) -> Optional[bytes]:
    from ray_tpu_torch.core import runtime as _rt

    return _rt.get_runtime().kv_get(_KV_NS, key)


@ray_tpu_torch.remote
class ServeController:
    """Deployment table + reconcile/autoscale thread
    (ref: controller.py run_control_loop).

    In-memory `deployments[name]` holds live actor handles in "replicas"
    and their names in "replica_names" (parallel lists); the persisted
    checkpoint stores everything EXCEPT the handles."""

    def __init__(self):
        self.deployments: Dict[str, dict] = {}
        self.routes: Dict[str, str] = {}   # route_prefix -> ingress deployment
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # long-poll channels (ref: long_poll.py LongPollHost): generation
        # per key; waiters block on the condition until the key's gen
        # advances past theirs.
        self._gen: Dict[str, int] = {}
        self._poll_cond = threading.Condition()
        # autoscaling look-back samples: name -> list[(ts, total_queue)]
        self._qhist: Dict[str, List[tuple]] = {}
        # pending scale decision: name -> (direction, first_seen_ts, want)
        self._pending_scale: Dict[str, tuple] = {}
        # router-reported load: name -> {reporter: (ts, load)}. LLM
        # routers push their local queue depth here so autoscaling sees
        # demand that was SHED before reaching any replica's queue.
        self._ext_load: Dict[str, Dict[str, tuple]] = {}
        # per-model external load: name -> {reporter: (ts, {model: load})}
        self._ext_mload: Dict[str, Dict[str, tuple]] = {}
        # per-model autoscaling state (multiplexed deployments):
        # look-back samples keyed (name, model), pending-decision delays,
        # in-flight scale ops (one per model at a time), and the last
        # decision table exposed via model_status()
        self._mhist: Dict[tuple, List[tuple]] = {}
        self._pending_mscale: Dict[tuple, tuple] = {}
        self._model_ops: set = set()
        self._model_table: Dict[str, dict] = {}
        self._restore()
        self._thread = threading.Thread(target=self._control_loop, daemon=True)
        self._thread.start()

    # ---- persistence (ref: controller.py:74 checkpointed state) ------------

    def _save(self):
        import cloudpickle

        with self._lock:
            snap = {
                "routes": dict(self.routes),
                "deployments": {
                    name: {k: d[k] for k in
                           ("blob", "args", "kwargs", "config", "version",
                            "replica_names")}
                    for name, d in self.deployments.items()
                },
            }
        try:
            _kv_put(STATE_KEY, cloudpickle.dumps(snap))
        except Exception:
            pass  # KV down: state is still live in-memory; next save retries

    def _restore(self):
        import cloudpickle

        try:
            raw = _kv_get(STATE_KEY)
        except Exception:
            raw = None
        if not raw:
            return
        snap = cloudpickle.loads(raw)
        self.routes = dict(snap.get("routes", {}))
        for name, d in snap.get("deployments", {}).items():
            replicas, names = [], []
            for rn in d.get("replica_names", []):
                # re-adopt replicas that survived the controller crash —
                # zero redeploys for live actors
                try:
                    h = ray_tpu_torch.get_actor(rn, namespace=_KV_NS)
                    ray_tpu_torch.get(h.queue_len.remote(), timeout=5)
                    replicas.append(h)
                    names.append(rn)
                except Exception:
                    pass
            self.deployments[name] = {**d, "replicas": replicas,
                                      "replica_names": names}
        # top up any deployment that lost replicas while we were down
        for name in list(self.deployments):
            self._reconcile(name)

    # ---- long-poll push (ref: long_poll.py:187) ----------------------------

    def _bump(self, key: str):
        with self._poll_cond:
            self._gen[key] = self._gen.get(key, 0) + 1
            self._poll_cond.notify_all()

    def _snapshot(self, key: str):
        if key == "routes":
            return dict(self.routes)
        if key.startswith("replicas:"):
            return self.get_replicas(key.split(":", 1)[1])
        return None

    def long_poll(self, key: str, last_gen: int, timeout: float = 10.0):
        """Block until channel `key`'s generation advances past last_gen
        (or timeout); returns {"gen": g, "value": snapshot}. Routers and
        proxies keep one of these pending instead of polling on a timer —
        a config/replica change propagates in one RPC round trip."""
        deadline = time.time() + timeout
        with self._poll_cond:
            while self._gen.get(key, 0) <= last_gen:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._poll_cond.wait(remaining)
            g = self._gen.get(key, 0)
        return {"gen": g, "value": self._snapshot(key)}

    # ---- API ----------------------------------------------------------------

    def deploy(self, name: str, import_blob: bytes, init_args, init_kwargs,
               config: dict) -> bool:
        with self._lock:
            old = self.deployments.get(name)
            self.deployments[name] = {
                "blob": import_blob, "args": init_args,
                "kwargs": init_kwargs or {}, "config": dict(config),
                "replicas": old["replicas"] if old else [],
                "replica_names": old["replica_names"] if old else [],
                "version": (old["version"] + 1) if old else 0,
            }
        self._reconcile(name, rolling=old is not None)
        self._save()
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            d = self.deployments.pop(name, None)
            self.routes = {p: n for p, n in self.routes.items() if n != name}
        if d:
            for r in d["replicas"]:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        self._save()
        self._bump(f"replicas:{name}")
        self._bump("routes")
        return True

    def get_replicas(self, name: str) -> List[Any]:
        d = self.deployments.get(name)
        return list(d["replicas"]) if d else []

    def set_route(self, route_prefix: str, deployment: str) -> bool:
        with self._lock:
            self.routes[route_prefix] = deployment
        self._save()
        self._bump("routes")
        return True

    def get_routes(self) -> Dict[str, str]:
        return dict(self.routes)

    def list_deployments(self) -> Dict[str, dict]:
        out = {}
        for name, d in self.deployments.items():
            out[name] = {"num_replicas": len(d["replicas"]),
                         "config": d["config"], "version": d["version"]}
        return out

    def report_load(self, name: str, reporter: str, load: float,
                    model_load: Optional[Dict[str, float]] = None) -> bool:
        """Routers push their OWN queue depth (requests admitted by the
        router but not yet placed on a replica). Folded into the
        autoscale total each control tick; stale reporters (a dead
        router) age out after 10 s so they cannot pin the fleet up.
        model_load, when given, is the router's per-model split of that
        depth — the per-model autoscaler's demand signal."""
        with self._lock:
            self._ext_load.setdefault(name, {})[reporter] = (
                time.time(), float(load))
            if model_load is not None:
                self._ext_mload.setdefault(name, {})[reporter] = (
                    time.time(), {str(m): float(v)
                                  for m, v in model_load.items()})
        return True

    def _ext_load_total(self, name: str) -> float:
        now = time.time()
        with self._lock:
            per = self._ext_load.get(name, {})
            stale = [k for k, (ts, _) in per.items() if now - ts > 10.0]
            for k in stale:
                del per[k]
            return sum(load for _, load in per.values())

    def _ext_model_load(self, name: str) -> Dict[str, float]:
        """Aged, summed per-model router demand."""
        now = time.time()
        out: Dict[str, float] = {}
        with self._lock:
            per = self._ext_mload.get(name, {})
            stale = [k for k, (ts, _) in per.items() if now - ts > 10.0]
            for k in stale:
                del per[k]
            for _, (_, d) in per.items():
                for m, v in d.items():
                    out[m] = out.get(m, 0.0) + v
        return out

    def model_status(self, name: str) -> dict:
        """Last per-model autoscale decision table (tests/bench)."""
        return dict(self._model_table.get(name, {}))

    def ping(self) -> str:
        return "pong"

    def shutdown(self) -> bool:
        """Stop the control loop before the actor is killed. Actors can
        be lane-packed into shared worker processes, so a daemon thread
        left spinning outlives its actor and keeps health-probing dead
        replicas forever."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        # wake any parked long-pollers so their handles return instead
        # of riding out the full poll timeout against a dead controller
        with self._poll_cond:
            self._poll_cond.notify_all()
        return not self._thread.is_alive()

    # ---- reconcile ----------------------------------------------------------

    def _make_replica(self, name: str, d: dict):
        cfg = d["config"]
        opts = {"max_concurrency": cfg.get("max_concurrent_queries", 100)}
        if cfg.get("ray_actor_options"):
            opts.update(cfg["ray_actor_options"])
        # named so a restarted controller can re-adopt it (see _restore)
        rname = f"_serve_rep_{name}_{uuid.uuid4().hex[:8]}"
        h = Replica.options(name=rname, namespace=_KV_NS, **opts).remote(
            d["blob"], d["args"], d["kwargs"], cfg.get("user_config"))
        return h, rname

    def _reconcile(self, name: str, rolling: bool = False):
        with self._lock:
            d = self.deployments.get(name)
            if d is None:
                return
            target = int(d["config"].get("num_replicas", 1))
            health_timeout = float(
                d["config"].get("health_check_timeout_s", 30.0))
            replicas = list(d["replicas"])
            names = list(d["replica_names"])
        if rolling:
            # rolling update: replace one at a time; a new replica that
            # fails its readiness deadline ABORTS the update, keeping the
            # old replicas serving (ref: deployment_state.py rolling
            # update + health deadline)
            new, new_names = [], []
            aborted = False
            for i, r in enumerate(replicas):
                nr, nn = self._make_replica(name, d)
                try:
                    ray_tpu_torch.get(nr.queue_len.remote(),
                                      timeout=health_timeout)   # wait ready
                except Exception:
                    try:
                        ray_tpu_torch.kill(nr)
                    except Exception:
                        pass
                    new.extend(replicas[i:])
                    new_names.extend(names[i:])
                    aborted = True
                    break
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
                new.append(nr)
                new_names.append(nn)
            replicas, names = new, new_names
            if aborted:
                with self._lock:
                    if name in self.deployments:
                        self.deployments[name]["replicas"] = replicas
                        self.deployments[name]["replica_names"] = names
                        self.deployments[name]["last_error"] = (
                            "rolling update aborted: new replica failed "
                            f"readiness within {health_timeout}s")
                self._save()
                self._bump(f"replicas:{name}")
                return
        # Scale-up: start all missing replicas concurrently, then
        # readiness-gate EVERY entry to the serving set, not just rolling
        # swaps — after an aborted update the table may hold a blob whose
        # __init__ fails, and scale-up must not hand routers a broken
        # replica. Failures are killed and surfaced via last_error; the
        # control loop retries next tick (ref: deployment_state keeps
        # retrying and surfaces UNHEALTHY, it does not roll back).
        started = [self._make_replica(name, d)
                   for _ in range(max(target - len(replicas), 0))]
        for h, rn in started:
            try:
                ray_tpu_torch.get(h.queue_len.remote(), timeout=health_timeout)
            except Exception as err:   # noqa: BLE001 — any startup failure
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass
                with self._lock:
                    if name in self.deployments:
                        self.deployments[name]["last_error"] = (
                            f"replica failed readiness: {err}")
                continue
            replicas.append(h)
            names.append(rn)
        # Scale-down drains instead of killing: unpublish FIRST (the
        # table update + bump below pushes the shrunk set to every
        # router long-poll, so no new requests target the retiring
        # replicas), then a background thread waits for their in-flight
        # work — mid-stream generations included — before the kill.
        retiring = []
        while len(replicas) > target:
            retiring.append(replicas.pop())
            names.pop()
        with self._lock:
            if name in self.deployments:
                self.deployments[name]["replicas"] = replicas
                self.deployments[name]["replica_names"] = names
        self._save()
        self._bump(f"replicas:{name}")
        if retiring:
            threading.Thread(target=self._drain_then_kill,
                             args=(retiring,), daemon=True).start()

    def _drain_then_kill(self, retiring: List[Any]):
        """Scale-down grace: tell each retiring replica to stop
        admitting (Replica.drain -> instance drain), poll queue_len to 0
        under serve_drain_timeout_s, then kill. A replica that cannot
        drain in time is killed anyway — the bound keeps scale-down from
        hanging behind a wedged stream."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        deadline = time.time() + GLOBAL_CONFIG.serve_drain_timeout_s
        for r in retiring:
            try:
                ray_tpu_torch.get(r.drain.remote(), timeout=5)
            except Exception:
                pass   # dead/unreachable: the kill below still runs
        pending = list(retiring)
        while pending and time.time() < deadline \
                and not self._stop.is_set():
            still = []
            for r in pending:
                try:
                    if ray_tpu_torch.get(r.queue_len.remote(), timeout=5) > 0:
                        still.append(r)
                except Exception:
                    pass   # already dead: drained by definition
            pending = still
            if pending:
                self._stop.wait(0.2)
        for r in retiring:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    # ---- autoscaling (ref: autoscaling_policy.py) --------------------------

    def _autoscale_decision(self, name: str, d: dict, total: int):
        """Look-back averaged queue depth + upscale/downscale delays.
        Returns the target replica count to apply now, or None."""
        auto = d["config"].get("autoscaling_config")
        if not auto:
            return None
        now = time.time()
        look_back = float(auto.get("look_back_period_s", 30.0))
        hist = self._qhist.setdefault(name, [])
        hist.append((now, total))
        while hist and hist[0][0] < now - look_back:
            hist.pop(0)
        avg = sum(q for _, q in hist) / max(len(hist), 1)
        per = auto.get("target_num_ongoing_requests_per_replica", 2)
        cur = len(d["replicas"])
        want = max(auto.get("min_replicas", 1),
                   min(auto.get("max_replicas", 4),
                       int((avg + per - 1) // per) or 1))
        if want == cur:
            self._pending_scale.pop(name, None)
            return None
        direction = "up" if want > cur else "down"
        delay = float(auto.get("upscale_delay_s", 30.0) if direction == "up"
                      else auto.get("downscale_delay_s", 600.0))
        pend = self._pending_scale.get(name)
        if pend is None or pend[0] != direction:
            self._pending_scale[name] = (direction, now, want)
            pend = self._pending_scale[name]
        if now - pend[1] >= delay:
            self._pending_scale.pop(name, None)
            return want
        return None

    # ---- per-model autoscaling (multiplexed deployments) -------------------

    def _models_tick(self, name: str, d: dict):
        """One control-loop tick of the per-model scaler: poll each
        replica's model_stats, fold in the routers' per-model demand,
        and size every model's serving set toward
        load / target_load_per_model_replica (look-back averaged, with
        up/down delays). Scale ops run on a background thread — loading
        a model can take seconds and must not stall the control loop."""
        mcfg = d["config"].get("model_autoscaling_config")
        if not mcfg:
            return
        replicas = list(d["replicas"])
        if not replicas:
            return
        try:
            res = ray_tpu_torch.get(
                [r.handle_request.remote("model_stats", (), {}, None)
                 for r in replicas], timeout=5)
        except Exception:
            return
        stats = [(r, st if isinstance(st, dict) else {})
                 for r, st in zip(replicas, res)]
        serving: Dict[str, list] = {}     # model -> replica indices
        local_load: Dict[str, float] = {}
        for i, (_, st) in enumerate(stats):
            for m in st.get("models", []):
                serving.setdefault(m, []).append(i)
            for m, q in (st.get("queues") or {}).items():
                local_load[m] = local_load.get(m, 0.0) + float(q)
        ext = self._ext_model_load(name)
        models = set(serving) | set(ext) | set(local_load)
        if not models:
            self._model_table[name] = {"ts": time.time(), "models": {}}
            return
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        per = float(mcfg.get("target_load_per_model_replica",
                             GLOBAL_CONFIG.serve_model_target_load))
        look_back = float(mcfg.get("look_back_period_s", 10.0))
        mn = int(mcfg.get("min_replicas_per_model", 1))
        mx = int(mcfg.get("max_replicas_per_model", len(replicas)))
        now = time.time()
        table: Dict[str, dict] = {}
        for m in sorted(models):
            load = local_load.get(m, 0.0) + ext.get(m, 0.0)
            hist = self._mhist.setdefault((name, m), [])
            hist.append((now, load))
            while hist and hist[0][0] < now - look_back:
                hist.pop(0)
            avg = sum(v for _, v in hist) / max(len(hist), 1)
            cur = len(serving.get(m, []))
            # math.ceil, not the integer (a+b-1)//b idiom: `per` is a
            # float knob and fractional targets must still round UP
            want = math.ceil(avg / per) if per > 0 else mx
            want = max(mn, min(mx, want))
            table[m] = {"serving": cur, "want": want, "load": load,
                        "avg_load": avg}
            if want == cur:
                self._pending_mscale.pop((name, m), None)
                continue
            if (name, m) in self._model_ops:
                continue   # previous op for this model still running
            direction = "up" if want > cur else "down"
            delay = float(mcfg.get("upscale_delay_s", 0.0)
                          if direction == "up"
                          else mcfg.get("downscale_delay_s", 5.0))
            pend = self._pending_mscale.get((name, m))
            if pend is None or pend[0] != direction:
                self._pending_mscale[(name, m)] = (direction, now)
                pend = self._pending_mscale[(name, m)]
            if now - pend[1] >= delay:
                self._pending_mscale.pop((name, m), None)
                self._model_ops.add((name, m))
                threading.Thread(
                    target=self._apply_model_scale,
                    args=(name, m, want, stats, serving.get(m, [])),
                    daemon=True).start()
        self._model_table[name] = {"ts": now, "models": table}

    def _apply_model_scale(self, name: str, model: str, want: int,
                           stats: List[tuple], serving_idx: List[int]):
        """Background scale op for one model. Up: warm-load on the
        least-loaded replicas not yet serving it. Down: unpublish (the
        replica stops advertising, routers drain away), poll the
        per-model queue to 0 under serve_drain_timeout_s, then unload —
        the replica drain protocol (_drain_then_kill) applied at model
        granularity."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        try:
            cur = len(serving_idx)
            if want > cur:
                # candidates: replicas not serving the model, coldest
                # (fewest queued requests across their models) first
                cand = [(sum((st.get("queues") or {}).values()),
                         len(st.get("resident", [])), i, r)
                        for i, (r, st) in enumerate(stats)
                        if i not in serving_idx and not st.get("draining")]
                cand.sort(key=lambda t: (t[0], t[1]))
                for _, _, _, r in cand[:want - cur]:
                    try:
                        ray_tpu_torch.get(r.handle_request.remote(
                            "load_model", (model,), {}, None), timeout=120)
                    except Exception:
                        pass   # replica died/failed: next tick retries
                return
            # scale-down: retire from the highest index (arbitrary but
            # stable), keeping `want` replicas serving
            victims = [stats[i][0] for i in serving_idx[want:]]
            for r in victims:
                try:
                    ray_tpu_torch.get(r.handle_request.remote(
                        "unpublish_model", (model,), {}, None), timeout=10)
                except Exception:
                    continue
            deadline = time.time() + GLOBAL_CONFIG.serve_drain_timeout_s
            pending = list(victims)
            while pending and time.time() < deadline \
                    and not self._stop.is_set():
                still = []
                for r in pending:
                    try:
                        q = ray_tpu_torch.get(r.handle_request.remote(
                            "model_queue_len", (model,), {}, None),
                            timeout=5)
                        if int(q) > 0:
                            still.append(r)
                    except Exception:
                        pass   # dead: drained by definition
                pending = still
                if pending:
                    self._stop.wait(0.2)
            for r in victims:
                try:
                    ray_tpu_torch.get(r.handle_request.remote(
                        "unload_model", (model,), {}, None), timeout=30)
                except Exception:
                    pass
        finally:
            self._model_ops.discard((name, model))

    def _control_loop(self):
        """Dead-replica replacement + windowed autoscaling."""
        while not self._stop.wait(1.0):
            for name in list(self.deployments):
                d = self.deployments.get(name)
                if d is None:
                    continue
                # replace dead replicas
                alive, alive_names = [], []
                for r, rn in zip(d["replicas"], d["replica_names"]):
                    try:
                        ray_tpu_torch.get(r.queue_len.remote(), timeout=5)
                        alive.append(r)
                        alive_names.append(rn)
                    except Exception:
                        pass
                if len(alive) != len(d["replicas"]):
                    with self._lock:
                        d["replicas"] = alive
                        d["replica_names"] = alive_names
                    self._reconcile(name)
                    continue
                try:
                    self._models_tick(name, d)
                except Exception:
                    pass   # per-model scaler must never kill the loop
                if not d["config"].get("autoscaling_config"):
                    continue
                try:
                    qs = ray_tpu_torch.get([r.queue_len.remote()
                                            for r in d["replicas"]], timeout=5)
                except Exception:
                    continue
                total = sum(qs) + self._ext_load_total(name)
                want = self._autoscale_decision(name, d, total)
                if want is not None and want != len(d["replicas"]):
                    with self._lock:
                        d["config"]["num_replicas"] = want
                    self._reconcile(name)
