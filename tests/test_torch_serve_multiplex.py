"""Model multiplexing + multi-tenant fairness (serve/multiplex.py,
llm_router.py model-aware routing, controller per-model autoscaling).

- _ModelCache concurrency: in-flight load dedup, LRU eviction order
  under interleaved touches, loader-exception cleanup (waiters woken,
  id retryable), unloader hook on eviction.
- ModelRegistry: weights published once into the object store resolve
  by model id from the driver and from other actors/tasks.
- context propagation: the compiled stream hop and the legacy dispatch
  hop deliver IDENTICAL per-call context (multiplexed_model_id, tenant)
  to the replica's contextvars.
- model-affinity routing: a skewed multi-model workload converges each
  model onto its rendezvous replica, so each model loads ~once
  fleet-wide instead of once per (request, replica) collision.
- weighted-fair admission: a flooding tenant is shed first while a
  compliant tenant keeps admitting inside its guaranteed share.
- per-model autoscaling: sustained load on one model grows its serving
  set toward load/target; the controller's decision table shows it.

Port of tests/test_serve_multiplex.py, aimed at ray_tpu_torch.
``test_serve_multiplex_bench_smoke`` and the slow
``test_serve_multiplex_bench_full`` drive the JAX package's ``bench.py``
and wait with it (ROADMAP.md queue 1 item 11.5).
"""

import asyncio
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.llm_deployment import build_llm_app
from ray_tpu_torch.serve.multiplex import ModelRegistry, _ModelCache
from torch_runtime_support import (  # noqa: F401
    ray_start_8cpu, ray_start_regular, reap_orphans)


def _controller():
    return ray_tpu_torch.get_actor("_serve_controller", namespace="serve")


def _consume(handle, body, timeout=60):
    gen = handle.options(stream=True).method("stream_request").remote(body)
    toks, final = [], None
    for ref in gen:
        item = ray_tpu_torch.get(ref, timeout=timeout)
        if item.get("done"):
            final = item
        toks.extend(item.get("tokens", []))
    return toks, final


def _replica_stats(name="llm_server"):
    reps = ray_tpu_torch.get(_controller().get_replicas.remote(name))
    return reps, ray_tpu_torch.get(
        [r.handle_request.remote("stats", (), {}, None) for r in reps])


# ---------------------------------------------------------------------------
# _ModelCache unit tests (no cluster)
# ---------------------------------------------------------------------------


def test_model_cache_inflight_dedup():
    """Two concurrent gets of one cold model share ONE loader call and
    the same loaded object."""
    calls = []

    async def loader(owner, mid):
        calls.append(mid)
        await asyncio.sleep(0.05)
        return {"model": mid}

    async def main():
        cache = _ModelCache(loader, max_models=4)
        a, b = await asyncio.gather(cache.get(None, "m0"),
                                    cache.get(None, "m0"))
        assert a is b
        assert calls == ["m0"]
        assert cache.models() == ["m0"]
        # the cross-thread iteration snapshot tracks membership
        assert cache.values_snapshot() == (a,)
        # a later get is a pure cache hit, no second load
        c = await cache.get(None, "m0")
        assert c is a and calls == ["m0"]
        assert cache.load_count == 1

    asyncio.run(main())


def test_model_cache_lru_eviction_order_under_touches():
    """Eviction follows RECENCY, not insertion: touching an old model
    saves it, the untouched one goes, and the unloader hook sees exactly
    the evicted (id, object) pairs in order."""
    evicted = []

    async def loader(owner, mid):
        return {"model": mid}

    def unloader(owner, mid, obj):
        evicted.append((mid, obj["model"]))

    async def main():
        cache = _ModelCache(loader, max_models=2, unloader=unloader)
        await cache.get(None, "a")
        await cache.get(None, "b")
        await cache.get(None, "a")          # touch: a is now MRU
        await cache.get(None, "c")          # overflow: b (LRU) evicted
        assert cache.models() == ["a", "c"]
        assert evicted == [("b", "b")]
        await cache.get(None, "b")          # overflow again: a untouched
        assert cache.models() == ["c", "b"]
        assert evicted == [("b", "b"), ("a", "a")]
        assert [o["model"] for o in cache.values_snapshot()] == ["c", "b"]
        assert cache.eviction_count == 2
        # explicit unload also runs the hook and reports truthfully
        assert await cache.unload(None, "c") is True
        assert await cache.unload(None, "zz") is False
        assert evicted[-1] == ("c", "c")

    asyncio.run(main())


def test_model_cache_loader_failure_wakes_waiters_and_is_retryable():
    """A loader exception propagates to the loading caller AND every
    deduped waiter, leaves no cache/loading residue, and the next get
    retries the loader fresh."""
    attempts = []

    async def loader(owner, mid):
        attempts.append(mid)
        await asyncio.sleep(0.02)
        if len(attempts) == 1:
            raise RuntimeError("weights 404")
        return {"model": mid}

    async def main():
        cache = _ModelCache(loader, max_models=2)
        r1, r2 = await asyncio.gather(
            cache.get(None, "m"), cache.get(None, "m"),
            return_exceptions=True)
        assert isinstance(r1, RuntimeError)
        assert isinstance(r2, RuntimeError)
        assert len(attempts) == 1, "waiter must not trigger a 2nd load"
        assert cache.models() == [] and not cache.loading
        # the id is retryable — a fresh get re-runs the loader
        out = await cache.get(None, "m")
        assert out == {"model": "m"} and len(attempts) == 2

    asyncio.run(main())


def test_model_cache_unloader_exception_does_not_break_eviction():
    """A throwing unloader is contained: the eviction still happens and
    later loads proceed."""

    async def loader(owner, mid):
        return {"model": mid}

    def unloader(owner, mid, obj):
        raise ValueError("unload boom")

    async def main():
        cache = _ModelCache(loader, max_models=1, unloader=unloader)
        await cache.get(None, "a")
        await cache.get(None, "b")
        assert cache.models() == ["b"]
        assert cache.eviction_count == 1

    asyncio.run(main())


# ---------------------------------------------------------------------------
# ModelRegistry (object-store weight sharing)
# ---------------------------------------------------------------------------


def test_model_registry_publish_fetch_cross_process(ray_start_regular):
    weights = {"layer0": list(range(64)), "name": "m-alpha"}
    reg = ModelRegistry()
    reg.publish("m-alpha", weights)
    # a SECOND registry instance (fresh process would look the same —
    # resolution goes through the GCS KV, not local state)
    reg2 = ModelRegistry()
    assert reg2.contains("m-alpha")
    assert reg2.fetch("m-alpha") == weights
    with pytest.raises(KeyError):
        reg2.ref("never-published")

    @ray_tpu_torch.remote
    def fetch_remote(mid):
        from ray_tpu_torch.serve.multiplex import ModelRegistry

        return ModelRegistry().fetch(mid)

    assert ray_tpu_torch.get(fetch_remote.remote("m-alpha")) == weights


# ---------------------------------------------------------------------------
# context propagation: compiled hop vs legacy hop
# ---------------------------------------------------------------------------


def test_context_identical_across_compiled_and_legacy_hops(
        ray_start_regular):
    """The replica-side contextvars (get_multiplexed_model_id /
    get_request_tenant) observe the SAME values whether the router
    reached the replica over the compiled standing channel or the legacy
    per-call dispatch path."""
    observed = {}
    for compiled in (True, False):
        app = build_llm_app(
            use_sim=True, num_replicas=1, router_policy="affinity",
            router_kwargs={"stats_interval_s": 0.2,
                           "compiled_hop": compiled},
            multiplexed=True, model_load_s=0.0, decode_s_per_token=0.001,
            max_queue_depth=None)
        handle = serve.run(app)
        for _ in range(3):
            toks, final = _consume(
                handle, {"prompt": [1, 2, 3], "max_new_tokens": 2,
                         "model": "m-ctx", "tenant": "t-ctx"})
            assert final and final["done"] and final.get("status") != 429
        for _ in range(2):   # no model/tenant -> replica must see ""
            _consume(handle, {"prompt": [4, 5, 6], "max_new_tokens": 2})
        rstats = ray_tpu_torch.get(handle.method("stats").remote())
        if compiled:
            assert rstats["compiled_streams"] >= 5
        else:
            assert rstats["legacy_streams"] >= 5
        _, stats = _replica_stats()
        observed[compiled] = (sorted(stats[0]["ctx_model_ids"]),
                              sorted(stats[0]["ctx_tenants"]))
        serve.shutdown()
    assert observed[True] == observed[False], (
        "compiled and legacy hops delivered different per-call context: "
        f"{observed}")
    assert observed[True][0] == ["", "", "m-ctx", "m-ctx", "m-ctx"]
    assert observed[True][1] == ["", "", "t-ctx", "t-ctx", "t-ctx"]


# ---------------------------------------------------------------------------
# model-affinity routing
# ---------------------------------------------------------------------------


def test_model_affinity_loads_each_model_once(ray_start_regular):
    """Round-robin traffic over 4 models x 2 replicas: the (model,
    prefix) rendezvous key sends every request for one model to the same
    replica, so fleet-wide cold loads == number of models — not the
    per-request collisions random placement pays."""
    n_models, n_rounds = 4, 6
    app = build_llm_app(
        use_sim=True, num_replicas=2, router_policy="affinity",
        router_kwargs={"stats_interval_s": 0.2},
        multiplexed=True, model_load_s=0.05,
        decode_s_per_token=0.001, max_queue_depth=None)
    handle = serve.run(app)
    for rnd in range(n_rounds):
        for m in range(n_models):
            toks, final = _consume(
                handle, {"prompt": [100 * m + j for j in range(16)],
                         "max_new_tokens": 2, "model": f"model-{m}"})
            assert final and final.get("status") != 429
    _, stats = _replica_stats()
    loads = sum(s["model_loads"] for s in stats)
    reqs = sum(s["requests"] for s in stats)
    assert reqs == n_models * n_rounds
    assert loads <= n_models + 1, (
        f"{loads} cold loads for {n_models} models: model traffic was "
        "scattered across replicas")
    # every model is resident SOMEWHERE, and the router saw warm picks
    # once its stats poll caught up
    resident = set()
    for s in stats:
        resident.update(s["models"])
    assert resident == {f"model-{m}" for m in range(n_models)}
    rstats = ray_tpu_torch.get(handle.method("stats").remote())
    assert rstats["warm_model_picks"] + rstats["cold_model_picks"] == reqs
    assert rstats["model_inflight"] == {}   # all drained
    serve.shutdown()


def test_cold_load_failure_routes_around_not_terminal(ray_start_regular):
    """A replica's cold-model load failure (typed 503 done-frame) is
    REROUTABLE, not terminal: the router walks every replica before
    failing the client, and the final error surfaces the replica-side
    cause. A healthy model on the same fleet still serves."""
    app = build_llm_app(
        use_sim=True, num_replicas=2, router_policy="affinity",
        router_kwargs={"stats_interval_s": 0.2},
        multiplexed=True, model_load_s=0.0, decode_s_per_token=0.001,
        max_queue_depth=None, model_load_fail_ids=["m-bad"])
    handle = serve.run(app)
    toks, final = _consume(handle, {"prompt": [1, 2, 3],
                                    "max_new_tokens": 2,
                                    "model": "m-bad"})
    assert toks == []
    assert final and final["status"] == 503
    assert "injected load failure" in final["error"]
    rstats = ray_tpu_torch.get(handle.method("stats").remote())
    assert rstats["replica_failed"] == 2, (
        "router must try BOTH replicas before failing the stream: "
        f"{rstats}")
    # the failure is contained to the bad id — a good model still loads
    # and streams on the same fleet
    toks, final = _consume(handle, {"prompt": [1, 2, 3],
                                    "max_new_tokens": 2,
                                    "model": "m-ok"})
    assert final and final["done"] and final.get("status") != 429
    assert len(toks) == 2
    serve.shutdown()


# ---------------------------------------------------------------------------
# weighted-fair tenant admission
# ---------------------------------------------------------------------------


def test_weighted_fair_admission_sheds_flooder_first(ray_start_regular):
    """max_inflight=4, weights gold:3 flood:1. A flooding tenant
    saturates the router; gold keeps admitting inside its guaranteed
    share (3 of 4 slots) with ZERO sheds while flood eats every 429."""
    app = build_llm_app(
        use_sim=True, num_replicas=1, router_policy="p2c",
        router_kwargs={"max_inflight": 4, "stats_interval_s": 0.2},
        tenant_weights={"gold": 3.0, "flood": 1.0},
        max_slots=8, decode_s_per_token=0.02, max_queue_depth=None)
    handle = serve.run(app)
    stop = threading.Event()
    flood_results, lock = [], threading.Lock()

    def flooder():
        while not stop.is_set():
            out = _consume(handle, {"prompt": [9] * 8,
                                    "max_new_tokens": 30,
                                    "tenant": "flood"})
            with lock:
                flood_results.append(out)

    threads = [threading.Thread(target=flooder) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        # wait until the flood actually saturates admission
        deadline = time.time() + 20
        while time.time() < deadline:
            with lock:
                shed = sum(1 for _, f in flood_results
                           if f and f.get("status") == 429)
            if shed >= 4:
                break
            time.sleep(0.05)
        assert shed >= 4, "flood never saturated the router"
        gold = [_consume(handle, {"prompt": [2] * 8, "max_new_tokens": 4,
                                  "tenant": "gold"})
                for _ in range(6)]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    # every gold request admitted and served — its share is guaranteed
    for toks, final in gold:
        assert final and final.get("status") != 429, final
        assert len(toks) == 4
    rstats = ray_tpu_torch.get(handle.method("stats").remote())
    ts = rstats["tenant_stats"]
    assert ts["gold"]["requests"] == 6 and ts["gold"]["shed"] == 0
    assert ts["flood"]["shed"] >= 4, ts
    assert rstats["tenant_weights"] == {"gold": 3.0, "flood": 1.0}
    # the shed frames are TYPED and name the over-quota tenant
    shed_frames = [f for _, f in flood_results
                   if f and f.get("status") == 429]
    assert all("flood" in f["error"] and f.get("retry_after_s")
               for f in shed_frames)
    serve.shutdown()


# ---------------------------------------------------------------------------
# per-model autoscaling
# ---------------------------------------------------------------------------


def test_per_model_autoscale_grows_hot_model(ray_start_8cpu):
    """Sustained demand on one model grows its serving set: the
    controller folds replica model-queues + router per-model depth into
    a per-model target and warm-loads the model on more replicas."""
    app = build_llm_app(
        use_sim=True, num_replicas=3, router_policy="affinity",
        model_autoscaling_config={"target_load_per_model_replica": 1.0,
                                  "look_back_period_s": 1.0,
                                  "upscale_delay_s": 0.0,
                                  "downscale_delay_s": 120.0},
        router_kwargs={"stats_interval_s": 0.2},
        multiplexed=True, model_load_s=0.02,
        max_slots=2, decode_s_per_token=0.02, max_queue_depth=None)
    handle = serve.run(app)
    controller = _controller()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            _consume(handle, {"prompt": [5] * 8, "max_new_tokens": 8,
                              "model": "hot"})

    threads = [threading.Thread(target=pump) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 40
        grown = False
        while time.time() < deadline:
            st = ray_tpu_torch.get(controller.model_status.remote("llm_server"))
            hot = (st.get("models") or {}).get("hot")
            if hot and hot["serving"] >= 2:
                grown = True
                break
            time.sleep(0.25)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert grown, f"hot model never scaled past 1 replica: {st}"
    assert hot["want"] >= 2
    # the extra replicas really have the model resident
    _, stats = _replica_stats()
    n_serving = sum(1 for s in stats if "hot" in s.get("models", []))
    assert n_serving >= 2
    serve.shutdown()
