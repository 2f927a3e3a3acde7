"""LLM router end-to-end properties (serve/llm_router.py).

All tests drive the real serve stack (controller, Replica actors,
DeploymentHandle streaming) with SimLLMServer replicas — deterministic
engines honoring the LLMServer contract (frames, 429 shed, stats,
prefix cache) whose token i is prompt_len + i, so failover continuity
asserts are exact (see llm_deployment.SimLLMServer).

- prefix affinity: same-prefix streams rendezvous onto one replica;
  the replicas' own prefix-cache hit counters prove it.
- shed-vs-stall: past the router in-flight bound, excess demand gets a
  typed 429 first frame instead of unbounded queueing.
- chaos: a replica killed mid-stream re-routes (prompt + generated so
  far resubmitted) and the client stream completes with no duplicated
  or dropped tokens.
- autoscaling: queue depth scales the fleet up; idleness drains it
  back down (scale-down unpublishes, waits for in-flight, then kills).

Port of tests/test_serve_llm_router.py, aimed at ray_tpu_torch.
"""

import threading
import time

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.llm_deployment import build_llm_app
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def _controller():
    return ray_tpu_torch.get_actor("_serve_controller", namespace="serve")


def _consume(handle, body, timeout=60):
    """Drive one router stream to completion: (tokens, final_frame)."""
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


def test_prefix_affinity_routing(ray_start_regular):
    app = build_llm_app(use_sim=True, num_replicas=2,
                        router_policy="affinity",
                        router_kwargs={"stats_interval_s": 0.2},
                        decode_s_per_token=0.002, max_queue_depth=None)
    handle = serve.run(app)
    prefixes = [[7] * 32, [11] * 32]
    n_per = 5
    for rnd in range(n_per):
        for p in prefixes:
            toks, final = _consume(
                handle, {"prompt": p + [rnd], "max_new_tokens": 4})
            assert final and final["done"] and len(toks) == 4
    _, stats = _replica_stats()
    reqs = sum(s["requests"] for s in stats)
    hits = sum(s["prefix_hits"] for s in stats)
    assert reqs == n_per * len(prefixes)
    # affinity pins each prefix group to one replica, so only the first
    # request per group is a cold miss — every later one hits its cached
    # prefix pages. Random placement would miss whenever a stream landed
    # on the other replica.
    assert hits >= reqs - len(prefixes), (
        f"prefix cache hits {hits}/{reqs}: same-prefix streams were "
        "scattered across replicas")
    rstats = ray_tpu_torch.get(handle.method("stats").remote())
    assert rstats["affinity_picks"] == reqs
    assert rstats["reroutes"] == 0
    serve.shutdown()


def test_router_sheds_instead_of_stalling(ray_start_regular):
    app = build_llm_app(use_sim=True, num_replicas=1,
                        router_policy="p2c",
                        router_kwargs={"max_inflight": 3,
                                       "stats_interval_s": 0.2},
                        max_slots=2, decode_s_per_token=0.02,
                        max_queue_depth=None)
    handle = serve.run(app)
    results, lock = [], threading.Lock()

    def one():
        out = _consume(handle, {"prompt": [1, 2, 3],
                                "max_new_tokens": 8})
        with lock:
            results.append(out)

    threads = [threading.Thread(target=one) for _ in range(8)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert time.time() - t0 < 60, "saturated router stalled clients"
    shed = [f for _, f in results if f and f.get("status") == 429]
    ok = [(t, f) for t, f in results if f and f.get("status") != 429]
    assert shed, "router never shed past max_inflight=3"
    assert len(ok) >= 3, f"only {len(ok)} requests served"
    for toks, f in ok:
        assert len(toks) == 8 and f["n_tokens"] == 8
    for f in shed:
        assert f.get("retry_after_s"), "shed frame missing Retry-After"
    serve.shutdown()


def test_midstream_replica_death_reroutes(ray_start_regular):
    app = build_llm_app(use_sim=True, num_replicas=2,
                        router_policy="affinity",
                        router_kwargs={"stats_interval_s": 0.2},
                        decode_s_per_token=0.03, tokens_per_frame=2,
                        max_queue_depth=None)
    handle = serve.run(app)
    L, N = 40, 20
    gen = handle.options(stream=True).method("stream_request").remote(
        {"prompt": [3] * L, "max_new_tokens": N})
    toks, final, killed = [], None, False
    for ref in gen:
        item = ray_tpu_torch.get(ref, timeout=60)
        if item.get("done"):
            final = item
        toks.extend(item.get("tokens", []))
        if not killed and len(toks) >= 4:
            reps, stats = _replica_stats()
            victims = [r for r, s in zip(reps, stats)
                       if s["active_slots"] > 0]
            assert victims, "no replica reports the active stream"
            ray_tpu_torch.kill(victims[0], no_restart=True)
            killed = True
    assert killed and final and final["done"]
    assert final.get("reroutes", 0) >= 1, "stream never failed over"
    # deterministic sim: token i of a prompt of length P is P+i, so the
    # resubmission (prompt + generated-so-far) continues the EXACT
    # integer sequence — any duplicate or gap breaks the equality
    assert toks == list(range(L, L + N)), (
        f"tokens duplicated/dropped across failover: {toks}")
    serve.shutdown()


def test_autoscale_up_then_drain_down(ray_start_regular):
    app = build_llm_app(
        use_sim=True, num_replicas=1, router_policy="p2c",
        autoscaling_config={"min_replicas": 1, "max_replicas": 2,
                            "target_num_ongoing_requests_per_replica": 2,
                            "look_back_period_s": 0.6,
                            "upscale_delay_s": 0.4,
                            "downscale_delay_s": 0.8},
        router_kwargs={"stats_interval_s": 0.2},
        max_slots=2, decode_s_per_token=0.02, max_queue_depth=None)
    handle = serve.run(app)
    controller = _controller()
    stop = threading.Event()
    results, lock = [], threading.Lock()

    def pump():
        while not stop.is_set():
            out = _consume(handle, {"prompt": [5] * 8,
                                    "max_new_tokens": 8})
            with lock:
                results.append(out)

    threads = [threading.Thread(target=pump) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 40
        scaled = False
        while time.time() < deadline:
            n = len(ray_tpu_torch.get(
                controller.get_replicas.remote("llm_server")))
            if n >= 2:
                scaled = True
                break
            time.sleep(0.25)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert scaled, "queue depth never scaled the fleet up"
    # no request was dropped by scaling: each either completed fully or
    # was shed with the typed 429
    for toks, final in results:
        assert final is not None
        if final.get("status") != 429:
            assert len(toks) == 8
    deadline = time.time() + 40
    downs = False
    while time.time() < deadline:
        n = len(ray_tpu_torch.get(controller.get_replicas.remote("llm_server")))
        if n == 1:
            downs = True
            break
        time.sleep(0.25)
    assert downs, "fleet never drained back down after load stopped"
    serve.shutdown()
