"""Serve: deployments, routing, batching, autoscale config, LLM engine.

Port of tests/test_serve.py, aimed at ray_tpu_torch. Real engines run on
the CPU (``device="cpu"``).
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def test_deployment_basic(ray_start_regular):
    @serve.deployment(num_replicas=1,
                      ray_actor_options={"num_cpus": 0.1})
    class Doubler:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Doubler.bind())
    assert ray_tpu_torch.get(handle.remote(21)) == 42
    serve.shutdown()


def test_deployment_multi_replica_and_methods(ray_start_regular):
    @serve.deployment(num_replicas=2,
                      ray_actor_options={"num_cpus": 0.1})
    class Svc:
        def __init__(self, base):
            self.base = base

        def __call__(self, x):
            return self.base + x

        def ident(self):
            # (pid, instance id), not pid alone: fractional-CPU replicas
            # may share a lane-host worker process (r5 actor lanes); and
            # id() alone could collide across two identically-spawned
            # processes
            import os

            return (os.getpid(), id(self))

    handle = serve.run(Svc.bind(100))
    outs = ray_tpu_torch.get([handle.remote(i) for i in range(10)])
    assert outs == [100 + i for i in range(10)]
    idents = set(ray_tpu_torch.get(
        [handle.method("ident").remote() for _ in range(10)]))
    assert len(idents) == 2, "requests should spread over both replicas"
    serve.shutdown()


def test_serve_batch(ray_start_regular):
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind())
    refs = [handle.remote(i) for i in range(8)]
    assert sorted(ray_tpu_torch.get(refs)) == [i * 10 for i in range(8)]
    sizes = ray_tpu_torch.get(handle.method("sizes").remote())
    assert max(sizes) > 1, f"batching never aggregated: {sizes}"
    serve.shutdown()


def test_llm_engine_continuous_batching():
    """Engine-level: concurrent requests share decode steps; outputs match
    isolated generation (greedy)."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(preset="tiny", max_slots=4, device="cpu")
    # isolated reference
    ref_eng = LLMEngine(preset="tiny", max_slots=1, seed=0, device="cpu")
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    ref_outs = [ref_eng.generate(p, max_new_tokens=8) for p in prompts]

    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    while any(not r.done_event.is_set() for r in reqs):
        eng.step()
    outs = [r.generated for r in reqs]
    for o, ro in zip(outs, ref_outs):
        assert o == ro, (o, ro)


def test_llm_server_deployment(ray_start_regular):
    from ray_tpu_torch.serve.llm import LLMServer

    dep = serve.deployment(LLMServer, name="llm",
                           ray_actor_options={"num_cpus": 1.0},
                           max_concurrent_queries=16)
    handle = serve.run(dep.bind(preset="tiny", max_slots=4, device="cpu"))
    refs = [handle.remote({"prompt": [1, 2, 3], "max_new_tokens": 4})
            for _ in range(4)]
    outs = ray_tpu_torch.get(refs)
    assert all(len(o["tokens"]) == 4 for o in outs)
    assert all(o["ttft_s"] is not None for o in outs)
    serve.shutdown()


def test_http_proxy_end_to_end(ray_start_regular):
    """Real HTTP requests through the ingress proxy to a deployment."""
    import json as _json
    import urllib.request

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, request):
            if request.method == "POST":
                data = request.json()
                return {"doubled": data["x"] * 2}
            return {"path": request.path,
                    "q": request.query_params.get("name", "")}

    port = serve.start(http_port=0)
    serve.run(Echo.bind(), route_prefix="/echo")
    base = f"http://127.0.0.1:{port}"

    with urllib.request.urlopen(f"{base}/echo?name=tpu", timeout=30) as r:
        assert r.status == 200
        body = _json.loads(r.read())
        assert body == {"path": "/echo", "q": "tpu"}

    req = urllib.request.Request(
        f"{base}/echo", data=_json.dumps({"x": 21}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert _json.loads(r.read()) == {"doubled": 42}

    # 404 for unknown route
    try:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert False, "expected 404"
    except urllib.error.HTTPError as e:
        assert e.code == 404

    st = serve.status()
    assert st["routes"] == {"/echo": "Echo"}
    serve.shutdown()


def test_handle_streaming_call(ray_start_regular):
    """handle.options(stream=True) returns a generator of item refs fed
    by the deployment's generator method."""
    @serve.deployment
    class Gen:
        def stream_request(self, n):
            for i in range(n):
                yield {"i": i}

    handle = serve.run(Gen.bind())
    gen = handle.options(stream=True).method("stream_request").remote(4)
    items = [ray_tpu_torch.get(r) for r in gen]
    assert items == [{"i": i} for i in range(4)]
    serve.shutdown()


def test_http_streaming_response(ray_start_regular):
    """?stream=1 flushes the deployment's yields as HTTP chunks while the
    handler is still running (token-streaming contract)."""
    import http.client
    import json as _json

    @serve.deployment
    class Slow:
        async def stream_request(self, request):
            import asyncio
            for i in range(3):
                yield {"part": i}
                await asyncio.sleep(0.2)

    port = serve.start(http_port=0)
    serve.run(Slow.bind(), route_prefix="/s")

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/s?stream=1")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers.get("Transfer-Encoding") == "chunked"
    first = resp.readline()          # first chunk line
    first_at = time.time()
    rest = resp.read()               # drains the remaining chunks
    last_at = time.time()
    lines = [first] + [ln + b"\n" for ln in rest.splitlines() if ln]
    parts = [_json.loads(ln) for ln in lines if ln.strip()]
    assert parts == [{"part": 0}, {"part": 1}, {"part": 2}]
    # chunks must be spread over the handler's sleeps — a buffered
    # (non-streaming) response would arrive all at once
    assert last_at - first_at > 0.25, (
        f"all chunks arrived within {last_at - first_at:.3f}s — "
        "response was buffered, not streamed")
    conn.close()
    serve.shutdown()


def test_llm_token_streaming(ray_start_regular):
    """LLM server streams token batches incrementally over the handle."""
    from ray_tpu_torch.serve.llm import LLMServer

    dep = serve.deployment(LLMServer, name="llmstream",
                           ray_actor_options={"num_cpus": 1.0})
    handle = serve.run(dep.bind(preset="tiny", max_slots=2,
                                decode_block=2, device="cpu"))
    gen = handle.options(stream=True).method("stream_request").remote(
        {"prompt": [1, 2, 3], "max_new_tokens": 8})
    toks: list = []
    batches = 0
    final = None
    for r in gen:
        item = ray_tpu_torch.get(r)
        if "tokens" in item:
            toks.extend(item["tokens"])
            batches += 1
        else:
            final = item
    assert len(toks) == 8
    assert batches >= 2, "tokens arrived in one lump — not streaming"
    assert final and final["done"] and final["n_tokens"] == 8
    assert final["ttft_s"] is not None
    serve.shutdown()


def test_multiplexed_model_loading(ray_start_regular):
    """LRU model cache per replica keyed by multiplexed model id."""

    @serve.deployment
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[1:])}

        async def __call__(self, x):
            model_id = serve.get_multiplexed_model_id()
            model = await self.get_model(model_id)
            return {"y": x * model["scale"], "model": model["id"],
                    "loads": list(self.loads)}

    handle = serve.run(MultiModel.bind())
    out1 = ray_tpu_torch.get(
        handle.options(multiplexed_model_id="m3").remote(5))
    assert out1 == {"y": 15, "model": "m3", "loads": ["m3"]}
    # same model again: no reload
    out2 = ray_tpu_torch.get(
        handle.options(multiplexed_model_id="m3").remote(2))
    assert out2["loads"] == ["m3"]
    # two more models: m3 evicted (LRU, capacity 2)
    ray_tpu_torch.get(handle.options(multiplexed_model_id="m4").remote(1))
    ray_tpu_torch.get(handle.options(multiplexed_model_id="m5").remote(1))
    out3 = ray_tpu_torch.get(
        handle.options(multiplexed_model_id="m3").remote(1))
    assert out3["loads"] == ["m3", "m4", "m5", "m3"]
    serve.shutdown()
