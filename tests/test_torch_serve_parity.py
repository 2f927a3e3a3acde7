"""The serve slice against the JAX reference, on the CPU.

The JAX ``LLMEngine`` (loaded through tests/test_torch_support.py's stubs,
f32 ``tiny``) gives the greedy tokens; its weights cross over as numpy, as
in tests/test_torch_llm_engine.py. The port serves them through its own
entry points, every engine with ``device="cpu"``:

- a monolithic ``LLMServer`` behind ``build_llm_app``'s ``LLMRouter``,
  reached through the router's streaming handle, by plain HTTP POSTs and
  by ``?stream=1`` POSTs;
- a disaggregated app (one prefill and one decode replica, paged KV): the
  decode replica adopts the prefill replica's page groups through the
  object store and gives the JAX monolithic engine's tokens; the group
  hashes the exporter registers in the GCS directory are the reference's
  ``group_boundary_hashes``, byte for byte;
- a multiplexed ``LLMServer`` whose two models (two seeds) were published
  as CPU tensor trees under ``ModelRegistry``: each model's requests give
  that model's JAX tokens.

Also: ``LLMEngine`` places a caller's host tree on its device (numpy or
CPU tensors in, tensors on the device out; on the card in
tests/test_torch_serve_paged_kv.py's ``cuda`` test), and ``import
ray_tpu_torch.serve`` loads no torch.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import urllib.request

import torch

import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve import kv_transfer
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.serve.llm_deployment import build_llm_app
from ray_tpu_torch.serve.multiplex import ModelRegistry
from test_torch_support import REPO, jax_reference, jax_tree_to_np
from torch_runtime_support import (  # noqa: F401
    ray_start_8cpu, reap_orphans)

PAGE, GROUP = 16, 4
TIMEOUT = 120


def _jax_tokens(seed, prompts, n):
    """JAX's f32 tiny engine (contiguous, the default layout): its params
    as a numpy tree and its greedy tokens for each prompt."""
    with jax_reference() as ref:
        cfg = ref.llama.PRESETS["tiny"].replace(dtype=jnp.float32)
        je = ref.llm.LLMEngine(cfg=cfg, seed=seed)
        want = [je.generate(list(p), max_new_tokens=n) for p in prompts]
        return jax_tree_to_np(je.params), want


def _consume(handle, body):
    """One router stream: (tokens joined over the frames, final frame)."""
    gen = handle.options(stream=True).method("stream_request").remote(body)
    toks, final = [], None
    for ref in gen:
        item = ray_tpu_torch.get(ref, timeout=TIMEOUT)
        if item.get("done"):
            final = item
        toks.extend(item.get("tokens", []))
    return toks, final


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.status == 200
        return json.loads(r.read())


def _post_stream(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path + "?stream=1", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.headers.get("Transfer-Encoding") == "chunked"
        frames = [json.loads(ln) for ln in resp.read().splitlines()
                  if ln.strip()]
    finally:
        conn.close()
    toks = [t for f in frames for t in f.get("tokens", [])]
    return toks, frames[-1]


def _replica_stats(name):
    ctl = ray_tpu_torch.get_actor("_serve_controller", namespace="serve")
    reps = ray_tpu_torch.get(ctl.get_replicas.remote(name), timeout=TIMEOUT)
    return ray_tpu_torch.get(
        [r.handle_request.remote("stats", (), {}, None) for r in reps],
        timeout=TIMEOUT)


def test_llm_server_matches_jax_through_handle_and_http(ray_start_8cpu):
    prompts = [[1, 2, 3, 4, 5], list(range(10, 50)), [7] * 20]
    params, want = _jax_tokens(0, prompts, 8)
    port = serve.start(http_port=0)
    handle = serve.run(build_llm_app(
        name="tl", num_replicas=1, preset="tiny", params=params,
        device="cpu", max_slots=4, decode_block=2, max_queue_depth=None,
        router_kwargs={"stats_interval_s": 0.2}), route_prefix="/tl")
    for p, w in zip(prompts, want):
        toks, final = _consume(handle, {"prompt": p, "max_new_tokens": 8})
        assert toks == w and final["n_tokens"] == 8
        assert _post(port, "/tl", {"prompt": p,
                                   "max_new_tokens": 8})["tokens"] == w
        toks, final = _post_stream(port, "/tl",
                                   {"prompt": p, "max_new_tokens": 8})
        assert toks == w and final["done"] and final["n_tokens"] == 8
    rstats = ray_tpu_torch.get(handle.method("stats").remote(),
                               timeout=TIMEOUT)
    assert rstats["requests"] == 3 * len(prompts) and rstats["shed"] == 0
    (st,) = _replica_stats("tl")
    assert st["tokens_generated"] == 3 * 8 * len(prompts)
    serve.shutdown()


def test_disagg_app_matches_jax_monolithic(ray_start_8cpu):
    base = list(range(3, 83))                       # 80 tokens: 1 group
    prompts = [base, base[:70] + [99] * 10,         # shares group 0
               [(7 * i) % 250 + 3 for i in range(100)],  # 1 group
               [5, 6, 7]]                           # under a page: none
    params, want = _jax_tokens(0, prompts, 6)
    # the groups the prefill replica can export: full pages of the
    # prompt less its last token (admission keeps >= 1 token un-paged),
    # a hash at each full group's boundary
    with jax_reference() as ref:
        ref_hashes = [
            ref.kv_transfer.group_boundary_hashes(p[:-1], PAGE, GROUP)
            for p in prompts]
    assert ref_hashes == [kv_transfer.group_boundary_hashes(p[:-1], PAGE,
                                                            GROUP)
                          for p in prompts]
    distinct = {h for hs in ref_hashes for h in hs}
    assert len(distinct) == 2

    handle = serve.run(build_llm_app(
        name="tdz", disaggregated=True, prefill_replicas=1,
        decode_replicas=1, preset="tiny", params=params, device="cpu",
        kv_layout="paged", page_size=PAGE, group_pages=GROUP, max_slots=4,
        decode_block=2, max_queue_depth=None,
        router_kwargs={"stats_interval_s": 0.2}))
    for p, w in zip(prompts, want):
        toks, final = _consume(handle, {"prompt": p, "max_new_tokens": 6})
        assert toks == w, (len(p), toks, w)
        assert final["done"] and final["n_tokens"] == 6
    rstats = ray_tpu_torch.get(handle.method("stats").remote(),
                               timeout=TIMEOUT)
    assert rstats["handoffs"] == len(prompts)
    assert rstats["handoffs_lost"] == 0
    (pf,) = _replica_stats("tdz_prefill")
    (dec,) = _replica_stats("tdz_decode")
    # each group crossed the store once; the shared one was reused
    assert pf["handoff_puts"] == len(distinct)
    assert pf["handoff_reused_groups"] == \
        sum(map(len, ref_hashes)) - len(distinct)
    assert pf["handoff_acked"] == len(prompts)
    group_bytes = pf["handoff_put_bytes"] // pf["handoff_puts"]
    # (k, v) x layers x kv heads x group tokens x head dim x f32
    cfg = llama.PRESETS["tiny"]
    assert group_bytes == (2 * cfg.n_layers * cfg.n_kv_heads * PAGE * GROUP
                           * (cfg.d_model // cfg.n_heads) * 4)
    assert dec["adopt_adopted_groups"] == sum(map(len, ref_hashes))
    assert dec["adopt_adopted_bytes"] == \
        dec["adopt_adopted_groups"] * group_bytes
    # the exporter registered the reference's hashes, byte for byte
    entries = kv_transfer.PrefixDirectory().lookup(sorted(distinct))
    assert all(e is not None for e in entries)
    serve.shutdown()


def test_multiplexed_server_serves_published_models_like_jax(
        ray_start_8cpu):
    prompts = [[1, 2, 3, 4, 5], list(range(30, 60))]
    models = {}
    registry = ModelRegistry()   # the publisher's refs pin the weights
    for mid, seed in (("tiny-a", 1), ("tiny-b", 2)):
        params, want = _jax_tokens(seed, prompts, 6)
        models[mid] = want
        # published as a tree of CPU tensors: the replica's fetch returns
        # CPU tensors, which the engine places on its device
        registry.publish(mid, llama.params_from_jax(params, "cpu"))
    handle = serve.run(build_llm_app(
        name="tmx", num_replicas=1, multiplexed=True, preset="tiny",
        device="cpu", max_slots=4, decode_block=2, max_queue_depth=None,
        router_kwargs={"stats_interval_s": 0.2}))
    for _ in range(2):
        for mid, want in models.items():
            for p, w in zip(prompts, want):
                toks, final = _consume(handle, {
                    "prompt": p, "max_new_tokens": 6, "model": mid})
                assert toks == w, (mid, toks, w)
                assert final["done"] and final.get("status") is None
    (st,) = _replica_stats("tmx")
    assert sorted(st["models"]) == sorted(models)
    assert st["model_loads"] == len(models)
    serve.shutdown()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_engine_places_host_tree():
    src = LLMEngine(preset="tiny", seed=0, device="cpu")
    as_np = _tree_map(lambda t: t.numpy(), src.params)
    eng = LLMEngine(preset="tiny", params=as_np, device="cpu")
    assert all(isinstance(x, torch.Tensor) for x in _tree_leaves(eng.params))
    # a tree already on the device is kept as it is, leaf for leaf
    same = LLMEngine(preset="tiny", params=src.params, device="cpu")
    assert all(a is b for a, b in zip(_tree_leaves(same.params),
                                      _tree_leaves(src.params)))
    p = [4, 8, 15, 16, 23, 42]
    assert eng.generate(p, 6) == same.generate(p, 6) == src.generate(p, 6)


def test_serve_package_imports_no_torch():
    code = ("import sys; import ray_tpu_torch.serve as s; "
            "assert callable(s.build_llm_app) and s.LLMRouter; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
