"""Disaggregated prefill/decode serving (serve/disagg.py, kv_transfer.py).

Unit layer (no cluster): group-boundary chain hashes commit to the whole
prefix; HandoffExporter dedups retained groups (transfer accounting:
each group's bytes cross the store exactly once), holds per-handoff pin
refs until ack, and refuses export after close; HandoffAdopter counts
adopted groups/bytes and failures; MemoryTracker.attribute_pin_many
records a pin wave under one lock.

Cluster layer (real serve stack, SimLLMServer pools): the two-stage
stream keeps the monolithic token-continuity contract (token i of a
prompt of length L is L+i — bitwise identical to the monolithic app on
the same prompt set); a prefill replica killed mid-prefill re-routes and
the client stream still gets the exact sequence; a second prefill
replica adopts a directory-warm prefix from the store (global hit
counters + zero re-puts prove the bytes moved once).

Port of tests/test_serve_disagg.py, aimed at ray_tpu_torch.
The slow ``test_serve_disagg_bench_smoke`` drives the JAX package's
``bench.py`` and waits with it (ROADMAP.md queue 1 item 11.5).
"""

import asyncio
import threading
import time
import types

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.kv_transfer import (HandoffAdopter,
                                             HandoffExporter,
                                             PrefixDirectory,
                                             group_boundary_hashes)
from ray_tpu_torch.serve.llm_deployment import SimLLMServer, build_llm_app
from torch_runtime_support import (  # noqa: F401
    ray_start_8cpu, ray_start_regular, reap_orphans)

_PAGE, _GROUP = 16, 4
_GTOK = _PAGE * _GROUP


@pytest.fixture()
def fake_runtime(monkeypatch):
    """Exporter construction reads the runtime's node_id; give it a stub
    so transfer-plane unit tests run without a cluster."""
    from ray_tpu_torch.core import runtime as rt

    monkeypatch.setattr(rt, "_global_runtime",
                        types.SimpleNamespace(node_id="unit-test-node"))


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


def _replica_stats(name):
    reps = ray_tpu_torch.get(_controller().get_replicas.remote(name))
    return reps, ray_tpu_torch.get(
        [r.handle_request.remote("stats", (), {}, None) for r in reps])


def _mem_store():
    """In-memory object store stand-in for transfer unit tests."""
    store = {}

    def put(payload):
        ref = f"ref-{len(store)}"
        store[ref] = payload
        return ref

    return store, put


# ---------------------------------------------------------------- unit layer


def test_group_boundary_hashes_commit_to_prefix():
    tokens = list(range(3 * _GTOK))
    h = group_boundary_hashes(tokens, _PAGE, _GROUP)
    assert len(h) == 3
    assert h == group_boundary_hashes(list(tokens), _PAGE, _GROUP)
    assert len(set(h)) == 3   # boundaries are distinct
    # chain hashes commit to EVERY earlier token: flip one token inside
    # the first group and every boundary hash changes
    mut = list(tokens)
    mut[3] += 1
    h2 = group_boundary_hashes(mut, _PAGE, _GROUP)
    assert all(a != b for a, b in zip(h, h2))
    # ...but a flip inside the SECOND group leaves the first boundary
    # (its prefix) intact
    mut = list(tokens)
    mut[_GTOK + 1] += 1
    h3 = group_boundary_hashes(mut, _PAGE, _GROUP)
    assert h3[0] == h[0] and h3[1] != h[1] and h3[2] != h[2]
    # partial trailing group never gets a boundary
    assert len(group_boundary_hashes(tokens[:_GTOK + 5], _PAGE, _GROUP)) == 1
    assert group_boundary_hashes(tokens[:_GTOK - 1], _PAGE, _GROUP) == []


def _np_group(tokens):
    def payload_for_group(s, e):
        return np.asarray(tokens[s:e], np.int32)

    return payload_for_group


def test_exporter_dedup_ack_and_close(fake_runtime):
    store, put = _mem_store()
    ex = HandoffExporter(owner="repA", page_tokens=_PAGE, group_pages=_GROUP,
                         retained_groups=64, directory=None, put=put)
    tokens = list(range(2 * _GTOK))
    nbytes_of = lambda a: int(a.nbytes)

    env = ex.export(tokens, _np_group(tokens), nbytes_of)
    assert len(env["groups"]) == 2
    assert env["prompt_len"] == len(tokens)
    assert env["nbytes"] == sum(g["nbytes"] for g in env["groups"])
    assert [len(g["page_hashes"]) for g in env["groups"]] == [_GROUP, _GROUP]
    st = ex.stats()
    assert st["puts"] == 2 and st["handoffs"] == 1
    assert st["inflight_handoffs"] == 1 and st["retained_groups"] == 2

    # transfer accounting: a second export of the same prefix re-uses the
    # retained refs — no new puts, the bytes crossed the store ONCE
    env2 = ex.export(tokens, _np_group(tokens), nbytes_of)
    st = ex.stats()
    assert st["puts"] == 2 and st["reused_groups"] == 2
    assert st["handoffs"] == 2 and st["inflight_handoffs"] == 2
    assert [g["ref"] for g in env2["groups"]] == \
        [g["ref"] for g in env["groups"]]
    assert len(store) == 2

    # ack releases the per-handoff pin refs; unknown ids are a no-op
    assert ex.ack(env["handoff_id"]) is True
    assert ex.ack(env["handoff_id"]) is False
    assert ex.ack("repB:99") is False
    st = ex.stats()
    assert st["acked"] == 1 and st["inflight_handoffs"] == 1

    # close expires the remaining handoff and refuses further exports
    ex.close()
    st = ex.stats()
    assert st["unacked_expired"] == 1 and st["inflight_handoffs"] == 0
    assert st["retained_groups"] == 0
    with pytest.raises(RuntimeError):
        ex.export(tokens, _np_group(tokens), nbytes_of)
    ex.close()   # idempotent


def test_exporter_retained_lru_evicts_cold_groups(fake_runtime):
    store, put = _mem_store()
    ex = HandoffExporter(owner="repA", page_tokens=_PAGE, group_pages=_GROUP,
                         retained_groups=1, directory=None, put=put)
    nbytes_of = lambda a: int(a.nbytes)
    a = list(range(0, 2 * _GTOK))
    ex.export(a, _np_group(a), nbytes_of)
    st = ex.stats()
    assert st["retained_groups"] == 1 and st["retained_evicted"] == 1
    # the survivor is the LAST group; re-exporting the same prompt must
    # re-put the evicted leading group
    ex.export(a, _np_group(a), nbytes_of)
    st = ex.stats()
    assert st["puts"] == 3 and st["reused_groups"] == 1


def test_exporter_seed_makes_foreign_groups_reusable(fake_runtime):
    """seed() adopts another owner's (hash, ref, nbytes) triples: later
    exports of that prefix reference the FOREIGN refs — zero local puts
    for the shared prefix."""
    store, put = _mem_store()
    tokens = list(range(2 * _GTOK))
    nbytes_of = lambda a: int(a.nbytes)
    ex_a = HandoffExporter(owner="repA", page_tokens=_PAGE,
                           group_pages=_GROUP, retained_groups=64,
                           directory=None, put=put)
    env_a = ex_a.export(tokens, _np_group(tokens), nbytes_of)

    ex_b = HandoffExporter(owner="repB", page_tokens=_PAGE,
                           group_pages=_GROUP, retained_groups=64,
                           directory=None, put=put)
    ex_b.seed([(g["hash"], g["ref"], g["nbytes"])
               for g in env_a["groups"]])
    assert all(ex_b.has(g["hash"]) for g in env_a["groups"])
    env_b = ex_b.export(tokens, _np_group(tokens), nbytes_of)
    st = ex_b.stats()
    assert st["puts"] == 0 and st["reused_groups"] == 2
    assert [g["ref"] for g in env_b["groups"]] == \
        [g["ref"] for g in env_a["groups"]]


def test_adopter_accounting_and_failure():
    store = {"r0": np.arange(_GTOK), "r1": np.arange(_GTOK)}
    ad = HandoffAdopter(get=store.__getitem__)
    env = {"groups": [{"hash": b"h0", "ref": "r0", "nbytes": 512},
                      {"hash": b"h1", "ref": "r1", "nbytes": 512}]}
    out = ad.adopt(env)
    assert len(out) == 2 and out[0] is store["r0"]
    st = ad.stats()
    assert st["adopts"] == 1 and st["adopted_groups"] == 2
    assert st["adopted_bytes"] == 1024 and st["adopt_failures"] == 0
    # a dangling ref (exporter died, primary unpinned) surfaces as an
    # exception the decode replica converts to a handoff_lost frame
    with pytest.raises(KeyError):
        ad.adopt({"groups": [{"hash": b"hx", "ref": "gone", "nbytes": 1}]})
    assert ad.stats()["adopt_failures"] == 1


def test_attribute_pin_many_batches_records():
    from ray_tpu_torch.observability.memory import MemoryTracker

    t = MemoryTracker()
    t.attribute_pin_many([(b"k1", 100), (b"k2", 200)],
                         reason="primary", owner="nodeA")
    t.attribute_pin_many([(b"k1", 150)], reason="primary", owner="nodeA")
    snap = t.snapshot()
    recs = {r["key"]: r for r in snap["records"]}
    k1 = recs[b"k1".hex()]
    k2 = recs[b"k2".hex()]
    assert k1["nbytes"] == 150   # resize on re-pin, not duplicate record
    assert k1["pins"]["primary"]["count"] == 2
    assert k2["nbytes"] == 200 and k2["pins"]["primary"]["count"] == 1
    assert t.subsystem_bytes()["user"] == 350


def test_handoff_lost_frame_from_decode_replica():
    """Decode-side contract: an adopt that can't resolve its refs yields
    a typed handoff_lost frame (the router's re-prefill trigger), not an
    exception up the stream."""
    d = SimLLMServer(mode="decode", use_directory=False)
    d._adopter = HandoffAdopter(
        get=lambda ref: (_ for _ in ()).throw(RuntimeError("primary gone")))
    env = {"handoff_id": "repA:1", "prompt_len": 64,
           "groups": [{"hash": b"h", "ref": "dead", "nbytes": 8}]}

    async def drive():
        frames = []
        async for f in d.adopt_decode(env, {"max_new_tokens": 4}):
            frames.append(f)
        return frames

    frames = asyncio.run(drive())
    assert frames == [{"handoff_lost": True, "done": True}]
    assert d.metrics["handoffs_lost"] == 1


# ------------------------------------------------------------- cluster layer


def _disagg_app(name="dz", **kw):
    kw.setdefault("prefill_s_per_token", 0.0005)
    kw.setdefault("decode_s_per_token", 0.001)
    return build_llm_app(name=name, use_sim=True, disaggregated=True,
                         prefill_replicas=2, decode_replicas=2,
                         router_kwargs={"stats_interval_s": 0.2},
                         max_queue_depth=None, **kw)


def test_disagg_matches_monolithic_bitwise(ray_start_8cpu):
    """Same prompt set through both topologies -> identical token
    streams (the sim engine is deterministic, so any envelope/adoption
    bug — wrong prompt_len, dropped frame, duplicated failover tokens —
    breaks the equality), plus the handoff lifecycle counters on the
    disagg side: every prefill acked, nothing pinned past its attempt,
    exports registered in the GCS global prefix directory."""
    prompts = [[9100 + i for i in range(_GTOK)],
               [9100 + i for i in range(2 * _GTOK + 5)],
               [9500 + i for i in range(3)]]   # below one page: no export

    handle = serve.run(build_llm_app(
        name="mono", use_sim=True, num_replicas=2,
        router_kwargs={"stats_interval_s": 0.2}, max_queue_depth=None))
    mono = [_consume(handle, {"prompt": p, "max_new_tokens": 6})[0]
            for p in prompts]
    serve.shutdown()

    handle = serve.run(_disagg_app())
    dz = [_consume(handle, {"prompt": p, "max_new_tokens": 6})[0]
          for p in prompts]
    rstats = ray_tpu_torch.get(handle.method("stats").remote())
    assert rstats["handoffs"] == 3 and rstats["handoffs_lost"] == 0
    _, pf_stats = _replica_stats("dz_prefill")
    _, dec_stats = _replica_stats("dz_decode")
    assert sum(s["prefills"] for s in pf_stats) == 3
    assert sum(s["decodes"] for s in dec_stats) == 3
    # every prefill pin was released by the router's ack
    assert sum(s.get("handoff_acked", 0) for s in pf_stats) == 3
    assert sum(s.get("handoff_inflight_handoffs", 0) for s in pf_stats) == 0
    # prefill exports landed in the GCS global prefix directory
    assert PrefixDirectory().stats()["registered"] >= 2
    serve.shutdown()

    assert mono == dz
    assert mono == [list(range(len(p), len(p) + 6)) for p in prompts]


def test_chaos_prefill_death_mid_handoff(ray_start_8cpu):
    """Kill the prefill replica while it owns the in-flight prefill: the
    router re-routes to the survivor and the client stream still gets
    the exact token sequence."""
    handle = serve.run(_disagg_app(prefill_s_per_token=0.012))
    L, N = 2 * _GTOK, 8   # ~1.5s prefill: a wide kill window
    prompt = [11000 + i for i in range(L)]

    out = {}

    def drive():
        out["toks"], out["final"] = _consume(
            handle, {"prompt": prompt, "max_new_tokens": N}, timeout=120)

    th = threading.Thread(target=drive)
    th.start()
    deadline = time.time() + 20
    victim = None
    while victim is None and time.time() < deadline:
        reps, stats = _replica_stats("dz_prefill")
        busy = [r for r, s in zip(reps, stats)
                if s["active_slots"] + s["pending"] > 0]
        if busy:
            victim = busy[0]
        else:
            time.sleep(0.02)
    assert victim is not None, "prefill never showed the in-flight request"
    ray_tpu_torch.kill(victim, no_restart=True)
    th.join(timeout=120)
    assert not th.is_alive()

    assert out["final"] and out["final"]["done"]
    assert out["toks"] == list(range(L, L + N)), (
        f"tokens duplicated/dropped across prefill failover: {out['toks']}")
    rstats = ray_tpu_torch.get(handle.method("stats").remote())
    assert rstats["prefill_reroutes"] >= 1, "router never saw the death"
    assert rstats["handoffs"] >= 1
    serve.shutdown()


def test_chaos_decode_death_reroutes_with_continuity(ray_start_8cpu):
    """Decode-side death mid-stream: the router re-prefills prompt +
    emitted-so-far and the combined stream has no gap or duplicate."""
    handle = serve.run(_disagg_app(decode_s_per_token=0.03,
                                   tokens_per_frame=2))
    L, N = 2 * _GTOK, 20
    prompt = [13000 + i for i in range(L)]
    gen = handle.options(stream=True).method("stream_request").remote(
        {"prompt": prompt, "max_new_tokens": N})
    toks, final, killed = [], None, False
    for ref in gen:
        item = ray_tpu_torch.get(ref, timeout=120)
        if item.get("done"):
            final = item
        toks.extend(item.get("tokens", []))
        if not killed and len(toks) >= 4:
            reps, stats = _replica_stats("dz_decode")
            victims = [r for r, s in zip(reps, stats)
                       if s["active_slots"] > 0]
            assert victims, "no decode replica reports the active stream"
            ray_tpu_torch.kill(victims[0], no_restart=True)
            killed = True
    assert killed and final and final["done"]
    assert final.get("reroutes", 0) >= 1
    assert toks == list(range(L, L + N)), (
        f"tokens duplicated/dropped across decode failover: {toks}")
    serve.shutdown()


def test_global_prefix_adoption_second_replica(ray_start_regular):
    """Two prefill engines sharing only the GCS directory: B resolves
    A's exported prefix, fetches the groups once from the store, and its
    own export re-references A's objects — global_prefix_hits counts the
    adoption, puts==0 proves the page bytes crossed the store exactly
    once cluster-wide, prefill_tokens==0 proves the prefill work for the
    shared prefix was skipped entirely."""
    prompt = [15000 + i for i in range(2 * _GTOK)]
    a = SimLLMServer(mode="prefill")
    res_a = asyncio.run(a.prefill_request({"prompt": prompt}))
    env_a = res_a["envelope"]
    assert len(env_a["groups"]) == 2
    st_a = a._exporter.stats()
    assert st_a["puts"] == 2 and st_a["put_bytes"] == env_a["nbytes"]
    assert a.metrics["prefill_tokens"] == len(prompt)

    b = SimLLMServer(mode="prefill")
    res_b = asyncio.run(b.prefill_request({"prompt": prompt}))
    env_b = res_b["envelope"]
    assert b.metrics["global_prefix_hits"] == 1
    assert b.metrics["global_prefix_hit_tokens"] == len(prompt)
    assert b.metrics["prefill_tokens"] == 0
    st_b = b._exporter.stats()
    assert st_b["puts"] == 0 and st_b["put_bytes"] == 0
    assert st_b["reused_groups"] == 2
    # B's envelope references A's store objects — same refs, no copy
    assert [g["ref"] for g in env_b["groups"]] == \
        [g["ref"] for g in env_a["groups"]]
    # the adoption really resolved bytes (one zero-copy get per group)
    assert b._adopter.stats()["adopted_groups"] == 2
    d = PrefixDirectory().stats()
    assert d["registered"] >= 2 and d["hits"] >= 2
    a._exporter.close()
    b._exporter.close()


def test_spill_tier_counters_surface_in_state(ray_start_regular):
    """The nodelet's lifetime spill/restore counters ride node_stats into
    memory_summary() per node and fold into memory_report()'s
    cluster-wide spill_tier rollup."""
    from ray_tpu_torch.util import state

    keys = ("spilled_then_dropped", "restored_objects",
            "spill_bytes_total", "restore_bytes_total")
    deadline = time.time() + 10
    nodes = {}
    while time.time() < deadline:
        nodes = state.memory_summary().get("nodes") or {}
        if nodes:
            break
        time.sleep(0.2)
    assert nodes, "no node_stats reached GCS"
    for st in nodes.values():
        for k in keys:
            assert k in st, f"node stats missing {k}"
    tier = state.memory_report().get("spill_tier")
    assert tier is not None
    for k in keys + ("spilled_objects", "spilled_bytes"):
        assert k in tier, f"spill_tier rollup missing {k}"
