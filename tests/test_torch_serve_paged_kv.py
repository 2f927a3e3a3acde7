"""Paged KV cache engine, the port's copy of tests/test_serve_paged_kv.py:
pool/page-table correctness, paged==contiguous generation parity, page
reuse across requests, recompute-preemption, and 429 admission control.
Engines run on the CPU (``device="cpu"``, f32 ``tiny``); the parity of
these engines with JAX's is tests/test_torch_llm_engine.py's. The ``cuda``
test places a host tree on the card (an engine given CPU weights, as a
multiplexed ``LLMServer`` gets them from ``ModelRegistry``)."""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.paged_attention import paged_attention_reference
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm import LLMQueueFull
from ray_tpu_torch.serve.paged_kv import PagePool
from test_torch_support import require_cuda

LLMEngine = functools.partial(llm.LLMEngine, device="cpu")


def test_page_pool_alloc_release():
    pool = PagePool(num_pages=9, page_size=4, max_slots=2,
                    max_pages_per_slot=4)
    assert pool.free_pages == 8
    assert pool.grow(0, 7)            # 2 pages
    assert pool.used_pages == 2
    assert pool.table[0, 0] != 0 and pool.table[0, 1] != 0
    assert pool.grow(0, 8)            # still 2 pages
    assert pool.used_pages == 2
    assert pool.grow(1, 16)           # 4 pages
    assert not pool.grow(0, 17)       # would exceed max_pages_per_slot
    assert not pool.grow(1, 17)
    pool.release(1)
    assert pool.free_pages == 6
    assert (pool.table[1] == 0).all()


def test_paged_attention_reference_masks_trash():
    """Tokens past a slot's length never contribute, even when the page
    table points at shared/trash pages."""
    S, H, KV, HD, ps, NP, maxP = 2, 2, 1, 8, 4, 6, 2
    rng = np.random.default_rng(1)
    kp = np.asarray(rng.normal(size=(KV, NP, ps, HD)), np.float32)
    vp = np.asarray(rng.normal(size=(KV, NP, ps, HD)), np.float32)
    q = np.asarray(rng.normal(size=(S, H, HD)), np.float32)
    pt = np.array([[2, 3], [2, 0]], np.int32)   # slot 1 shares page 2
    lens = np.array([6, 3], np.int32)
    t = torch.from_numpy
    out = paged_attention_reference(t(q), t(kp), t(vp), t(pt), t(lens))
    # poisoning beyond-length positions must not change the output
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[:, 3, 2:] = 1e3
    kp2[:, 0] = -1e3
    vp2[:, 0] = 1e3
    out2 = paged_attention_reference(t(q), t(kp2), t(vp2), t(pt), t(lens))
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(out2[1]),
                               rtol=1e-5)


def _greedy(engine, prompt, n):
    return engine.generate(list(prompt), max_new_tokens=n, temperature=0.0)


def test_paged_matches_contiguous():
    """Same params, same prompts: the paged engine must produce the
    exact greedy tokens the contiguous engine does."""
    cont = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=3)
    paged = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=3,
                      kv_layout="paged", page_size=8)
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4] * 17]
    for p in prompts:
        a = _greedy(cont, p, 12)
        b = _greedy(paged, p, 12)
        assert a == b, (p, a, b)


def test_paged_page_reuse_and_release():
    eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=32, seed=0,
                    kv_layout="paged", page_size=8, num_pages=9)
    assert eng.pool.available_pages == 8
    _greedy(eng, [1, 2, 3, 4], 8)
    # released on finish: every page is reusable again — registered
    # prefix pages park in the evictable cache, the rest go free
    assert eng.pool.available_pages == 8
    _greedy(eng, [5] * 10, 8)
    assert eng.pool.available_pages == 8
    # and with caching off, release goes straight back to the free list
    eng2 = LLMEngine(preset="tiny", max_slots=2, max_seq_len=32, seed=0,
                     kv_layout="paged", page_size=8, num_pages=9,
                     prefix_caching=False)
    _greedy(eng2, [1, 2, 3, 4], 8)
    assert eng2.pool.free_pages == 8


def test_paged_concurrency_beyond_contiguous_hbm():
    """The headline property: with the HBM a contiguous cache would
    spend on 2 slots (2 * max_seq/ps pages), the paged engine runs 6
    concurrent short requests."""
    max_seq, ps = 64, 8
    pages_contig_2slots = 2 * (max_seq // ps)            # 16 pages
    eng = LLMEngine(preset="tiny", max_slots=6, max_seq_len=max_seq,
                    seed=0, kv_layout="paged", page_size=ps,
                    num_pages=pages_contig_2slots + 1)
    reqs = [eng.submit([i + 1, i + 2, i + 3], max_new_tokens=6)
            for i in range(6)]
    # all six admit simultaneously: 6 slots x 1 page each <= 16 pages
    eng.step()
    with eng.lock:
        assert sum(1 for s in eng.slots if s is not None) == 6
    while any(not r.done_event.is_set() for r in reqs):
        eng.step_n(4)
    assert all(len(r.generated) == 6 for r in reqs)


def test_paged_preemption_recompute():
    """Pool too small for every active request to keep growing: the
    newest request is evicted (pages freed), requeued, and completes
    later with identical greedy output."""
    ps = 4
    eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=64, seed=1,
                    kv_layout="paged", page_size=ps, num_pages=8)
    ref = LLMEngine(preset="tiny", max_slots=1, max_seq_len=64, seed=1)
    p1, p2 = [1, 2, 3, 4, 5], [9, 8, 7]
    r1 = eng.submit(p1, max_new_tokens=16)
    r2 = eng.submit(p2, max_new_tokens=16)
    while not (r1.done_event.is_set() and r2.done_event.is_set()):
        eng.step_n(4)
    assert eng.metrics.get("preemptions", 0) >= 1
    assert r1.generated == _greedy(ref, p1, 16)
    assert r2.generated == _greedy(ref, p2, 16)


def test_queue_depth_admission_control():
    eng = LLMEngine(preset="tiny", max_slots=1, max_seq_len=32, seed=0,
                    kv_layout="paged", page_size=8, max_queue_depth=2)
    # fill the slot + the queue
    eng.submit([1, 2], max_new_tokens=4)
    eng.step()                                   # admit into the slot
    eng.submit([3, 4], max_new_tokens=4)
    eng.submit([5, 6], max_new_tokens=4)
    with pytest.raises(LLMQueueFull):
        eng.submit([7, 8], max_new_tokens=4)
    assert eng.metrics["rejected"] == 1
    # drain everything; the queued two still complete
    while eng.has_work():
        eng.step_n(4)
    assert eng.metrics["tokens_generated"] >= 12


def test_preemption_budget_not_double_counted():
    """After recompute-preemption folds generated tokens into the resume
    prompt, length accounting must not double-count them: a request with
    room in max_seq still gets its full max_new_tokens."""
    ps = 4
    eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=64, seed=2,
                    kv_layout="paged", page_size=ps, num_pages=8)
    r1 = eng.submit([1, 2, 3], max_new_tokens=20)
    r2 = eng.submit([4, 5, 6], max_new_tokens=20)
    while not (r1.done_event.is_set() and r2.done_event.is_set()):
        eng.step_n(4)
    assert eng.metrics.get("preemptions", 0) >= 1
    assert len(r1.generated) == 20
    assert len(r2.generated) == 20


def test_oversized_prompt_rejected_not_stuck():
    """A prompt that can never fit the page pool fails fast with an
    error instead of head-of-line blocking the queue forever."""
    eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=64, seed=0,
                    kv_layout="paged", page_size=8, num_pages=4)  # 24 toks
    big = eng.submit(list(range(2, 40)), max_new_tokens=4)   # 38 > 24
    ok = eng.submit([1, 2, 3], max_new_tokens=4)
    while eng.has_work():
        eng.step_n(4)
    assert big.done_event.is_set()
    assert big.error and "exceeds" in big.error
    assert len(ok.generated) == 4 and ok.error is None


def test_prefix_cache_hit_matches_cold():
    """Automatic prefix caching (ref: vLLM APC): a second prompt sharing
    the first's full pages must adopt them (no prefill, shared physical
    pages) and still emit the exact same greedy continuation."""
    shared = list(range(1, 25))                     # 3 full pages @ ps=8
    tail_a, tail_b = [30, 31], [30, 31]             # identical requests
    eng = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=5,
                    kv_layout="paged", page_size=8)
    cold = _greedy(eng, shared + tail_a, 10)
    assert eng.metrics.get("prefix_hits", 0) == 0
    used_before = eng.pool.used_pages
    warm = _greedy(eng, shared + tail_b, 10)
    assert eng.metrics.get("prefix_hits", 0) == 1
    assert eng.metrics.get("prefix_hit_tokens", 0) == 24
    assert warm == cold, (cold, warm)
    # the hit must SHARE the 3 prefix pages, not copy them: only the
    # tail + generation may allocate beyond the snapshot (prompt 26 +
    # 10 generated = 36 tokens -> 5 pages; 3 shared -> at most 2 new)
    assert eng.pool.used_pages - used_before <= 2, \
        (used_before, eng.pool.used_pages)
    # reference engine without caching agrees too
    ref = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=5,
                    kv_layout="paged", page_size=8, prefix_caching=False)
    assert _greedy(ref, shared + tail_b, 10) == cold


def test_prefix_cache_divergent_tail():
    """Same prefix, different tails: both hit the cache yet produce
    their own (distinct, correct) continuations."""
    shared = [3] * 16                               # 2 full pages @ ps=8
    eng = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=6,
                    kv_layout="paged", page_size=8)
    ref = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=6,
                    kv_layout="paged", page_size=8, prefix_caching=False)
    a = _greedy(eng, shared + [40, 41], 8)
    b = _greedy(eng, shared + [50, 51, 52], 8)
    assert eng.metrics.get("prefix_hits", 0) == 1   # second request hit
    assert a == _greedy(ref, shared + [40, 41], 8)
    assert b == _greedy(ref, shared + [50, 51, 52], 8)


def test_prefix_cache_pages_shared_not_copied():
    """Concurrent requests with one cached prefix consume pages for the
    prefix ONCE (refcounted sharing, not copies)."""
    shared = list(range(2, 26))                     # 3 full pages @ ps=8
    eng = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=7,
                    kv_layout="paged", page_size=8)
    eng.generate(shared + [40], 2)                  # registers the prefix
    r1 = eng.submit(shared + [41], 4)
    r2 = eng.submit(shared + [42], 4)
    eng._admit()
    with eng.lock:
        o1, o2 = eng.pool.owned[r1.slot], eng.pool.owned[r2.slot]
    assert o1[:3] == o2[:3], "prefix pages must be the same physical pages"
    assert (eng.pool.ref[o1[0]] >= 2), "shared page must be multi-ref"
    while not (r1.done_event.is_set() and r2.done_event.is_set()):
        eng.step()
    assert r1.error is None and r2.error is None


def test_prefix_cache_eviction_under_pressure():
    """Refcount-0 cached pages are reclaimable: filling the pool with
    new requests evicts them instead of failing admission."""
    eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=32, seed=8,
                    kv_layout="paged", page_size=8, num_pages=9)
    eng.generate(list(range(1, 18)), 3)             # registers 2 pages
    assert eng.pool.cache_stats()["registered"] >= 1
    assert len(eng.pool.evictable) >= 1
    # a fat unrelated prompt needs more pages than the free list alone
    out = eng.generate([9] * 20, 3)
    assert len(out) == 3
    assert eng.pool.used_pages <= eng.pool.num_pages - 1


def test_decode_beyond_preset_max_seq_rope():
    """Serving past the preset's cfg.max_seq_len must extend the RoPE
    tables (regression: decode paths sized tables from cfg.max_seq_len,
    and jax's clamping OOB gather gave every position >= that the LAST
    row's rotation — silently diverging from prefill, which sizes its
    tables to the actual prompt). tiny preset: cfg.max_seq_len=128."""
    long_prompt = list(range(2, 160))     # crosses 128 during decode
    eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=256, seed=9,
                    kv_layout="paged", page_size=64)
    assert eng.cfg.max_seq_len == 256     # extended by the engine
    out_paged = _greedy(eng, long_prompt, 6)
    cont = LLMEngine(preset="tiny", max_slots=2, max_seq_len=256, seed=9)
    out_cont = _greedy(cont, long_prompt, 6)
    assert out_paged == out_cont, (out_paged, out_cont)


def test_chunked_tail_lifts_prefix_cache_cap():
    """A half-matched prompt whose unmatched tail exceeds
    prefix_cache_max_tail no longer falls back to a full re-prefill
    (VERDICT r4 weak 5): the prefix pages are adopted and the tail
    prefills in bounded chunks across admission rounds, with exact
    greedy output."""
    shared = list(range(1, 25))                     # 3 full pages @ ps=8
    tail = [50 + i for i in range(20)]              # unmatched 20 > cap 8
    eng = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=11,
                    kv_layout="paged", page_size=8,
                    prefix_cache_max_tail=8)
    eng.generate(shared + [40, 41], max_new_tokens=4)   # register prefix
    warm = _greedy(eng, shared + tail, 8)
    assert eng.metrics.get("prefix_hits", 0) == 1, \
        "long tail must no longer reject the prefix hit"
    assert eng.metrics.get("prefix_hit_tokens", 0) == 24
    ref = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=11,
                    kv_layout="paged", page_size=8, prefix_caching=False)
    assert warm == _greedy(ref, shared + tail, 8)


def test_chunked_prefill_matches_unchunked():
    """prefill_chunk bounds per-round prefill compute for BOTH kv
    layouts without changing results (contiguous shares the chunked
    path via prefill_tail_contiguous)."""
    prompt = list(range(2, 50))                     # 48 tokens, chunk 8
    for layout in ("paged", "contiguous"):
        kw = dict(preset="tiny", max_slots=2, max_seq_len=64, seed=12,
                  kv_layout=layout)
        if layout == "paged":
            kw["page_size"] = 8
        want = _greedy(LLMEngine(**kw), prompt, 8)
        got = _greedy(LLMEngine(prefill_chunk=8, **kw), prompt, 8)
        assert got == want, layout


def test_chunked_prefill_interleaves_decode():
    """A long prompt mid-chunked-prefill must not stall or corrupt a
    concurrently decoding request; both emit their solo greedy tokens."""
    long_p = list(range(2, 50))
    short_p = [7, 8, 9]
    base = dict(preset="tiny", max_slots=2, max_seq_len=64, seed=13,
                kv_layout="paged", page_size=8, prefix_caching=False)
    ref = LLMEngine(**base)
    want_short = _greedy(ref, short_p, 6)
    want_long = _greedy(ref, long_p, 6)
    eng = LLMEngine(prefill_chunk=8, **base)
    r_short = eng.submit(short_p, max_new_tokens=6)
    eng.step()                                      # short admits+decodes
    r_long = eng.submit(long_p, max_new_tokens=6)   # chunks over rounds
    while eng.has_work():
        eng.step()
    assert r_short.generated == want_short
    assert r_long.generated == want_long


@pytest.mark.slow
def test_int8_quantized_engine_serves():
    """Weight-only int8 (serving path for 7B-in-16GB, BASELINE.md target
    4): the quantized engine generates sane tokens on both layouts, its
    logits track the full-precision model, and the at-rest weights are
    int8."""
    cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32)
    params = llama.init_params(torch.Generator().manual_seed(21), cfg)
    qparams = llama.quantize_params_int8(params)
    assert qparams["layers"]["wq"]["q8"].dtype == torch.int8
    assert qparams["embed"]["q8"].dtype == torch.int8
    toks = torch.arange(2, 34, dtype=torch.int32)[None, :]
    full = llama.forward(params, toks, cfg)
    quant = llama.forward(qparams, toks, cfg)
    # per-channel int8 keeps logits close enough that rankings barely move
    corr = np.corrcoef(full.detach().numpy().ravel(),
                       quant.detach().numpy().ravel())[0, 1]
    assert corr > 0.99, corr

    for layout in ("contiguous", "paged"):
        kw = {"page_size": 8} if layout == "paged" else {}
        eng = LLMEngine(preset="tiny", max_slots=2, max_seq_len=64, seed=21,
                        kv_layout=layout, quantize="int8", **kw)
        out = _greedy(eng, list(range(2, 34)), 8)
        assert len(out) == 8 and all(0 <= t < 256 for t in out), (layout,
                                                                  out)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


@pytest.mark.cuda
def test_engine_places_cpu_tree_on_the_card():
    require_cuda()
    cfg = llama.PRESETS["tiny"]
    host = llama.init_params(torch.Generator().manual_seed(3),
                             cfg.replace(param_dtype=cfg.dtype))
    placed = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.cuda())
              for k, v in host.items()}
    eng = llm.LLMEngine(cfg=cfg, params=host, device="cuda")
    ref = llm.LLMEngine(cfg=cfg, params=placed, device="cuda")
    assert all(x.is_cuda for x in _tree_leaves(eng.params))
    assert all(not x.is_cuda for x in _tree_leaves(host))
    p = [4, 8, 15, 16, 23, 42]
    assert eng.generate(p, 8) == ref.generate(p, 8)
