"""Parity of ray_tpu_torch/models/llama.py against ray_tpu/models/llama.py
on the ``tiny`` preset in f32, with the same weights (the JAX init, carried
over by ``params_from_jax``) and the same numpy inputs.

Tolerances: logits and activations within 1e-4 (f32 matmuls of width 64
and 128 summed in another order, through 2 layers); KV written by copy
(``scatter_prefill_pages``) must be exactly equal. Pools are compared
EXCLUDING trash page 0, which takes duplicate pad writes in an undefined
order on both sides.
"""

import numpy as np
import pytest
import torch

from test_torch_support import jax_reference, jax_tree_to_np, to_np

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu_torch.models import llama  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, port cfg, numpy params) of the tiny preset in f32."""
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jnp.float32)
        params = jax_tree_to_np(ref.llama.init_params(
            jax.random.PRNGKey(0), jcfg))
    tcfg = llama.PRESETS["tiny"].replace(dtype=torch.float32)
    return jcfg, tcfg, params


def _pools(seed, L=2, KV=2, NP=17, ps=8, HD=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, KV, NP, ps, HD)).astype(np.float32),
            rng.standard_normal((L, KV, NP, ps, HD)).astype(np.float32))


def _table(seed, S, maxP, NP):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, NP))[:S * maxP].reshape(
        S, maxP).astype(np.int32)


def test_params_from_jax_round_trip(tiny):
    jcfg, tcfg, params = tiny
    tp = llama.params_from_jax(params, "cpu")
    shapes = jax.tree.map(lambda a: a.shape, params)
    ported = llama.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {k: v.shape for k, v in tp["layers"].items()} == \
        {k: tuple(v) for k, v in shapes["layers"].items()}
    assert {k: tuple(v.shape) for k, v in ported["layers"].items()} == \
        {k: tuple(v) for k, v in shapes["layers"].items()}
    for k in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(to_np(tp[k]), params[k])
        assert tuple(ported[k].shape) == params[k].shape
    for k, v in params["layers"].items():
        assert np.array_equal(to_np(tp["layers"][k]), v)
    with jax_reference() as ref:
        for name in ("tiny", "1b", "7b"):
            assert llama.num_params(llama.PRESETS[name]) == \
                ref.llama.num_params(ref.llama.PRESETS[name])
            assert llama.param_specs(llama.PRESETS[name]) == \
                ref.llama.param_specs(ref.llama.PRESETS[name])


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    with jax_reference() as ref:
        jn = np.asarray(ref.llama.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                           1e-5))
        cos, sin = ref.llama._rope_tables(10000.0, 5, 16)
        jr = np.asarray(ref.llama.apply_rope(jnp.asarray(x), cos, sin))
    tn = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    tc, ts = llama._rope_tables(10000.0, 5, 16)
    tr = llama.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(to_np(tn), jn, atol=1e-6, rtol=0)
    np.testing.assert_allclose(to_np(tc), np.asarray(cos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(to_np(tr), jr, atol=1e-5, rtol=0)


@pytest.mark.parametrize("attn_impl,P", [("xla", 16), ("flash", 128)])
def test_prefill_matches_jax(tiny, attn_impl, P):
    jcfg, tcfg, params = tiny
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, size=(3, P)).astype(np.int32)
    lens = np.array([P, P - 5, 3], np.int32)
    with jax_reference() as ref:
        jl, jk, jv = ref.llama.prefill(
            params, jnp.asarray(toks), jnp.asarray(lens),
            jcfg.replace(attn_impl=attn_impl))
        jl, jk, jv = map(np.asarray, (jl, jk, jv))
    tl, tk, tv = llama.prefill(
        llama.params_from_jax(params, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(lens), tcfg.replace(attn_impl=attn_impl))
    assert tuple(tk.shape) == jk.shape == (2, 3, P, 2, 16)
    np.testing.assert_allclose(to_np(tl), jl, atol=TOL, rtol=0)
    np.testing.assert_allclose(to_np(tk), jk, atol=TOL, rtol=0)
    np.testing.assert_allclose(to_np(tv), jv, atol=TOL, rtol=0)


def test_forward_clamps_rope_offset_like_jax(tiny):
    """pos_offset past max_seq_len - S: JAX's dynamic_slice_in_dim clamps
    the RoPE start to max_seq_len - S (tiny: 128 - 64), so offset 100 gives
    offset 64's logits; the port clamps an int and a 0-d tensor offset the
    same way. Within TOL of JAX; the clamped offsets exactly equal."""
    jcfg, tcfg, params = tiny
    assert tcfg.max_seq_len == 128
    toks = np.random.default_rng(10).integers(0, 256, size=(1, 64)).astype(
        np.int32)
    with jax_reference() as ref:
        jl = np.asarray(ref.llama.forward(params, jnp.asarray(toks), jcfg,
                                          pos_offset=100))
    tp = llama.params_from_jax(params, "cpu")
    tt = torch.from_numpy(toks)
    at64 = llama.forward(tp, tt, tcfg, pos_offset=64)
    for off in (100, torch.tensor(100)):
        tl = llama.forward(tp, tt, tcfg, pos_offset=off)
        np.testing.assert_allclose(to_np(tl), jl, atol=TOL, rtol=0)
        assert torch.equal(tl, at64)
    # a tensor offset inside the table is not moved
    assert torch.equal(llama.forward(tp, tt, tcfg, pos_offset=torch.tensor(7)),
                       llama.forward(tp, tt, tcfg, pos_offset=7))


def test_fused_matmuls_match_unfused(tiny):
    _, tcfg, params = tiny
    tp = llama.params_from_jax(params, "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32))
    lens = torch.tensor([16, 9], dtype=torch.int32)
    a = llama.prefill(tp, toks, lens, tcfg)[0]
    b = llama.prefill(tp, toks, lens, tcfg.replace(fused_matmuls=True))[0]
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_scatter_prefill_pages_matches_jax():
    rng = np.random.default_rng(4)
    kp, vp = _pools(5)
    ks = rng.standard_normal((2, 3, 16, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((2, 3, 16, 2, 16)).astype(np.float32)
    table = _table(6, 4, 2, 17)
    slots = np.array([2, 0, 3], np.int32)
    lens = np.array([16, 9, 1], np.int32)
    with jax_reference() as ref:
        jk, jv = ref.llama.scatter_prefill_pages(
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(table), jnp.asarray(slots),
            jnp.asarray(lens), 8)
        jk, jv = np.asarray(jk), np.asarray(jv)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ok, ov = llama.scatter_prefill_pages(
        tk, tv, torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(table), torch.from_numpy(slots),
        torch.from_numpy(lens), 8)
    assert ok is tk and ov is tv          # updated in place
    assert np.array_equal(to_np(tk)[:, :, 1:], jk[:, :, 1:])
    assert np.array_equal(to_np(tv)[:, :, 1:], jv[:, :, 1:])


def test_decode_step_paged_matches_jax(tiny):
    jcfg, tcfg, params = tiny
    kp, vp = _pools(7)
    table = _table(8, 4, 4, 17)
    # slot 1 inactive; slot 2 starts a fresh page; slot 3 fills one
    toks = np.array([[3], [7], [11], [250]], np.int32)
    lens = np.array([5, 9, 8, 15], np.int32)
    active = np.array([1, 0, 1, 1], np.int32)
    with jax_reference() as ref:
        out = ref.llama.decode_step_paged(
            params, jnp.asarray(toks), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lens), jcfg,
            active=jnp.asarray(active))
        jl, jk, jv, jlen = map(np.asarray, out)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, _, _, tlen = llama.decode_step_paged(
        llama.params_from_jax(params, "cpu"), torch.from_numpy(toks), tk, tv,
        torch.from_numpy(table), torch.from_numpy(lens), tcfg,
        active=torch.from_numpy(active))
    live = active > 0
    np.testing.assert_allclose(to_np(tl)[live], jl[live], atol=TOL, rtol=0)
    assert np.array_equal(to_np(tlen), jlen)
    np.testing.assert_allclose(to_np(tk)[:, :, 1:], jk[:, :, 1:], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(to_np(tv)[:, :, 1:], jv[:, :, 1:], atol=TOL,
                               rtol=0)


def test_prefill_paged_tail_matches_jax(tiny):
    jcfg, tcfg, params = tiny
    kp, vp = _pools(9)
    table = _table(10, 4, 4, 17)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, size=(4, 16)).astype(np.int32)
    tail = np.array([16, 7, 1, 0], np.int32)     # last row: batch padding
    prefix = np.array([8, 16, 23, 0], np.int32)
    with jax_reference() as ref:
        out = ref.llama.prefill_paged_tail(
            params, jnp.asarray(toks), jnp.asarray(tail),
            jnp.asarray(prefix), jnp.asarray(table), jnp.asarray(kp),
            jnp.asarray(vp), jcfg)
        jl, jk, jv = map(np.asarray, out)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, _, _ = llama.prefill_paged_tail(
        llama.params_from_jax(params, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(tail), torch.from_numpy(prefix),
        torch.from_numpy(table), tk, tv, tcfg)
    real = tail > 0
    np.testing.assert_allclose(to_np(tl)[real], jl[real], atol=TOL, rtol=0)
    np.testing.assert_allclose(to_np(tk)[:, :, 1:], jk[:, :, 1:], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(to_np(tv)[:, :, 1:], jv[:, :, 1:], atol=TOL,
                               rtol=0)


def test_init_paged_cache_layout():
    cfg = llama.PRESETS["tiny"]
    kp, vp = llama.init_paged_cache(cfg, 9, 8, dtype=torch.float32,
                                    device="cpu")
    assert kp.shape == vp.shape == (2, 2, 9, 8, 16)
    assert kp.dtype == torch.float32 and not kp.any()


def test_ring_attention_raises_not_implemented(tiny):
    _, tcfg, params = tiny
    with pytest.raises(NotImplementedError, match="ring"):
        llama.prefill(llama.params_from_jax(params, "cpu"),
                      torch.zeros((1, 8), dtype=torch.int32),
                      torch.tensor([8], dtype=torch.int32),
                      tcfg.replace(attn_impl="ring"))


# --- int8 weights -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """(JAX cfg, port cfg, float params, JAX's int8 tree as numpy)."""
    jcfg, tcfg, params = tiny
    with jax_reference() as ref:
        q = jax_tree_to_np(ref.llama.quantize_params_int8(
            jax.tree.map(jnp.asarray, params)))
    return jcfg, tcfg, params, q


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_params_int8_matches_jax_bit_for_bit(tiny_int8):
    _, _, params, jq = tiny_int8
    tq = llama.quantize_params_int8(llama.params_from_jax(params, "cpu"))
    assert tq["embed"]["s8"].shape == (1, 64)
    assert tq["lm_head"]["s8"].shape == (1, 256)
    assert tq["layers"]["wq"]["s8"].shape == (2, 1, 64)
    assert tq["layers"]["attn_norm"].dtype == torch.float32
    jl, tl = dict(_leaves(jq)), dict(_leaves(tq))
    assert jl.keys() == tl.keys()
    for name, j in jl.items():
        t = tl[name]
        if name.endswith("q8"):
            assert t.dtype == torch.int8
            assert np.array_equal(t.numpy(), j), name
        elif name.endswith("s8"):
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.float().numpy(), j.astype(np.float32)), \
                name
        else:
            assert np.array_equal(t.numpy(), j), name
    # idempotent: a quantized tree passes through unchanged
    again = llama.quantize_params_int8(tq)
    assert all(again_leaf is tl[n] for n, again_leaf in _leaves(again))


def test_params_from_jax_keeps_integer_leaves(tiny_int8):
    _, _, _, jq = tiny_int8
    tp = llama.params_from_jax(jq, "cpu", torch.float32)
    assert tp["layers"]["wq"]["q8"].dtype == torch.int8
    assert tp["embed"]["q8"].dtype == torch.int8
    assert tp["layers"]["wq"]["s8"].dtype == torch.float32
    assert tp["final_norm"].dtype == torch.float32
    assert np.array_equal(tp["lm_head"]["q8"].numpy(), jq["lm_head"]["q8"])
    kept = llama.params_from_jax(jq, "cpu")
    assert kept["layers"]["w_up"]["s8"].dtype == torch.bfloat16


@pytest.mark.parametrize("fn", ["forward", "prefill"])
def test_int8_params_match_jax(tiny_int8, fn):
    jcfg, tcfg, _, jq = tiny_int8
    tp = llama.params_from_jax(jq, "cpu")
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    with jax_reference() as ref:
        jp = jax.tree.map(jnp.asarray, jq)
        if fn == "forward":
            j = np.asarray(ref.llama.forward(jp, jnp.asarray(toks), jcfg))
        else:
            j = np.asarray(ref.llama.prefill(jp, jnp.asarray(toks),
                                             jnp.asarray(lens), jcfg)[0])
    if fn == "forward":
        t = llama.forward(tp, torch.from_numpy(toks), tcfg)
    else:
        t = llama.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens),
                          tcfg)[0]
    np.testing.assert_allclose(to_np(t), j, atol=1e-5, rtol=0)


# --- contiguous cache -----------------------------------------------------------

CONTIG_TOL = 1e-5


def _cache_np(seed, L=2, B=4, S=32, KV=2, HD=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, B, S, KV, HD)).astype(np.float32),
            rng.standard_normal((L, B, S, KV, HD)).astype(np.float32))


def _torch_cache(k, v, length):
    return llama.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                         torch.from_numpy(np.asarray(length, np.int32)))


def test_init_cache_layout_and_specs():
    cfg = llama.PRESETS["tiny"]
    c = llama.init_cache(cfg, 3, max_seq=40, dtype=torch.float32,
                         device="cpu")
    assert c.k.shape == c.v.shape == (2, 3, 40, 2, 16)
    assert c.length.dtype == torch.int32 and c.length.shape == (3,)
    assert not c.k.any() and not c.length.any()
    assert llama.init_cache(cfg, 1, device="cpu").k.shape[2] == 128
    with jax_reference() as ref:
        assert tuple(llama.cache_specs(cfg)) == tuple(
            ref.llama.cache_specs(ref.llama.PRESETS["tiny"]))


@pytest.mark.parametrize("attn_impl,window", [("xla", None), ("flash", None),
                                              ("xla", 6)])
def test_decode_step_matches_jax(tiny, attn_impl, window):
    jcfg, tcfg, params = tiny
    jcfg = jcfg.replace(attn_impl=attn_impl, sliding_window=window)
    tcfg = tcfg.replace(attn_impl=attn_impl, sliding_window=window)
    k, v = _cache_np(13)
    S = k.shape[2]
    # rows at different positions; row 1 inactive; row 3 past the end of
    # its row (JAX clamps the write to S - 1)
    lens = np.array([5, 9, 17, S], np.int32)
    active = np.array([1, 0, 1, 1], np.int32)
    toks = np.array([[3], [7], [11], [250]], np.int32)
    with jax_reference() as ref:
        jc = ref.llama.KVCache(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lens))
        jl, jc = ref.llama.decode_step(params, jnp.asarray(toks), jc, jcfg,
                                       active=jnp.asarray(active))
        jl, jk, jv, jlen = map(np.asarray, (jl, jc.k, jc.v, jc.length))
    tc = _torch_cache(k, v, lens)
    tl, out = llama.decode_step(llama.params_from_jax(params, "cpu"),
                                torch.from_numpy(toks), tc, tcfg,
                                active=torch.from_numpy(active))
    assert out.k is tc.k and out.v is tc.v      # written in place
    live = active > 0
    np.testing.assert_allclose(to_np(tl)[live], jl[live], atol=CONTIG_TOL,
                               rtol=0)
    assert np.array_equal(to_np(out.length), jlen)
    np.testing.assert_allclose(to_np(out.k), jk, atol=CONTIG_TOL, rtol=0)
    np.testing.assert_allclose(to_np(out.v), jv, atol=CONTIG_TOL, rtol=0)
    assert np.array_equal(to_np(out.k)[:, 1], k[:, 1])   # inactive row


@pytest.mark.parametrize("attn_impl,window,T", [("xla", None, 16),
                                                ("flash", None, 128),
                                                ("xla", 6, 16)])
def test_prefill_tail_contiguous_matches_jax(tiny, attn_impl, window, T):
    jcfg, tcfg, params = tiny
    S = 256
    jcfg = jcfg.replace(attn_impl=attn_impl, sliding_window=window,
                        max_seq_len=S)
    tcfg = tcfg.replace(attn_impl=attn_impl, sliding_window=window,
                        max_seq_len=S)
    k, v = _cache_np(14, B=4, S=S)
    length = np.array([4, 0, 9, 30], np.int32)
    rng = np.random.default_rng(15)
    toks = rng.integers(0, 256, size=(3, T)).astype(np.int32)
    tail = np.array([T, 7, 0], np.int32)
    prefix = np.array([4, 0, 9], np.int32)
    slots = np.array([0, 1, 2], np.int32)
    with jax_reference() as ref:
        jc = ref.llama.KVCache(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(length))
        jl, jc = ref.llama.prefill_tail_contiguous(
            params, jnp.asarray(toks), jnp.asarray(tail), jnp.asarray(prefix),
            jc, jnp.asarray(slots), jcfg)
        jl, jk, jv, jlen = map(np.asarray, (jl, jc.k, jc.v, jc.length))
    tc = _torch_cache(k, v, length)
    tl, out = llama.prefill_tail_contiguous(
        llama.params_from_jax(params, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(tail), torch.from_numpy(prefix), tc,
        torch.from_numpy(slots), tcfg)
    real = tail > 0
    np.testing.assert_allclose(to_np(tl)[real], jl[real], atol=CONTIG_TOL,
                               rtol=0)
    assert np.array_equal(to_np(out.length), jlen)
    np.testing.assert_allclose(to_np(out.k), jk, atol=CONTIG_TOL, rtol=0)
    np.testing.assert_allclose(to_np(out.v), jv, atol=CONTIG_TOL, rtol=0)


def test_prefill_tail_contiguous_valid_write_wins_at_the_last_row(tiny):
    """A chunk that ends on the row's last position: its pad positions
    clamp onto the same row as the last valid token, whose write must
    land."""
    _, tcfg, params = tiny
    tp = llama.params_from_jax(params, "cpu")
    k, v = _cache_np(16, B=1, S=32)
    toks = torch.from_numpy(np.random.default_rng(17).integers(
        0, 256, size=(1, 12)).astype(np.int32))
    padded = torch.cat([toks, torch.zeros((1, 4), dtype=torch.int32)], 1)
    outs = []
    for t in (toks, padded):
        tc = _torch_cache(k, v, [20])
        llama.prefill_tail_contiguous(
            tp, t, torch.tensor([12]), torch.tensor([20]), tc,
            torch.tensor([0]), tcfg)
        outs.append(tc)
    assert torch.equal(outs[0].k, outs[1].k)
    assert torch.equal(outs[0].v, outs[1].v)
    assert not torch.equal(outs[1].k[:, 0, 31], torch.from_numpy(k[:, 0, 31]))


@pytest.mark.parametrize("attn_impl,S,offset", [("xla", 16, 0),
                                                ("xla", 16, 40),
                                                ("flash", 128, 0)])
def test_forward_with_cache_matches_jax(tiny, attn_impl, S, offset):
    jcfg, tcfg, params = tiny
    T = 256
    jcfg = jcfg.replace(attn_impl=attn_impl, max_seq_len=T)
    tcfg = tcfg.replace(attn_impl=attn_impl, max_seq_len=T)
    k, v = _cache_np(18, B=2, S=T)
    length = np.array([offset, offset], np.int32)
    toks = np.random.default_rng(19).integers(0, 256, size=(2, S)).astype(
        np.int32)
    with jax_reference() as ref:
        jc = ref.llama.KVCache(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(length))
        jl, jc = ref.llama.forward_with_cache(params, jnp.asarray(toks), jc,
                                              jcfg, offset)
        jl, jk, jv, jlen = map(np.asarray, (jl, jc.k, jc.v, jc.length))
    tc = _torch_cache(k, v, length)
    tl, out = llama.forward_with_cache(
        llama.params_from_jax(params, "cpu"), torch.from_numpy(toks), tc,
        tcfg, offset)
    np.testing.assert_allclose(to_np(tl), jl, atol=CONTIG_TOL, rtol=0)
    assert np.array_equal(to_np(out.length), jlen)
    np.testing.assert_allclose(to_np(out.k), jk, atol=CONTIG_TOL, rtol=0)
    np.testing.assert_allclose(to_np(out.v), jv, atol=CONTIG_TOL, rtol=0)


def _int8_call(m, fn, params, A, cfg):
    """Run one serving layer loop of module m (the JAX reference or the
    port) on fixed numpy inputs; A turns numpy into m's arrays. Returns
    (logits, the contiguous cache's k or None)."""
    toks = np.random.default_rng(20).integers(0, 256, size=(4, 8)).astype(
        np.int32)
    kp, vp = _pools(21)
    table = _table(22, 4, 4, 17)
    k, v = _cache_np(23, B=2, S=64)

    def i32(*x):
        return A(np.array(x, np.int32))

    cache = m.KVCache(A(k), A(v), i32(6, 11))
    if fn == "decode_step_paged":
        return m.decode_step_paged(params, A(toks[:, :1]), A(kp), A(vp),
                                   A(table), i32(5, 9, 8, 15), cfg)[0], None
    if fn == "prefill_paged_tail":
        return m.prefill_paged_tail(params, A(toks), i32(8, 5, 1, 1),
                                    i32(8, 16, 23, 0), A(table), A(kp),
                                    A(vp), cfg)[0], None
    if fn == "decode_step":
        out = m.decode_step(params, A(toks[:2, :1]), cache, cfg)
    elif fn == "prefill_tail_contiguous":
        out = m.prefill_tail_contiguous(params, A(toks[:2]), i32(8, 3),
                                        i32(6, 11), cache, i32(0, 1), cfg)
    else:
        out = m.forward_with_cache(params, A(toks[:2]), cache, cfg, 6)
    return out[0], out[1].k


@pytest.mark.parametrize("fn", ["decode_step_paged", "prefill_paged_tail",
                                "decode_step", "prefill_tail_contiguous",
                                "forward_with_cache"])
def test_int8_layer_loops_match_jax(tiny_int8, fn):
    """Every serving layer loop takes {"q8", "s8"} leaves, as in JAX."""
    jcfg, tcfg, _, jq = tiny_int8
    with jax_reference() as ref:
        jl, jk = _int8_call(ref.llama, fn, jax.tree.map(jnp.asarray, jq),
                            jnp.asarray, jcfg)
        jl, jk = np.asarray(jl), None if jk is None else np.asarray(jk)
    tl, tk = _int8_call(llama, fn, llama.params_from_jax(jq, "cpu"),
                        lambda a: torch.from_numpy(np.array(a)), tcfg)
    np.testing.assert_allclose(to_np(tl), jl, atol=CONTIG_TOL, rtol=0)
    if jk is not None:
        np.testing.assert_allclose(to_np(tk), jk, atol=CONTIG_TOL, rtol=0)
