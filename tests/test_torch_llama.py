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
