"""The attention paths at the head dims and group counts that the public
model shapes need and the presets do not have: head dim 16 (the tiny
presets' training), 80 (Phi-2), 96 (Phi-3-mini), 256 (Gemma-2B), 320 and
512 (DeepSeek-V4-Flash; above 256 the card runs the wide kernels), and
3 (Llama-3.2-3B) and 7 (Qwen2-7B) query heads a kv head.

Each shape is a 2-layer model at d_model = n_heads * head_dim, and each
path is held against ``ray_tpu`` on the same weights (the JAX init,
carried over by ``params_from_jax``) and the same numpy inputs, the JAX
side run as its own tests run it on the CPU (the Pallas flash kernels in
interpret mode; the paged kernels' references off-TPU). Tolerances are
those of ``test_torch_flash_attention.py`` and ``test_torch_llama.py``
(f32 sums in another order): attention outputs within 1e-5, their
gradients within 1e-4, logits and losses within 1e-4, model gradients
within 1e-4 absolute plus 1e-3 relative; greedy tokens and the pools'
written rows exact where the same values are copied.

Also here: the zero-pad to the kernels' next compiled head dim
(``on_kernel_head_dim``) on the plain versions, and the shapes each paged
decode block takes (``block_geometry``). The kernels themselves are held
against the plain versions at these shapes in the ``cuda``-marked tests of
``test_torch_flash_attention.py`` and ``test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_support import jax_reference, jax_tree_to_np, to_np

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402
from ray_tpu_torch.parallel import train_step as ts  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402

ATTN_TOL = 1e-5
ATTN_GRAD_TOL = 1e-4
TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3

# name: (head dim, query heads, kv heads)
SHAPES = {
    "hd16": (16, 2, 2),
    "hd80": (80, 2, 2),
    "hd96": (96, 2, 1),
    "hd256": (256, 2, 1),
    "hd320": (320, 2, 1),
    "hd512": (512, 2, 2),
    "g3": (16, 3, 1),
    "g7": (16, 7, 1),
}
NAMES = sorted(SHAPES)


def _cfgs(name):
    """(JAX cfg, port cfg) of a 2-layer f32 model at the shape."""
    HD, H, KV = SHAPES[name]
    kw = dict(vocab_size=256, d_model=H * HD, n_layers=2, n_heads=H,
              n_kv_heads=KV, d_ff=2 * H * HD, max_seq_len=256)
    with jax_reference() as ref:
        jcfg = ref.llama.LlamaConfig(**kw, dtype=jnp.float32)
    tcfg = llama.LlamaConfig(**kw, dtype=torch.float32)
    assert tcfg.head_dim == HD
    return jcfg, tcfg


_PARAMS = {}


def _model(name):
    """(JAX cfg, port cfg, numpy params) from the JAX init, seed 0."""
    if name not in _PARAMS:
        jcfg, tcfg = _cfgs(name)
        with jax_reference() as ref:
            params = jax_tree_to_np(ref.llama.init_params(
                jax.random.PRNGKey(0), jcfg))
        _PARAMS[name] = (jcfg, tcfg, params)
    return _PARAMS[name]


def _qkv(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


# --- the flash route ------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_flash_forward_and_grads_match_jax(name):
    """flash_attention's output and (dq, dk, dv) through the port's
    autograd Function against JAX's flash_attention and jax.grad through
    its Pallas K1 and K3/K4, causal, S 128."""
    HD, H, KV = SHAPES[name]
    q, k, v = _qkv(1, 128, H, KV, HD, seed=1)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    with jax_reference() as ref:
        def loss(q, k, v):
            return (ref.flash_attention.flash_attention(
                q, k, v, causal=True, block_q=64, block_k=64)
                * jnp.asarray(w)).sum()

        jo = np.asarray(ref.flash_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=64, block_k=64))
        jg = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(to_np(out.detach()), jo, atol=ATTN_TOL,
                               rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(to_np(t.grad), j, atol=ATTN_GRAD_TOL,
                                   rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_flash_loss_and_grads_match_jax(name):
    """loss_fn with attn_impl="flash" at S 128 (the flash route) and its
    gradients against jax.value_and_grad of the reference's."""
    jcfg, tcfg, params = _model(name)
    toks = np.random.default_rng(3).integers(0, 256, (2, 129)).astype(
        np.int32)
    batch = {"tokens": toks}
    with jax_reference() as ref:
        jcfg2 = jcfg.replace(attn_impl="flash")
        jloss, jg = jax.value_and_grad(
            lambda p: ref.llama.loss_fn(p, batch, jcfg2))(params)
        jg = jax_tree_to_np(jg)
    tp = ts._map(lambda t: t.requires_grad_(True),
                 llama.params_from_jax(params, "cpu"))
    tloss = llama.loss_fn(tp, {"tokens": torch.from_numpy(toks)},
                          tcfg.replace(attn_impl="flash"))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL

    def close(ours, theirs):
        if isinstance(theirs, dict):
            for key in theirs:
                close(ours[key], theirs[key])
            return
        np.testing.assert_allclose(to_np(ours.grad), np.asarray(theirs),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)

    close(tp, jg)


@pytest.mark.parametrize("name", NAMES)
def test_flash_prefill_matches_jax(name):
    """prefill at bucket 128 (flash): logits and the K/V it returns."""
    jcfg, tcfg, params = _model(name)
    toks = np.random.default_rng(4).integers(0, 256, (2, 128)).astype(
        np.int32)
    lens = np.array([128, 100], np.int32)
    with jax_reference() as ref:
        out = ref.llama.prefill(params, jnp.asarray(toks), jnp.asarray(lens),
                                jcfg.replace(attn_impl="flash"))
        jl, jk, jv = map(np.asarray, out)
    tl, tk, tv = llama.prefill(
        llama.params_from_jax(params, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(lens), tcfg.replace(attn_impl="flash"))
    for t, j in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(to_np(t), j, atol=TOL, rtol=0)


# --- the paged decode route ---------------------------------------------------------


def _paged_case(H, KV, HD, seed, S=6, ps=8, maxP=4):
    """Six slots over pages of 8: an inactive slot, a fresh tip page, a
    full page, and two slots sharing their first two pages."""
    rng = np.random.default_rng(seed)
    NP = S * maxP + 1
    table = rng.permutation(np.arange(1, NP))[:S * maxP].reshape(S, maxP)
    table[5, :2] = table[4, :2]
    return dict(
        q=rng.standard_normal((S, H, HD)).astype(np.float32),
        k_new=rng.standard_normal((S, KV, HD)).astype(np.float32),
        v_new=rng.standard_normal((S, KV, HD)).astype(np.float32),
        k_pool=rng.standard_normal((KV, NP, ps, HD)).astype(np.float32),
        v_pool=rng.standard_normal((KV, NP, ps, HD)).astype(np.float32),
        page_table=table.astype(np.int32),
        lengths=np.array([0, 9, 16, 5, 25, 32], np.int32))


INPLACE_ARGS = ("q", "k_new", "v_new", "k_pool", "v_pool", "page_table",
                "lengths")
READ_ARGS = ("q", "k_pool", "v_pool", "page_table", "lengths")


@pytest.mark.parametrize("name", NAMES)
def test_paged_decode_inplace_matches_jax(name):
    """K6's route: live outputs within 1e-5, the pools equal to JAX's
    except trash page 0 (whose contents neither side reads)."""
    HD, H, KV = SHAPES[name]
    case = _paged_case(H, KV, HD, seed=5)
    with jax_reference() as ref:
        out = ref.paged_attention.paged_decode_attention_inplace(
            *(jnp.asarray(case[a]) for a in INPLACE_ARGS))
        jo, jk, jv = map(np.asarray, out)
    t = {a: torch.from_numpy(case[a].copy()) for a in INPLACE_ARGS}
    o, kp, vp = pa.paged_decode_attention_inplace(*(t[a] for a in
                                                    INPLACE_ARGS))
    live = case["lengths"] > 0
    assert o.shape == (6, H, HD)
    np.testing.assert_allclose(to_np(o)[live], jo[live], atol=ATTN_TOL,
                               rtol=0)
    assert np.array_equal(to_np(kp)[:, 1:], jk[:, 1:])
    assert np.array_equal(to_np(vp)[:, 1:], jv[:, 1:])


@pytest.mark.parametrize("name", NAMES)
def test_paged_attention_matches_jax(name):
    """K5's route: live outputs within 1e-5, the pools untouched."""
    HD, H, KV = SHAPES[name]
    case = _paged_case(H, KV, HD, seed=6)
    with jax_reference() as ref:
        jo = np.asarray(ref.paged_attention.paged_attention(
            *(jnp.asarray(case[a]) for a in READ_ARGS)))
    t = {a: torch.from_numpy(case[a].copy()) for a in READ_ARGS}
    o = pa.paged_attention(*(t[a] for a in READ_ARGS))
    live = case["lengths"] > 0
    np.testing.assert_allclose(to_np(o)[live], jo[live], atol=ATTN_TOL,
                               rtol=0)
    assert np.array_equal(t["k_pool"].numpy(), case["k_pool"])
    assert np.array_equal(t["v_pool"].numpy(), case["v_pool"])


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_paged_matches_jax(name):
    """One decode step of the model over paged pools (K6 on every layer):
    live logits, the new lengths and the pools past the trash page."""
    jcfg, tcfg, params = _model(name)
    HD, _, KV = SHAPES[name]
    rng = np.random.default_rng(7)
    kp, vp = (rng.standard_normal((2, KV, 17, 8, HD)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(np.arange(1, 17))[:16].reshape(4, 4).astype(
        np.int32)
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
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(to_np(t)[:, :, 1:], j[:, :, 1:],
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_paged_engine_greedy_tokens_match_jax(name):
    """The paged engine with flash prefill (a 127-token prompt, bucket
    128) and a short one, decoding through K6's route: greedy tokens
    equal to JAX's engine on the same weights."""
    jcfg, tcfg, params = _model(name)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, 127).tolist(),
               rng.integers(0, 256, 20).tolist()]
    kw = dict(kv_layout="paged", page_size=16, max_slots=2, seed=0)
    with jax_reference() as ref:
        je = ref.llm.LLMEngine(cfg=jcfg.replace(attn_impl="flash"),
                               params=jax.tree_util.tree_map(
                                   jnp.asarray, params), **kw)
        jreqs = [je.submit(p, max_new_tokens=6) for p in prompts]
        while je.has_work():
            je.step_n(8)
        jt = [r.generated for r in jreqs]
    te = LLMEngine(cfg=tcfg.replace(attn_impl="flash"),
                   params=llama.params_from_jax(params, "cpu"),
                   device="cpu", **kw)
    treqs = [te.submit(p, max_new_tokens=6) for p in prompts]
    while te.has_work():
        te.step_n(8)
    assert [r.generated for r in treqs] == jt
    assert all(len(g) == 6 for g in jt)


# --- the kernels' head-dim padding and the paged blocks' geometry ------------------


def _grid_qkv(B, S, H, KV, D, seed):
    """q, k, v, dO on a grid of 1/8 in [-2, 2], so every q.k and dO.v is
    exact in f32 whatever the order or width of the sum."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        (rng.integers(-16, 17, shape) / 8.0).astype(np.float32))
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                      (B, S, H, D))]


# the padded run scales its (exact) scores by D ** -0.5 where the plain
# version divides by sqrt(D), and the sums over keys (p.v, dS.k, ...) run
# in an order that the einsum picks by the width of its operands: both
# round otherwise, within f32 rounding of values below ~10
PAD_TOL = 1e-6


@pytest.mark.parametrize("D,Dk", [(48, 64), (112, 128)])
def test_padded_head_dim_equals_unpadded_on_the_plain_versions(D, Dk):
    """on_kernel_head_dim, which every CUDA launch at a head dim the
    kernels are not compiled for goes through, run on the plain versions:
    at D zero-padded to Dk with the true D's scale, the padded columns of
    out, dq, dk and dv come out exactly 0, and out, the LSE and the
    gradients equal the plain versions at D within PAD_TOL."""
    assert fa.kernel_head_dim(D) == Dk
    q, k, v, g = _grid_qkv(2, 96, 4, 2, D, seed=9)
    padded = []

    def fwd(q, k, v, scale):
        assert q.shape[-1] == Dk
        padded.append(fa.flash_attention_reference(q, k, v, causal=True,
                                                   scale=scale))
        return padded[-1]

    out, lse = fa.flash_attention_reference(q, k, v, causal=True)
    pout, plse = fa.on_kernel_head_dim(fwd, (q, k, v), n_out=1)
    assert pout.shape == out.shape and pout.is_contiguous()
    assert torch.equal(padded[0][0][..., D:], torch.zeros_like(
        padded[0][0][..., D:]))
    torch.testing.assert_close(plse, lse, atol=PAD_TOL, rtol=0)
    torch.testing.assert_close(pout, out, atol=PAD_TOL, rtol=0)

    def bwd(q, k, v, out, g, scale):
        padded.append(fa.flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal=True, scale=scale))
        return padded[-1]

    grads = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=True)
    pgrads = fa.on_kernel_head_dim(bwd, (q, k, v, out, g), n_out=3)
    for a, b, full in zip(pgrads, grads, padded[1]):
        assert a.shape == b.shape and full.shape[-1] == Dk
        assert not full[..., D:].any()
        torch.testing.assert_close(a, b, atol=PAD_TOL, rtol=0)


def test_kernel_head_dims_cover_every_dim_up_to_1024():
    """Every D in 1..1024 runs at a kernel head dim at least D, with no
    raise: up to 256 the next compiled one, above it the next multiple of
    WIDE_MULTIPLE (the wide kernels take D at run time)."""
    for D in range(1, 1025):
        dk = fa.kernel_head_dim(D)
        assert dk >= D
        if D <= 256:
            assert dk in fa.KERNEL_HEAD_DIMS
            assert not [c for c in fa.KERNEL_HEAD_DIMS if D <= c < dk]
        else:
            assert dk % fa.WIDE_MULTIPLE == 0 and dk - D < fa.WIDE_MULTIPLE
    assert fa.kernel_head_dim(96) == 96 and fa.kernel_head_dim(80) == 80
    assert fa.kernel_head_dim(512) == 512 and fa.kernel_head_dim(260) == 264


# (kernel, heads a block, chunks, pages a split, splits, ring slots, shared
# memory bytes) at 16 slots of 32 pages of 64
@pytest.mark.parametrize("G,HD,elt,KV,expect", [
    (1, 128, 2, 32, ("ring", 1, 1, 8, 4, 4, 34664)),   # the 7b preset, bf16
    (2, 128, 4, 8, ("fixed", 2, 1, 4, 8, 0, 8208)),    # the 1b preset, f32
    (8, 256, 2, 1, ("ring", 8, 1, 1, 32, 4, 67928)),   # Gemma-2B, bf16
    (1, 96, 2, 32, ("ring", 1, 1, 8, 4, 8, 50984)),    # Phi-3-mini
    (1, 256, 4, 1, ("any", 1, 1, 4, 8, 0, 6152)),      # HD 256 in f32
    (3, 128, 2, 8, ("ring", 3, 1, 2, 16, 4, 34648)),   # Llama-3.2-3B
    (7, 128, 2, 4, ("ring", 7, 1, 1, 32, 4, 34648)),   # Qwen2-7B
    (16, 64, 2, 1, ("ring", 8, 2, 1, 32, 8, 34456)),   # two chunks of 8
    (11, 64, 2, 1, ("ring", 6, 2, 1, 32, 8, 34456)),   # chunks of 6 and 5
    (1, 100, 2, 2, ("any", 1, 1, 4, 8, 0, 2632)),      # not 16-byte rows
    (1, 250, 2, 1, ("any", 1, 1, 4, 8, 0, 5032)),      # 2 chunks a thread
    (1, 512, 2, 1, ("any", 1, 1, 1, 32, 0, 10504)),    # above 256, bf16:
    (4, 320, 2, 2, ("any", 4, 1, 1, 32, 0, 24096)),    # 64-token splits
    (8, 512, 4, 1, ("any", 8, 1, 1, 32, 0, 38976)),    # above 256, f32
    (1, 1040, 2, 1, ("any", 1, 1, 1, 32, 0, 16904)),   # p . V in 2 passes
])
def test_paged_block_geometry(G, HD, elt, KV, expect):
    """Which paged decode kernel a shape takes and how its block is laid
    out (the wrapper's shared-memory check reads the same numbers)."""
    assert tuple(pa.block_geometry(G, HD, elt, S=16, KV=KV, ps=64,
                                   maxP=32)) == expect
