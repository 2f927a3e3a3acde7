"""Parity of ray_tpu_torch/ops/flash_attention.py (kernel K1 and its plain
version) against ray_tpu/ops/flash_attention.py.

The JAX side runs its Pallas forward in interpret mode on the CPU, as the
JAX package's own tests do. Inputs come from numpy with a fixed seed, in
f32; outputs and LSE agree within 1e-5 (f32 sums in another order; the
online softmax and the plain softmax are the same function). Gradients
of the port's autograd Function agree with ``jax.grad`` through the Pallas
backward (K3/K4, interpret mode) within GRAD_TOL = 1e-4 in f32. The CUDA
kernels are held against the plain versions in the ``cuda``-marked tests,
within the ops module's ``kernel_tolerance`` and ``grad_tolerance``.
"""

import numpy as np
import pytest
import torch

from test_torch_support import jax_reference, require_cuda, to_np

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import train_step as ts

TOL = 1e-5
# gradients: f32 products of 128 keys, both sides' sums in another order
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def jnp():
    """jax.numpy for the parity tests; they skip where JAX is absent, while
    the ``cuda`` tests of this file need no JAX."""
    return pytest.importorskip("jax").numpy


def make_qkv(B, S, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2)])
def test_plain_matches_jax_flash_fwd_loop(causal, H, KV, jnp):
    q, k, v = make_qkv(2, 128, H, KV, 16)
    with jax_reference() as ref:
        jo, jlse = ref.flash_attention._flash_fwd_loop(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=64, block_k=64)
        jo, jlse = np.asarray(jo), np.asarray(jlse)
    out, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(to_np(out), jo, atol=TOL, rtol=0)
    # the TPU kernel broadcasts the LSE over 128 lanes for Mosaic
    np.testing.assert_allclose(to_np(lse), jlse[..., 0], atol=TOL, rtol=0)


def test_flash_attention_matches_jax_public_wrapper(jnp):
    q, k, v = make_qkv(1, 256, 4, 2, 16, seed=1)
    with jax_reference() as ref:
        jo = np.asarray(ref.flash_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=128, block_k=128))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), jo, atol=TOL, rtol=0)


def test_plain_matches_port_attention_xla():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 40, 4, 2, 16, 2))
    out, _ = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out, llama._attention_xla(q, k, v, True),
                               atol=0, rtol=0)


def test_window_raises_not_implemented():
    """A window is implemented now (K2); what still raises is a window
    without causal masking, as in the JAX wrapper."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 16, 2, 2, 16))
    out = fa.flash_attention(q, k, v, causal=True, window=8)
    ref, _ = fa.flash_attention_reference(q, k, v, causal=True, window=8)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v, causal=False, window=8)


def test_grad_raises_not_implemented():
    """Inputs that require grad no longer raise: the gradient is the plain
    backward's on the CPU, and no_grad still runs the forward alone."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 16, 2, 2, 16))
    q.requires_grad_(True)
    out = fa.flash_attention(q, k, v)
    g = torch.ones_like(out)
    out.backward(g)
    o, lse = fa.flash_attention_reference(q.detach(), k, v)
    dq, _, _ = fa.flash_attention_bwd_reference(q.detach(), k, v, o, lse, g)
    torch.testing.assert_close(q.grad, dq, atol=0, rtol=0)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize("window", [32, 48, 200])
def test_plain_window_matches_jax_flash_fwd(window, jnp):
    """K2's JAX path: ``_flash_fwd`` with window > 0 (the band-clamped
    streaming kernel) against the plain version's band mask."""
    q, k, v = make_qkv(2, 128, 4, 2, 16, seed=5)
    with jax_reference() as ref:
        jo, jlse = ref.flash_attention._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=32, block_k=32, window=window)
        jo, jlse = np.asarray(jo), np.asarray(jlse)
    out, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=True, window=window)
    np.testing.assert_allclose(to_np(out), jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(to_np(lse), jlse[..., 0], atol=TOL, rtol=0)


@pytest.mark.parametrize("causal,H,KV,window", [
    (True, 2, 2, None), (False, 2, 2, None), (True, 4, 2, None),
    (True, 4, 2, 40)])
def test_autograd_grads_match_jax_pallas_bwd(causal, H, KV, window, jnp):
    """(dq, dk, dv) of the port's autograd Function against jax.grad of
    JAX's flash_attention, whose custom_vjp runs the Pallas K3/K4 in
    interpret mode (BACKWARD_IMPL = "pallas"). The cotangent is a seeded
    random w, through loss = sum(out * w). f32 within GRAD_TOL."""
    import jax

    q, k, v = make_qkv(1, 128, H, KV, 16, seed=6)
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    with jax_reference() as ref:
        assert ref.flash_attention.BACKWARD_IMPL == "pallas"
        jg = jax.grad(lambda q, k, v: (ref.flash_attention.flash_attention(
            q, k, v, causal=causal, block_q=32, block_k=32, window=window)
            * jnp.asarray(w)).sum(), argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        jg = [np.asarray(x) for x in jg]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for ours, theirs in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(to_np(ours), theirs, atol=GRAD_TOL,
                                   rtol=0)


def _emulated_kernel_bwd(q, k, v, out, lse, g, causal, window=None):
    """The plain backward with P and dS rounded to bf16 before the
    gradient products, as the bf16 kernels round them."""
    B, S, H, D = q.shape
    q5, g5, kf, _, p, ds = fa._bwd_terms(q, k, v, out, lse, g, causal,
                                         window)
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    dv = torch.einsum("bskgt,bskgd->btkd", p, g5)
    dq = torch.einsum("bskgt,btkd->bskgd", ds, kf)
    dk = torch.einsum("bskgt,bskgd->btkd", ds, q5)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def test_grad_tolerance_holds_rounding_not_a_dropped_tile_or_head():
    """The bf16 backward bound takes a kernel's own roundings (P and dS to
    bf16 before the products, outputs to bf16) but not a kernel that skips
    one 64-key tile or reads the wrong kv head of a GQA group."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in make_qkv(1, 256, 4, 2, 64, seed=8))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    out, lse = fa.flash_attention_reference(q, k, v, causal=True)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain)
    emul = _emulated_kernel_bwd(q, k, v, out, lse, g, True)
    for a, b, t in zip(emul, plain, tols):
        assert ((a.float() - b.float()).abs() <= t).all()
    # keys 64-127 dropped from the gradient products
    k_drop = k.clone()
    k_drop[:, 64:128] = 0
    dq_drop = fa.flash_attention_bwd_reference(q, k_drop, v, out, lse, g)[0]
    bad = ((dq_drop.float() - plain[0].float()).abs() > tols[0])
    assert bad[:, 128:].any(-1).float().mean() > 0.9
    # the wrong kv head: each query head's group swapped
    k_swap, v_swap = k.flip(2), v.flip(2)
    dq_s, dk_s, dv_s = fa.flash_attention_bwd_reference(
        q, k_swap, v_swap, out, lse, g)
    for a, b, t in ((dq_s, plain[0], tols[0]), (dv_s, plain[2], tols[2])):
        assert ((a.float() - b.float()).abs() > t).any(-1).float().mean() \
            > 0.9


def test_kernel_tolerance_holds_rounding_not_a_dropped_tile():
    """The bf16 bound takes the plain version's own bf16 rounding (it
    allows two such) but not a kernel that skips one 64-key tile."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in make_qkv(1, 512, 4, 2, 128, seed=4))
    plain, _ = fa.flash_attention_reference(q, k, v, causal=True)
    exact, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                            causal=True)
    tol = fa.kernel_tolerance(q, k, v, plain, causal=True)
    assert ((plain.float() - exact).abs() <= tol / 2).all()
    # keys 64-127 dropped for every query row past them
    k_drop = k.clone()
    k_drop[:, 64:128] = -1e4
    dropped, _ = fa.flash_attention_reference(q, k_drop, v, causal=True)
    assert ((dropped.float() - plain.float()).abs()[:, 128:] > tol[:, 128:]
            ).any(-1).any(-1).float().mean() > 0.9


def _plain_on_card(q, k, v, causal, window=None):
    """The plain version with its bf16 products summed in f32, which
    kernel_tolerance assumes."""
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        return fa.flash_attention_reference(q, k, v, causal=causal,
                                            window=window)
    finally:
        mm.allow_bf16_reduced_precision_reduction = reduced


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,causal", [(128, True), (200, True),
                                      (200, False)])
def test_kernel_matches_plain_on_card(dtype, S, causal):
    require_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in make_qkv(2, S, 8, 4, 128, seed=3))
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, lse_ref = _plain_on_card(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    # elementwise: f32 within 1e-4, bf16 within 2^-7 (A + |plain|), A the
    # attention of |v|; the LSE is f32 from f32 scores in either dtype
    err = (out.float() - ref.float()).abs()
    assert (err <= fa.kernel_tolerance(q, k, v, ref, causal=causal)).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(256, 64), (200, 64), (256, 100)])
def test_window_kernel_matches_plain_on_card(dtype, S, window):
    """K2: the forward kernel under a window, elementwise within
    kernel_tolerance; it counts on its own launch counter."""
    require_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in make_qkv(2, S, 8, 4, 128, seed=10))
    before, before_k1 = fa.launches_window, fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    ref, lse_ref = _plain_on_card(q, k, v, True, window)
    torch.cuda.synchronize()
    assert fa.launches_window == before + 1 and fa.launches == before_k1
    err = (out.float() - ref.float()).abs()
    assert (err <= fa.kernel_tolerance(q, k, v, ref, causal=True,
                                       window=window)).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,D,causal,window", [
    (256, 8, 4, 128, True, None), (200, 8, 4, 128, True, None),
    (200, 4, 4, 64, False, None), (256, 8, 4, 128, True, 96),
    (128, 4, 2, 32, True, None)])
def test_bwd_kernels_match_plain_on_card(dtype, S, H, KV, D, causal, window):
    """K3 and K4 against the plain backward, dq/dk/dv elementwise within
    grad_tolerance (derived in its docstring)."""
    require_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in make_qkv(2, S, H, KV, D, seed=11))
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        q.shape).astype(np.float32)).cuda().to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = (fa.launches_dq, fa.launches_dkdv)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkdv) == (before[0] + 1,
                                                 before[1] + 1)
    for a, b, t in zip(got, plain, tols):
        assert a.dtype == dtype and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all())
        assert ((a.float() - b.float()).abs() <= t).all()
    # no atomics: a second run gives the same bits
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _qkv_on_card(B, S, T, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda().to(torch.bfloat16)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (128, 128, 16, 8, True, None), (130, 130, 16, 8, True, None),
    (200, 200, 16, 8, False, None), (1000, 1000, 16, 8, True, None),
    (256, 512, 16, 8, True, None), (130, 300, 4, 4, False, None),
    (200, 200, 16, 8, True, 64), (1000, 1000, 16, 8, True, 200),
    (128, 128, 4, 4, True, 64), (256, 512, 16, 8, True, 200)])
def test_wgmma_kernel_matches_plain_on_card(D, S, T, H, KV, causal, window):
    """The TMA/wgmma kernel (bf16, head dims 64, 80, 96, 128 and 256)
    against the plain version: out elementwise within kernel_tolerance, the LSE within 1e-4,
    for causal and full attention, GQA, windows, ragged S and T > S."""
    require_cuda()
    q, k, v = _qkv_on_card(2, S, T, H, KV, D, seed=13)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    ref, lse_ref = _plain_on_card(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs()
    assert (err <= fa.kernel_tolerance(q, k, v, ref, causal=causal,
                                       window=window)).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
def test_wgmma_kernel_reads_no_row_past_t_or_outside_the_band(D):
    """NaN where the kernel must not read: (a) memory just past the last
    batch's T rows (TMA zero-fills the ragged tile inside its batch); (b)
    K/V tiles above the last query tile's diagonal (T > S, causal); (c)
    the first K/V tile under window 64, which no query tile from row 256 on
    may load. The outputs those rows feed stay finite and within
    kernel_tolerance of the plain version on clean inputs."""
    require_cuda()

    def check(out, ref, tol, rows=slice(None)):
        assert bool(torch.isfinite(out[:, rows].float()).all())
        assert ((out.float() - ref.float()).abs()[:, rows]
                <= tol[:, rows]).all()

    # (a) k and v are the front of NaN buffers, S = T = 200
    q, k, v = _qkv_on_card(2, 200, 200, 16, 8, D, seed=14)
    kn, vn = (torch.full((x.numel() + 4096,), float("nan"), device="cuda",
                         dtype=x.dtype) for x in (k, v))
    kp = kn[:k.numel()].view(k.shape).copy_(k)
    vp = vn[:v.numel()].view(v.shape).copy_(v)
    for causal in (True, False):
        out, _ = fa.flash_attention_fwd(q, kp, vp, causal=causal)
        ref, _ = _plain_on_card(q, k, v, causal)
        check(out, ref, fa.kernel_tolerance(q, k, v, ref, causal=causal))
    # (b) S = 300, T = 1000: rows from 384 on lie above every diagonal tile
    q, k, v = _qkv_on_card(2, 300, 1000, 16, 8, D, seed=15)
    ref, _ = _plain_on_card(q, k, v, True)
    k[:, 384:], v[:, 384:] = float("nan"), float("nan")
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    check(out, ref, fa.kernel_tolerance(q, k[:, :384], v[:, :384], ref,
                                        causal=True))
    # (c) S = T = 1000, window 64: keys 0-127 poisoned; rows >= 256 never
    # see them, and their query tiles start past key 127 (at the second
    # 128-key tile, or the fourth 64-key one at head dim 256)
    q, k, v = _qkv_on_card(2, 1000, 1000, 16, 8, D, seed=16)
    ref, _ = _plain_on_card(q, k, v, True, 64)
    tol = fa.kernel_tolerance(q, k, v, ref, causal=True, window=64)
    k[:, :128], v[:, :128] = float("nan"), float("nan")
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    check(out, ref, tol, rows=slice(256, None))


def _first_kernel_of_trace():
    """A small kernel of no interest, launched and finished first inside a
    profiler trace: the kernels whose names a test reads come after it."""
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 256, 80])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (1024, 1024, 8, 1, True, None), (200, 200, 7, 1, True, None),
    (256, 512, 8, 2, True, None), (200, 200, 4, 4, True, None),
    (256, 256, 8, 1, True, 96), (200, 200, 8, 1, False, None)])
def test_wgmma_fwd_kernel_runs_at_head_dims_96_and_256_on_card(
        D, S, T, H, KV, causal, window):
    """bf16 K1/K2 at head dims 96, 256 and 80 (five 16-column boxes with
    the 32-byte swizzle) run the TMA/wgmma kernel and nothing else, by the
    kernel names the profiler records; out lies within kernel_tolerance of
    the plain version, the LSE within 1e-4, and both are bit-identical on
    a second run. The cases: G 8 with one kv head (Gemma-2B's heads, 8
    query tiles of 128 rows a head), G 7, T 512 > S 256, ragged S 200 with
    H = KV, window 96 and non-causal."""
    require_cuda()
    q, k, v = _qkv_on_card(2, S, T, H, KV, D, seed=43)
    # every forward kernel any trace holds must be the TMA/wgmma one
    names = _fwd_held(q, k, v, causal, window, "flash_fwd_wgmma_kernel")
    assert all("flash_fwd_wgmma_kernel" in n for n in names), names


def _fwd_held(q, k, v, causal, window, symbol):
    """flash_attention_fwd twice against the plain version: out in bf16,
    finite and within kernel_tolerance, the LSE within 1e-4, the second
    run bit-identical to the first; then the forward kernels' names from
    the profiler (``_fwd_kernel_names``), of which one must be `symbol`'s.
    Returns the names."""

    def run():
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window)

    out, lse = run()
    again = run()
    ref, lse_ref = _plain_on_card(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    over = float(((out.float() - ref.float()).abs() / fa.kernel_tolerance(
        q, k, v, ref, causal=causal, window=window)).max())
    assert over <= 1.0, over
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    names = _fwd_kernel_names(run, symbol)
    assert any(symbol in n for n in names), names
    return names


def _fwd_kernel_names(run, symbol):
    """The names of the flash forward kernels `run` launches, from the
    profiler. CUPTI now and then drops a kernel from a trace, the first one
    most often, so each trace starts with a kernel of its own and a trace
    without `symbol` is taken again (up to 5 times); the names of every
    trace taken."""
    from torch.profiler import ProfilerActivity, profile

    names: set = set()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _first_kernel_of_trace()
            run()
            torch.cuda.synchronize()
        traced = {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "flash_fwd_" in e.name}
        names |= traced
        if any(symbol in n for n in traced):
            break
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (200, 200, 4, 4, True, None), (200, 200, 8, 4, False, None),
    (256, 512, 6, 2, True, None), (256, 512, 7, 1, False, None),
    (1000, 1000, 4, 2, True, 200), (1024, 1024, 4, 2, True, None),
    (1024, 1024, 6, 2, True, 96), (1000, 1000, 7, 1, True, None),
    (200, 200, 6, 2, True, 64), (130, 300, 6, 3, True, 40)])
def test_small_head_fwd_kernel_matches_plain_on_card(D, S, T, H, KV,
                                                     causal, window):
    """bf16 K1/K2 at head dims 16 and 32 run the small-head forward kernel
    and nothing else, by the names the profiler records; out lies within
    kernel_tolerance of the plain version, the LSE within 1e-4, and both
    are bit-identical on a second run. The cases: causal, full and
    windowed; G 1, 2, 3 and 7; ragged S = T = 200, S 1000, T 512 > S 256,
    and S 130 against T 300 under window 40."""
    require_cuda()
    q, k, v = _qkv_on_card(2, S, T, H, KV, D, seed=61)
    counter = "launches_window" if window else "launches"
    before = getattr(fa, counter)
    names = _fwd_held(q, k, v, causal, window, "flash_fwd_small_kernel")
    assert getattr(fa, counter) > before
    assert all("flash_fwd_small_kernel" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
def test_small_head_fwd_kernel_reads_no_row_past_t_or_outside_the_band(D):
    """NaN where the small-head forward must not read: (a) memory just
    past the last batch's T rows of k and v (TMA zero-fills the ragged
    chunk inside its batch); (b) keys from 384 on at S 300, T 1000 (above
    the last 64-row query tile's diagonal chunk); (c) keys 0-127 under
    window 64, which no query tile from row 192 on may load (its band
    starts at the chunk of key 128). The outputs those rows feed stay
    finite and within kernel_tolerance of the plain version on clean
    inputs."""
    require_cuda()

    def check(out, ref, tol, rows=slice(None)):
        assert bool(torch.isfinite(out[:, rows].float()).all())
        assert ((out.float() - ref.float()).abs()[:, rows]
                <= tol[:, rows]).all()

    # (a) k and v are the front of NaN buffers, S = T = 200
    q, k, v = _qkv_on_card(2, 200, 200, 6, 2, D, seed=63)
    kn, vn = (torch.full((x.numel() + 4096,), float("nan"), device="cuda",
                         dtype=x.dtype) for x in (k, v))
    kp = kn[:k.numel()].view(k.shape).copy_(k)
    vp = vn[:v.numel()].view(v.shape).copy_(v)
    for causal in (True, False):
        out, _ = fa.flash_attention_fwd(q, kp, vp, causal=causal)
        ref, _ = _plain_on_card(q, k, v, causal)
        check(out, ref, fa.kernel_tolerance(q, k, v, ref, causal=causal))
    # (b) S = 300, T = 1000: the query tile of rows 256-319 walks keys
    # 0-383
    q, k, v = _qkv_on_card(2, 300, 1000, 6, 2, D, seed=65)
    ref, _ = _plain_on_card(q, k, v, True)
    k[:, 384:], v[:, 384:] = float("nan"), float("nan")
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    check(out, ref, fa.kernel_tolerance(q, k[:, :384], v[:, :384], ref,
                                        causal=True))
    # (c) S = T = 1000, window 64: keys 0-127 poisoned
    q, k, v = _qkv_on_card(2, 1000, 1000, 6, 2, D, seed=67)
    ref, _ = _plain_on_card(q, k, v, True, 64)
    tol = fa.kernel_tolerance(q, k, v, ref, causal=True, window=64)
    k[:, :128], v[:, :128] = float("nan"), float("nan")
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    check(out, ref, tol, rows=slice(192, None))


def _dq_case_on_card(S, T, H, KV, D, causal, window, seed):
    """(q, k, v, out, lse, dO) in bf16 on the card, out and lse from the
    forward kernel."""
    q, k, v = _qkv_on_card(2, S, T, H, KV, D, seed=seed)
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).cuda().to(torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    return q, k, v, out, lse, g


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (128, 128, 16, 8, True, None), (130, 130, 16, 8, True, None),
    (200, 200, 16, 8, True, None), (200, 200, 16, 8, False, None),
    (1000, 1000, 16, 8, True, None), (1000, 1000, 4, 4, False, None),
    (200, 200, 4, 4, True, None), (200, 200, 16, 8, True, 64),
    (1000, 1000, 16, 8, True, 200), (128, 128, 4, 4, True, 64),
    (256, 512, 16, 8, True, None)])
def test_wgmma_dq_kernel_matches_plain_on_card(D, S, T, H, KV, causal,
                                               window):
    """K3's TMA/wgmma kernel (bf16, head dims 64, 80, 96, 128 and 256): dq
    elementwise within grad_tolerance of the plain backward, delta =
    rowsum(out * dO) within its f32 rounding (D-long sums in another order:
    D 2^-23 rowsum |out dO|; a row summed over fewer columns than D fails
    it), and both bit-identical on a second run (no atomics), for causal
    and full attention, GQA and H = KV, windows, ragged 128-row tiles and
    T > S."""
    require_cuda()
    q, k, v, out, lse, g = _dq_case_on_card(S, T, H, KV, D, causal, window,
                                            seed=17)
    before = fa.launches_dq
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                          causal=causal, window=window)
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                            causal=causal, window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tol = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                            window=window)[0]
    torch.cuda.synchronize()
    assert fa.launches_dq == before + 2
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert bool(torch.isfinite(dq.float()).all())
    assert ((dq.float() - plain[0].float()).abs() <= tol).all()
    og = out.float() * g.float()
    delta_ref = og.sum(-1).transpose(1, 2)
    delta_tol = D * 2.0 ** -23 * og.abs().sum(-1).transpose(1, 2) + 1e-7
    assert ((delta - delta_ref).abs() <= delta_tol).all()
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
def test_wgmma_dq_kernel_reads_no_row_past_t_or_outside_the_band(D):
    """NaN where K3 must not read: (a) memory just past the last batch's T
    rows of k and v (TMA zero-fills the ragged tile inside its batch); (b)
    K/V tiles above the last query tile's diagonal (T > S, causal); (c)
    keys 0-127 under window 64, which no query tile from row 256 on may
    load. dq stays finite and within grad_tolerance of the plain backward
    on clean inputs, in the rows those tiles feed."""
    require_cuda()

    def check(q, k, v, out, lse, g, kp, vp, causal, window=None,
              rows=slice(None)):
        plain = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal=causal, window=window)
        tol = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                                window=window)[0]
        dq, _ = fa.flash_attention_bwd_dq(q, kp, vp, out, lse, g,
                                          causal=causal, window=window)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(dq[:, rows].float()).all())
        assert ((dq.float() - plain[0].float()).abs()[:, rows]
                <= tol[:, rows]).all()

    # (a) k and v are the front of NaN buffers, S = T = 200
    for causal in (True, False):
        q, k, v, out, lse, g = _dq_case_on_card(200, 200, 16, 8, D, causal,
                                                None, seed=19)
        kn, vn = (torch.full((x.numel() + 4096,), float("nan"),
                             device="cuda", dtype=x.dtype) for x in (k, v))
        kp = kn[:k.numel()].view(k.shape).copy_(k)
        vp = vn[:v.numel()].view(v.shape).copy_(v)
        check(q, k, v, out, lse, g, kp, vp, causal)
    # (b) S = 300, T = 1000: keys from 384 on lie above every diagonal tile
    q, k, v, out, lse, g = _dq_case_on_card(300, 1000, 16, 8, D, True, None,
                                            seed=21)
    kp, vp = k.clone(), v.clone()
    kp[:, 384:], vp[:, 384:] = float("nan"), float("nan")
    check(q, k, v, out, lse, g, kp, vp, True)
    # (c) S = T = 1000, window 64: keys 0-127 poisoned; rows >= 256 never
    # see them, and their query tiles start at key 192
    q, k, v, out, lse, g = _dq_case_on_card(1000, 1000, 16, 8, D, True, 64,
                                            seed=23)
    kp, vp = k.clone(), v.clone()
    kp[:, :128], vp[:, :128] = float("nan"), float("nan")
    check(q, k, v, out, lse, g, kp, vp, True, 64, rows=slice(256, None))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (128, 128, 16, 8, True, None), (130, 130, 16, 8, True, None),
    (200, 200, 16, 8, True, None), (200, 200, 16, 8, False, None),
    (1000, 1000, 16, 8, True, None), (1000, 1000, 4, 4, False, None),
    (200, 200, 4, 4, True, None), (200, 200, 16, 8, True, 64),
    (1000, 1000, 16, 8, True, 200), (128, 128, 4, 4, True, 64),
    (256, 512, 16, 8, True, None)])
def test_wgmma_dkdv_kernel_matches_plain_on_card(D, S, T, H, KV, causal,
                                                 window):
    """K4's TMA/wgmma kernel (bf16, head dims 64, 80, 96, 128 and 256), fed
    K3's delta: dk and dv elementwise within grad_tolerance of the plain
    backward and bit-identical on a second run (no atomics), for causal and
    full attention, GQA and H = KV, windows, ragged key blocks (128 keys,
    64 at head dim 256, where G 2 also splits the query heads over a
    cluster) and 64-row query tiles, and T > S."""
    require_cuda()
    q, k, v, out, lse, g = _dq_case_on_card(S, T, H, KV, D, causal, window,
                                            seed=29)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, causal=causal,
                                         window=window)
    before = fa.launches_dkdv
    got = fa.flash_attention_bwd_dkdv(q, k, v, lse, g, delta, causal=causal,
                                      window=window)
    again = fa.flash_attention_bwd_dkdv(q, k, v, lse, g, delta,
                                        causal=causal, window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    assert fa.launches_dkdv == before + 2
    for a, b, t in zip(got, plain[1:], tols[1:]):
        assert a.dtype == torch.bfloat16 and a.shape == k.shape
        assert bool(torch.isfinite(a.float()).all())
        assert ((a.float() - b.float()).abs() <= t).all()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
def test_wgmma_dkdv_kernel_reads_no_row_past_s_or_outside_the_band(D):
    """NaN where K4 must not read: (a) memory just past the last batch's S
    rows of q and dO, and of lse and delta (TMA zero-fills the ragged
    query tile inside its batch; the column loads stop at S); (b) query
    rows 0-127 under causal attention, which no key block (128 keys, 64 at
    head dim 256) from key 128 on may load (its band starts at its
    diagonal tile); (c) query rows from 192 on under window 64, which the
    blocks of keys 0-127 may not load (their last key's band ends at row
    190). dk and dv stay finite and
    within grad_tolerance of the plain backward on clean inputs, in the
    key rows those blocks own."""
    require_cuda()

    def nan_front(x, extra=4096):
        buf = torch.full((x.numel() + extra,), float("nan"), device="cuda",
                         dtype=x.dtype)
        return buf[:x.numel()].view(x.shape).copy_(x)

    def check(q, k, v, out, lse, g, qp, gp, lp, dp, causal, window=None,
              rows=slice(None)):
        _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                             causal=causal, window=window)
        plain = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal=causal, window=window)
        tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                                 window=window)
        dpp = delta if dp is None else dp(delta)
        got = fa.flash_attention_bwd_dkdv(qp, k, v, lp, gp, dpp,
                                          causal=causal, window=window)
        torch.cuda.synchronize()
        for a, b, t in zip(got, plain[1:], tols[1:]):
            assert bool(torch.isfinite(a[:, rows].float()).all())
            assert ((a.float() - b.float()).abs()[:, rows]
                    <= t[:, rows]).all()

    # (a) q, dO, lse and delta are the front of NaN buffers, S = T = 200
    for causal in (True, False):
        q, k, v, out, lse, g = _dq_case_on_card(200, 200, 16, 8, D, causal,
                                                None, seed=31)
        check(q, k, v, out, lse, g, nan_front(q), nan_front(g),
              nan_front(lse), nan_front, causal)
    # (b) S = T = 1000, causal: query rows 0-127 poisoned
    q, k, v, out, lse, g = _dq_case_on_card(1000, 1000, 16, 8, D, True,
                                            None, seed=33)
    qp, gp = q.clone(), g.clone()
    qp[:, :128], gp[:, :128] = float("nan"), float("nan")
    check(q, k, v, out, lse, g, qp, gp, lse, None, True,
          rows=slice(128, None))
    # (c) S = T = 1000, window 64: query rows from 192 on poisoned
    q, k, v, out, lse, g = _dq_case_on_card(1000, 1000, 16, 8, D, True, 64,
                                            seed=35)
    qp, gp = q.clone(), g.clone()
    qp[:, 192:], gp[:, 192:] = float("nan"), float("nan")
    check(q, k, v, out, lse, g, qp, gp, lse, None, True, 64,
          rows=slice(0, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 96, 256, 80])
def test_wgmma_dkdv_kernel_gives_zero_grads_without_queries(D):
    """S = 0 (no query sees any key): K4 writes dk = dv = 0 for every key,
    as the plain backward gives, and counts its launch."""
    require_cuda()
    _, k, v = _qkv_on_card(2, 1, 200, 16, 8, D, seed=37)
    q = torch.empty((2, 0, 16, D), device="cuda", dtype=torch.bfloat16)
    lse = torch.empty((2, 16, 0), device="cuda")
    delta = torch.empty((2, 16, 0), device="cuda")
    before = fa.launches_dkdv
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, lse, q, delta)
    torch.cuda.synchronize()
    assert fa.launches_dkdv == before + 1
    assert dk.shape == k.shape and dv.shape == v.shape
    assert not dk.any() and not dv.any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (200, 200, 8, 1, True, None), (200, 200, 7, 1, True, None),
    (300, 500, 8, 2, True, None), (256, 256, 8, 1, True, 96),
    (200, 200, 8, 1, False, None)])
def test_wgmma_bwd_kernels_run_at_head_dims_96_and_256_on_card(
        D, S, T, H, KV, causal, window):
    """bf16 K3 and K4 at head dims 96 and 256 run the TMA/wgmma kernels and
    nothing else, by the kernel names the profiler records; dq, dk and dv
    lie within grad_tolerance of the plain backward and are bit-identical
    on a second run. The cases: G 8 with one kv head (at head dim 256 its
    B KV T / 64 = 8 key blocks are short of two waves, so K4 splits the
    query heads over a cluster of 4 blocks), G 7 (uneven slices of 1-2
    heads), ragged S != T, window 96 and non-causal."""
    require_cuda()
    q, k, v, out, lse, g = _dq_case_on_card(S, T, H, KV, D, causal, window,
                                            seed=41)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    for name, a, b, t in zip(("dq", "dk", "dv"), got, plain, tols):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all()), name
        over = float(((a.float() - b.float()).abs() / t).max())
        assert over <= 1.0, (name, over)
    assert [torch.equal(a, b) for a, b in zip(got, again)] == [True] * 3
    # every name any trace holds must be a TMA/wgmma kernel's
    names = _bwd_kernel_names(q, k, v, out, lse, g, causal, window,
                              ("flash_bwd_dq_wgmma_kernel",
                               "flash_bwd_dkdv_wgmma_kernel"))
    assert any("flash_bwd_dq_wgmma_kernel" in n for n in names), names
    assert any("flash_bwd_dkdv_wgmma_kernel" in n for n in names), names
    assert all("_wgmma_kernel" in n for n in names), names


def _bwd_kernel_names(q, k, v, out, lse, g, causal, window, symbols):
    """The names of the flash backward kernels one flash_attention_bwd
    call launches, from the profiler. CUPTI now and then drops a kernel
    from a trace, the first one most often, so each trace starts with a
    kernel of its own and a trace missing one of `symbols` (K3's, K4's) is
    taken again (up to 5 times); the names of every trace taken."""
    from torch.profiler import ProfilerActivity, profile

    names: set = set()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _first_kernel_of_trace()
            fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window)
            torch.cuda.synchronize()
        traced = {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "flash_bwd_" in e.name}
        names |= traced
        if all(any(s in n for n in traced) for s in symbols):
            break
    return names


def _bwd_held(q, k, v, out, lse, g, causal, window, rows=slice(None)):
    """flash_attention_bwd twice and the plain backward: each of (dq, dk,
    dv) finite and within grad_tolerance in `rows` (of dq's S and dk/dv's
    T), and the second run bit-identical to the first. Returns the first
    run's gradients."""
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    for name, a, b, t in zip(("dq", "dk", "dv"), got, plain, tols):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert bool(torch.isfinite(a[:, rows].float()).all()), name
        over = float(((a.float() - b.float()).abs() / t)[:, rows].max())
        assert over <= 1.0, (name, over)
    assert [torch.equal(a, b) for a, b in zip(got, again)] == [True] * 3
    return got


SMALL_SYMBOLS = ("flash_bwd_dq_small_kernel", "flash_bwd_dkdv_small_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("S,T,H,KV,causal,window", [
    (200, 200, 4, 4, True, None), (200, 200, 8, 4, False, None),
    (256, 512, 6, 2, True, None), (256, 512, 7, 1, False, None),
    (1000, 1000, 4, 2, True, 200), (1024, 1024, 4, 2, True, None),
    (1024, 1024, 6, 2, True, 96), (1000, 1000, 7, 1, True, None),
    (200, 200, 6, 2, True, 64)])
def test_small_head_bwd_kernels_match_plain_on_card(D, S, T, H, KV, causal,
                                                    window):
    """bf16 K3 and K4 at head dims 16 and 32 run the small-head kernels
    and nothing else, by the names the profiler records; dq, dk and dv
    lie within grad_tolerance of the plain backward and are bit-identical
    on a second run; delta = rowsum(out * dO) within its f32 rounding. The
    cases: causal, full and windowed; G 1, 2, 3 and 7; ragged S = T = 200,
    S 256 with T 512, and S 1000 and 1024."""
    require_cuda()
    q, k, v, out, lse, g = _dq_case_on_card(S, T, H, KV, D, causal, window,
                                            seed=43)
    before = (fa.launches_dq, fa.launches_dkdv)
    _bwd_held(q, k, v, out, lse, g, causal, window)
    assert (fa.launches_dq, fa.launches_dkdv) == (before[0] + 2,
                                                 before[1] + 2)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                         causal=causal, window=window)
    og = out.float() * g.float()
    delta_ref = og.sum(-1).transpose(1, 2)
    delta_tol = D * 2.0 ** -23 * og.abs().sum(-1).transpose(1, 2) + 1e-7
    assert ((delta - delta_ref).abs() <= delta_tol).all()
    names = _bwd_kernel_names(q, k, v, out, lse, g, causal, window,
                              SMALL_SYMBOLS)
    for sym in SMALL_SYMBOLS:
        assert any(sym in n for n in names), names
    assert all("_small_kernel" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("B,S,T,H,KV,causal,sizes", [
    (2, 200, 200, 4, 4, True, (1, 1)), (1, 128, 2048, 2, 2, False, (8, 1)),
    (2, 200, 200, 8, 4, False, (1, 2)), (2, 256, 512, 7, 1, False, (2, 4)),
    (1, 1024, 1024, 2, 2, False, (4, 4)), (1, 1024, 1024, 2, 1, True,
                                           (4, 8))])
def test_small_head_bwd_kernels_take_every_cluster_size_on_card(
        D, B, S, T, H, KV, causal, sizes):
    """The launch rule picks each cluster size it can (1, 2, 4 and 8
    blocks, for K3 and for K4) at one of these shapes, on an H100's 132
    SMs; at each, the cluster's sums (added in rank order through
    distributed shared memory) give dq, dk and dv within grad_tolerance
    of the plain backward, bit-identical on a second run."""
    require_cuda()
    assert torch.cuda.get_device_properties(0).multi_processor_count == 132
    assert fa.bwd_cluster_sizes(B, S, T, H, KV, causal=causal) == sizes
    q, k, v = _qkv_on_card(B, S, T, H, KV, D, seed=47)
    g = torch.from_numpy(np.random.default_rng(48).standard_normal(
        q.shape).astype(np.float32)).cuda().to(torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    _bwd_held(q, k, v, out, lse, g, causal, None)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
def test_small_head_bwd_kernels_give_zero_grads_for_unseen_keys(D):
    """Keys no query sees get dk = dv = 0 exactly: under causal attention
    with T 512 > S 256 every key from 256 on, under window 64 too; and
    with S = 0 every key (K4 writes zeros and counts its launch)."""
    require_cuda()
    for window in (None, 64):
        q, k, v, out, lse, g = _dq_case_on_card(256, 512, 6, 2, D, True,
                                                window, seed=51)
        _, dk, dv = _bwd_held(q, k, v, out, lse, g, True, window)
        assert not dk[:, 256:].any() and not dv[:, 256:].any()
        assert dk[:, :256].any() and dv[:, :256].any()
    _, k, v = _qkv_on_card(2, 1, 200, 6, 2, D, seed=53)
    q = torch.empty((2, 0, 6, D), device="cuda", dtype=torch.bfloat16)
    empty = torch.empty((2, 6, 0), device="cuda")
    before = fa.launches_dkdv
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, empty, q, empty)
    torch.cuda.synchronize()
    assert fa.launches_dkdv == before + 1
    assert not dk.any() and not dv.any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
def test_small_head_bwd_kernels_read_no_row_past_s_or_t_or_the_band(D):
    """NaN where the small-head K3 and K4 must not read. K3: (a) memory
    just past the last batch's T rows of k and v (TMA zero-fills the
    ragged chunk inside its batch); (b) keys from 384 on at S 300, T 1000
    (above the last query tile's diagonal chunk); (c) keys 0-127 under
    window 64, which no query tile from row 256 on may load. K4: (a)
    memory just past q, dO, lse and delta (S 200); (b) query rows 0-127
    under causal attention, which no key block from key 128 on may load;
    (c) query rows from 192 on under window 64, which the block of keys
    0-63 may not load. The gradients those loads would feed stay finite
    and within grad_tolerance of the plain backward on clean inputs."""
    require_cuda()

    def nan_front(x, extra=4096):
        buf = torch.full((x.numel() + extra,), float("nan"), device="cuda",
                         dtype=x.dtype)
        return buf[:x.numel()].view(x.shape).copy_(x)

    def held(got, want, tol, rows):
        assert bool(torch.isfinite(got[:, rows].float()).all())
        assert ((got.float() - want.float()).abs()[:, rows]
                <= tol[:, rows]).all()

    def check(S, T, window, seed, poison, dq_rows, dkdv_rows,
              causal=True):
        q, k, v, out, lse, g = _dq_case_on_card(S, T, 6, 2, D, causal,
                                                window, seed=seed)
        plain = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal=causal, window=window)
        tols = fa.grad_tolerance(q, k, v, out, lse, g, plain,
                                 causal=causal, window=window)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                             causal=causal, window=window)
        qp, kp, vp, gp, lp, dp = poison(q, k, v, g, lse, delta)
        if dq_rows is not None:
            dq, _ = fa.flash_attention_bwd_dq(q, kp, vp, out, lse, g,
                                              causal=causal, window=window)
            held(dq, plain[0], tols[0], dq_rows)
        if dkdv_rows is not None:
            dk, dv = fa.flash_attention_bwd_dkdv(qp, k, v, lp, gp, dp,
                                                 causal=causal,
                                                 window=window)
            held(dk, plain[1], tols[1], dkdv_rows)
            held(dv, plain[2], tols[2], dkdv_rows)
        torch.cuda.synchronize()

    def rows_nan(x, rows):
        x = x.clone()
        x[:, rows] = float("nan")
        return x

    everything = slice(None)
    for causal in (True, False):  # (a), both kernels
        check(200, 200, None, 55, lambda q, k, v, g, lse, d: (
            nan_front(q), nan_front(k), nan_front(v), nan_front(g),
            nan_front(lse), nan_front(d)), everything, everything, causal)
    # K3 (b) and (c)
    check(300, 1000, None, 57, lambda q, k, v, g, lse, d: (
        q, rows_nan(k, slice(384, None)), rows_nan(v, slice(384, None)), g,
        lse, d), everything, None)
    check(1000, 1000, 64, 59, lambda q, k, v, g, lse, d: (
        q, rows_nan(k, slice(0, 128)), rows_nan(v, slice(0, 128)), g, lse,
        d), slice(256, None), None)
    # K4 (b) and (c)
    check(1000, 1000, None, 61, lambda q, k, v, g, lse, d: (
        rows_nan(q, slice(0, 128)), k, v, rows_nan(g, slice(0, 128)), lse,
        d), None, slice(128, None))
    check(1000, 1000, 64, 63, lambda q, k, v, g, lse, d: (
        rows_nan(q, slice(192, None)), k, v, rows_nan(g, slice(192, None)),
        lse, d), None, slice(0, 64))


def _refuse_plain(monkeypatch):
    """Make the plain versions raise while a kernel wrapper runs: a CUDA
    tensor must launch the kernel, never fall back."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA launch ran the plain version")

    for name in ("flash_attention_reference", "flash_attention_bwd_reference"):
        monkeypatch.setattr(fa, name, refuse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 48, 80, 96, 256])
@pytest.mark.parametrize("S,H,KV,causal,window", [
    (200, 6, 2, True, None), (200, 7, 1, False, None),
    (256, 16, 1, True, 96)])
def test_head_dim_kernels_match_plain_on_card(dtype, D, S, H, KV, causal,
                                              window, monkeypatch):
    """K1/K2 and K3/K4 at the head dims outside the presets (16 in the
    backward; 80, 96 and 256 compiled; 48 zero-padded to 64) and groups 3,
    7 and 16, ragged S, causal, full and windowed: the launch counters
    move, the plain versions are not called, and out, the LSE and
    (dq, dk, dv) are held against the plain versions elementwise within
    kernel_tolerance / grad_tolerance."""
    require_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in make_qkv(2, S, H, KV, D, seed=13))
    g = torch.from_numpy(np.random.default_rng(14).standard_normal(
        q.shape).astype(np.float32)).cuda().to(dtype)
    counters = ("launches", "launches_window", "launches_dq",
                "launches_dkdv")
    before = [getattr(fa, c) for c in counters]
    with monkeypatch.context() as m:
        _refuse_plain(m)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    after = [getattr(fa, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [
        0 if window else 1, 1 if window else 0, 1, 1]
    ref, lse_ref = _plain_on_card(q, k, v, causal, window)
    assert out.shape == q.shape and out.dtype == dtype
    assert ((out.float() - ref.float()).abs() <= fa.kernel_tolerance(
        q, k, v, ref, causal=causal, window=window)).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    for a, b, t in zip(got, plain, tols):
        assert a.dtype == dtype and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all())
        assert ((a.float() - b.float()).abs() <= t).all()


WIDE_SYMBOLS = ("flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
                "flash_bwd_dkdv_wide_kernel")
WIDE_COUNTERS = ("launches_wide", "launches_wide_window", "launches_dq_wide",
                 "launches_dkdv_wide")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [264, 300, 320, 512, 1024])
@pytest.mark.parametrize("S,H,KV,causal,window", [
    (200, 4, 4, True, None), (256, 8, 2, True, 96),
    (200, 4, 1, False, None)])
def test_wide_kernels_match_plain_on_card(dtype, D, S, H, KV, causal, window,
                                          monkeypatch):
    """K1/K2 and K3/K4 above head dim 256 run the wide kernels, in both
    dtypes: D 264 (a ragged last column chunk), 300 (zero-padded to 304),
    320, 512 and 1024, G 1 and 4, causal, windowed and full, ragged S. The
    wide launch counters move and no other, the plain versions are not
    called, the profiler names only the wide kernels, out, the LSE and
    (dq, dk, dv) lie within kernel_tolerance / grad_tolerance of the plain
    versions, and a second run is bit-identical."""
    require_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in make_qkv(2, S, H, KV, D, seed=15))
    g = torch.from_numpy(np.random.default_rng(16).standard_normal(
        q.shape).astype(np.float32)).cuda().to(dtype)
    counters = ("launches", "launches_window", "launches_dq",
                "launches_dkdv") + WIDE_COUNTERS
    before = [getattr(fa, c) for c in counters]

    def run():
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
        return (out, lse) + fa.flash_attention_bwd(
            q, k, v, out, lse, g, causal=causal, window=window)

    with monkeypatch.context() as m:
        _refuse_plain(m)
        got = run()
        again = run()
    torch.cuda.synchronize()
    after = [getattr(fa, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [
        0, 0, 0, 0, 0 if window else 2, 2 if window else 0, 2, 2]
    assert [torch.equal(a, b) for a, b in zip(got, again)] == [True] * 5
    out, lse, *grads = got
    ref, lse_ref = _plain_on_card(q, k, v, causal, window)
    assert out.shape == q.shape and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    assert ((out.float() - ref.float()).abs() <= fa.kernel_tolerance(
        q, k, v, ref, causal=causal, window=window)).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    for name, a, b, t in zip(("dq", "dk", "dv"), grads, plain, tols):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        over = float(((a.float() - b.float()).abs() / t).max())
        assert over <= 1.0, (name, over)
    names = _fwd_kernel_names(
        lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                       window=window), WIDE_SYMBOLS[0])
    assert names and all(WIDE_SYMBOLS[0] in n for n in names), names
    names = _bwd_kernel_names(q, k, v, out, lse, g, causal, window,
                              WIDE_SYMBOLS[1:])
    assert names and all(any(s in n for s in WIDE_SYMBOLS[1:])
                         for n in names), names


@pytest.mark.parametrize("name", ["phi3-mini", "llama3.2-3b", "gemma-2b",
                                  "danube", "deepseek-v4-flash", "tiny"])
def test_shapes_bf16_grads_hold_their_bound_on_the_plain_path(name):
    """chip_smoke.py's bf16-against-f32 gradient check of the public model
    shapes, rehearsed on the CPU (plain attention) at each model's heads
    with 1 layer, vocab 256 and d_ff 512, and of the tiny Llama preset as
    the shapes phase runs it (2 layers, head dim 16, B 2 S 128): loss_fn's
    gradients in bf16 compute lie within SHAPES_BF16_GRAD_RTOL of the f32
    run's, each leaf against its largest element (1.4-1.5e-2 here at the
    models' heads; 1.8-2.1e-2 on an H100 at full width and 2 layers)."""
    import chip_smoke

    if name == "tiny":
        r = chip_smoke._shapes_tiny_bf16("cpu")
    else:
        cfg = llama.LlamaConfig(**dict(chip_smoke.SHAPE_MODELS[name],
                                       vocab_size=256, d_ff=512,
                                       n_layers=1))
        cfg = cfg.replace(dtype=torch.float32, attn_impl="flash",
                          max_seq_len=256)
        params = llama.init_params(torch.Generator().manual_seed(0), cfg)
        batch = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                                   size=(1, 129))
        p = ts._map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
        llama.loss_fn(p, {"tokens": torch.as_tensor(batch)}, cfg).backward()
        grads_f32 = [t.grad.float() for t in ts._leaves(p)]
        r = chip_smoke._shapes_bf16_grads(cfg, params, batch, "cpu",
                                          grads_f32)
    assert 0 < r["grad_max_rel_err"] <= chip_smoke.SHAPES_BF16_GRAD_RTOL
    assert r["ok"]


def test_chip_smoke_fwd_symbols():
    """The forward kernel chip_smoke.py requires of each dtype and kernel
    head dim: the small-head kernel at 16 and 32, the TMA/wgmma kernel at
    64, 80, 96, 128 and 256 (so no bf16 head dim is left to the deleted
    mma.sync kernel), the exact f32 kernel at every head dim up to 256,
    and the wide kernels above it in both dtypes."""
    import chip_smoke as cs

    assert cs.SMALL_FWD_SYMBOL == "flash_fwd_small_kernel"
    assert cs.WGMMA_FWD_SYMBOL == "flash_fwd_wgmma_kernel"
    for d in fa.KERNEL_HEAD_DIMS:
        want = cs.SMALL_FWD_SYMBOL if d <= 32 else cs.WGMMA_FWD_SYMBOL
        assert cs.fwd_symbol("bfloat16", d) == want
        assert cs.fwd_symbol("float32", d) == "flash_fwd_f32_kernel"
    # every head dim reaches one of them through kernel_head_dim, and
    # above 256 the wide kernels in both dtypes
    assert {cs.fwd_symbol("bfloat16", fa.kernel_head_dim(d))
            for d in range(1, 257)} == {cs.SMALL_FWD_SYMBOL,
                                        cs.WGMMA_FWD_SYMBOL}
    for dt in ("bfloat16", "float32"):
        assert {cs.fwd_symbol(dt, fa.kernel_head_dim(d))
                for d in range(257, 1025)} == {cs.WIDE_FWD_SYMBOL}
        assert cs.bwd_symbols(dt, 512) == (cs.WIDE_DQ_SYMBOL,
                                           cs.WIDE_DKDV_SYMBOL)
    assert {name for name, *_ in cs.FLASH_UNTIMED} >= {"d32-g2", "d80"}


def test_chip_smoke_bounds_count_exponentials():
    """chip_smoke.py counts an exponential a (query, key) pair of the band
    and reports the SFU's time for them (exp_ms: 16 an SM a clock on 132
    SMs at the card's 1.98 GHz maximum) beside the bound, which stays the
    larger of bytes and products: at the tiny presets' heads (B 8, S 1024,
    H 4, KV 2, D 16, causal) exp_ms is ~0.0040 ms, above K3's and K4's
    bounds; at the 1b train shape (D 128) the bounds are the products',
    as before; and the kernel names each dtype and head dim must run."""
    import chip_smoke as cs

    tiny = cs.k3k4_bounds(B=8, S=1024, H=4, KV=2, D=16, dtype="bfloat16")
    exps = 8 * 4 * 1024 * 1025 // 2
    assert cs.band_pairs(1024, 1024, True) * 32 == exps
    assert tiny["exp_ms"] == pytest.approx(
        exps / (132 * 16 * 1.98e9) * 1e3, rel=1e-12)
    assert 0.0040 < tiny["exp_ms"] < 0.0041
    bshd, btkd, bhs = 8 * 1024 * 4 * 16, 8 * 1024 * 2 * 16, 8 * 4 * 1024
    assert tiny == {
        "k3_bound_ms": (2 * (4 * bshd + 2 * btkd) + 8 * bhs) / 3.35e12 * 1e3,
        "k3_bound_by": "bytes",
        "k4_bound_ms": 8 * exps * 16 / 989e12 * 1e3,
        "k4_bound_by": "operations",
        "exp_ms": tiny["exp_ms"]}
    assert max(tiny["k3_bound_ms"], tiny["k4_bound_ms"]) < tiny["exp_ms"]
    one_b = cs.k3k4_bounds(B=8, S=1024, H=16, KV=8, D=128, dtype="bfloat16")
    pairs = cs.band_pairs(1024, 1024, True)
    assert one_b == {
        "k3_bound_ms": 6 * 8 * 16 * pairs * 128 / 989e12 * 1e3,
        "k3_bound_by": "operations",
        "k4_bound_ms": 8 * 8 * 16 * pairs * 128 / 989e12 * 1e3,
        "k4_bound_by": "operations",
        "exp_ms": 8 * 16 * pairs / (132 * 16 * 1.98e9) * 1e3}
    fwd = cs.fwd_bound(B=8, S=1024, T=1024, H=4, KV=2, D=16,
                       dtype="bfloat16")
    assert fwd == {"bound_ms": 4 * exps * 16 / 989e12 * 1e3,
                   "bound_by": "operations", "exp_ms": tiny["exp_ms"]}
    assert cs.fwd_bound(B=8, S=1024, T=1024, H=32, KV=32, D=128,
                        dtype="bfloat16")["bound_by"] == "bytes"
    assert cs.bwd_symbols("bfloat16", 16) == cs.bwd_symbols(
        "bfloat16", 32) == (cs.SMALL_DQ_SYMBOL, cs.SMALL_DKDV_SYMBOL)
    for d in (64, 80, 96, 128, 256):
        assert cs.bwd_symbols("bfloat16", d) == (cs.WGMMA_DQ_SYMBOL,
                                                 cs.WGMMA_DKDV_SYMBOL)
    assert cs.bwd_symbols("float32", 16)[0] == "flash_bwd_dq_f32_kernel"
