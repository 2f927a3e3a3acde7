"""Ring and Ulysses attention (ray_tpu_torch/ops/{ring_attention,ulysses}.py)
and the axis collectives under them (parallel/spmd.py) against the JAX
reference, in one process. The multi-rank cases (sp = 4) are in
tests/test_torch_parallel_sp_pp.py.

- ``_block_attn`` equals JAX's (f32 and bf16 inputs);
- both ops on a 1-rank axis (the whole sequence) equal JAX's
  ``_attention_xla`` on the same inputs, forward and gradients, and the
  reference's own ops on a 1-device mesh;
- ``spmd.ppermute`` and ``spmd.all_to_all`` through their autograd
  Functions on a 1-rank gloo group: values and gradients (gradcheck);
- a sliding window with ring or Ulysses raises JAX's ValueError, and
  Ulysses' divisibility error is JAX's.
"""

import numpy as np
import pytest
import torch

from test_torch_support import jax_reference

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import ring_attention as ring
from ray_tpu_torch.ops import ulysses as uly
from ray_tpu_torch.parallel import spmd

# f32 attention of the same inputs, the sums in another order (online
# softmax over one block here, XLA's einsum there)
TOL = 1e-5
# bf16 inputs: the block's scores and p.v sums are f32 in both, so the two
# differ by f32 rounding of O(1) values
BLOCK_BF16_TOL = 1e-5


def _qkv(B=2, S=64, H=4, KV=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal_chunk", [0, 1, 3])
def test_block_attn_matches_jax(dtype, causal_chunk):
    """One block, q chunk 2 of 4 against kv chunk `causal_chunk`."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    q, k, v = _qkv(S=16, H=4, KV=2)
    Sc = 16
    qg = 2 * Sc + np.arange(Sc)
    kg = causal_chunk * Sc + np.arange(Sc)
    mask = (qg[:, None] >= kg[None, :])[None, :, None, None, :]
    tdt = getattr(torch, dtype)
    q5 = q.reshape(2, Sc, 2, 2, 16)
    with jax_reference() as ref:
        jd = getattr(jnp, dtype)
        want = ref.ring_attention._block_attn(
            jnp.asarray(q5), jnp.asarray(k, jd), jnp.asarray(v, jd),
            jnp.asarray(mask))
    got = ring._block_attn(torch.from_numpy(q5),
                           torch.from_numpy(k).to(tdt),
                           torch.from_numpy(v).to(tdt),
                           torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=BLOCK_BF16_TOL, rtol=0)


@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_one_rank_axis_equals_xla_attention(op):
    """The op on a 1-rank axis is full causal attention: forward and the
    gradients of its sum against JAX's ``_attention_xla`` (and the
    reference op on a 1-device mesh)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    q, k, v = _qkv(B=2, S=64, H=8, KV=4, D=16)
    with jax_reference() as ref:
        from jax.sharding import PartitionSpec as P

        args = [jnp.asarray(a) for a in (q, k, v)]
        want = ref.llama._attention_xla(*args, causal=True)
        gwant = jax.grad(lambda *a: ref.llama._attention_xla(
            *a, causal=True).sum(), argnums=(0, 1, 2))(*args)
        mesh = jax.make_mesh((1,), ("sp",), devices=jax.devices()[:1])
        fn = (ref.ring_attention.ring_attention if op == "ring"
              else ref.ulysses.ulysses_attention)
        mine = jax.shard_map(lambda *a: fn(*a, axis_name="sp"), mesh=mesh,
                             in_specs=(P(None, "sp"),) * 3,
                             out_specs=P(None, "sp"))(*args)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    fn = ring.ring_attention if op == "ring" else uly.ulysses_attention
    out = fn(*ts, axis=spmd.Axis.local())
    grads = torch.autograd.grad(out.sum(), ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(mine),
                               atol=TOL, rtol=0)
    for g, w in zip(grads, gwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def one_rank_group():
    """A 1-rank gloo group (the process's default group, started here when
    none exists and destroyed after)."""
    import torch.distributed as dist

    mine = not dist.is_initialized()
    if mine:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        pytest.skip("needs a 1-rank default group")
    yield spmd.Axis("sp", 1, 0, dist.group.WORLD, (0,))
    if mine:
        dist.destroy_process_group()


def test_ppermute_and_all_to_all_functions_on_one_rank(one_rank_group):
    """The autograd Functions themselves (the size-1 shortcut bypassed):
    ppermute's (0, 0) pair is a local copy, all_to_all a gloo all-to-all
    of one block; both pass gradcheck, and ppermute's backward applies
    the inverse permutation."""
    axis = one_rank_group
    x = torch.randn(2, 4, 6, 3, dtype=torch.float64, requires_grad=True)
    y = spmd._PPermute.apply(x, [(0, 0)], axis)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.autograd.gradcheck(
        lambda t: spmd._PPermute.apply(t, [(0, 0)], axis), (x,))
    z = spmd._AllToAll.apply(x, 2, 1, axis)
    assert torch.equal(z, x)
    assert torch.autograd.gradcheck(
        lambda t: spmd._AllToAll.apply(t, 2, 1, axis), (x,))
    # the public entry points on a size-1 axis: a copy, or zeros for a
    # rank that receives nothing (JAX's ppermute semantics)
    local = spmd.Axis.local()
    assert torch.equal(spmd.ppermute(x, [(0, 0)], local), x)
    assert torch.equal(spmd.ppermute(x, [], local), torch.zeros_like(x))
    assert spmd.all_to_all(x, 2, 1, local) is x
    with pytest.raises(ValueError, match="does not split into 4 blocks"):
        spmd.all_to_all(x, 2, 1, spmd.Axis("sp", 4, 0))
    with pytest.raises(ValueError, match="not a permutation"):
        spmd._exchange(x, [(0, 1), (0, 2)], spmd.Axis("sp", 4, 0))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_window_raises_jax_error(impl):
    """A sliding window with ring/Ulysses raises, with JAX's text."""
    jax = pytest.importorskip("jax")
    q, k, v = _qkv(B=1, S=16, H=4, KV=2, D=16)
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(attn_impl=impl,
                                                 sliding_window=8)
        with pytest.raises(ValueError) as want:
            ref.llama._attention(*(jax.numpy.asarray(a) for a in (q, k, v)),
                                 jcfg)
    cfg = llama.PRESETS["tiny"].replace(attn_impl=impl, sliding_window=8)
    with pytest.raises(ValueError) as got:
        llama._attention(*(torch.from_numpy(a) for a in (q, k, v)), cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("H,KV", [(6, 4), (8, 2)])
def test_ulysses_divisibility_error_is_jax(H, KV):
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P

    q, k, v = _qkv(B=1, S=16, H=H, KV=KV, D=8)
    with jax_reference() as ref:
        mesh = jax.make_mesh((4,), ("sp",), devices=jax.devices()[:4])
        with pytest.raises(ValueError) as want:
            jax.shard_map(
                lambda *a: ref.ulysses.ulysses_attention(*a),
                mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                out_specs=P(None, "sp"))(
                *(jax.numpy.asarray(a) for a in (q, k, v)))
    with pytest.raises(ValueError) as got:
        uly.ulysses_attention(*(torch.from_numpy(a[:, :4]) for a in (q, k, v)),
                              axis=spmd.Axis("sp", 4, 0))
    assert str(got.value) == str(want.value)


def test_llama_attention_routes_ring_and_ulysses():
    """``attn_impl`` "ring"/"ulysses" reach the ops (no axis: one rank),
    and forward with either equals forward with "xla"."""
    cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32, remat=False)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))
    want = llama.forward(params, tok, cfg)
    for impl in ("ring", "ulysses"):
        got = llama.forward(params, tok, cfg.replace(attn_impl=impl))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=0)
