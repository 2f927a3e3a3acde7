"""Parity of ray_tpu_torch/ops/paged_attention.py (kernels K6 and K5 and
their plain versions) against ray_tpu/ops/paged_attention.py.

Inputs come from numpy with a fixed seed, in f32. Off-TPU the JAX
``paged_decode_attention_inplace`` and ``paged_attention`` take their
references, which the port's wrappers must match on the CPU: K6's outputs
on live rows within 1e-5 (f32 sums in another order) and its pools exactly
(the same values are copied to the same rows); K5's outputs on live rows
within 1e-6 (the same einsums on the same f32 inputs). The CUDA kernels
are held against the plain versions in the ``cuda``-marked tests, which
skip without a card.
"""

import numpy as np
import pytest
import torch

from test_torch_support import jax_reference, require_cuda, to_np

from ray_tpu_torch.ops import paged_attention as pa

OUT_TOL = 1e-5


@pytest.fixture(scope="module")
def jnp():
    """jax.numpy for the parity tests; they skip where JAX is absent, while
    the ``cuda`` tests of this file need no JAX."""
    return pytest.importorskip("jax").numpy


def make_case(S, H, KV, HD, ps, maxP, lengths, share=None, seed=0):
    """Random q/k_new/v_new/pools and a page table of distinct pages (page
    0 = trash is never handed out). share=(a, b, n): slot b's first n pages
    are slot a's (a prefix-cache hit)."""
    rng = np.random.default_rng(seed)
    NP = S * maxP + 1
    table = rng.permutation(np.arange(1, NP))[:S * maxP].reshape(S, maxP)
    if share is not None:
        a, b, n = share
        table[b, :n] = table[a, :n]
    return dict(
        q=rng.standard_normal((S, H, HD)).astype(np.float32),
        k_new=rng.standard_normal((S, KV, HD)).astype(np.float32),
        v_new=rng.standard_normal((S, KV, HD)).astype(np.float32),
        k_pool=rng.standard_normal((KV, NP, ps, HD)).astype(np.float32),
        v_pool=rng.standard_normal((KV, NP, ps, HD)).astype(np.float32),
        page_table=table.astype(np.int32),
        lengths=np.asarray(lengths, np.int32))


# ps = 8, maxP = 4: length % ps == 1 starts a fresh tip page, == 0 ends on
# a page boundary; slot 0 of each case is inactive (length 0)
CASES = {
    "gqa_fresh_and_full_tips": dict(H=4, KV=2, lengths=[0, 9, 16, 5, 25, 32],
                                    share=(4, 5, 2)),
    "gqa_one_token_slots": dict(H=4, KV=2, lengths=[0, 1, 1, 8, 17, 24],
                                share=(4, 5, 2)),
    "mha_all_inactive_but_one": dict(H=2, KV=2, lengths=[0, 0, 0, 0, 0, 31]),
}


def run_torch(case, fn):
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    o, kp, vp = fn(t["q"], t["k_new"], t["v_new"], t["k_pool"],
                   t["v_pool"], t["page_table"], t["lengths"])
    return o, kp, vp, t


@pytest.mark.parametrize("name", sorted(CASES))
def test_inplace_plain_matches_jax(name, jnp):
    spec = CASES[name]
    case = make_case(6, spec["H"], spec["KV"], 16, 8, 4, spec["lengths"],
                     spec.get("share"))
    with jax_reference() as ref:
        jo, jk, jv = ref.paged_attention.paged_decode_attention_inplace(
            *(jnp.asarray(case[k]) for k in (
                "q", "k_new", "v_new", "k_pool", "v_pool", "page_table",
                "lengths")))
        jo, jk, jv = np.asarray(jo), np.asarray(jk), np.asarray(jv)
    o, kp, vp, _ = run_torch(case, pa.paged_decode_attention_inplace)
    live = case["lengths"] > 0
    np.testing.assert_allclose(to_np(o)[live], jo[live], atol=OUT_TOL,
                               rtol=0)
    assert np.array_equal(to_np(kp), jk)
    assert np.array_equal(to_np(vp), jv)


def test_plain_writes_only_the_new_rows_in_place():
    case = make_case(6, 4, 2, 16, 8, 4, [0, 9, 16, 5, 25, 32],
                     share=(4, 5, 2))
    o, kp, vp, t = run_torch(case, pa.paged_decode_attention_inplace)
    # the wrapper returns the pools it was given, updated in place
    assert kp is t["k_pool"] and vp is t["v_pool"]
    changed = np.argwhere((to_np(kp) != case["k_pool"]).any(-1))
    expect = []
    for s, n in enumerate(case["lengths"]):
        if n > 0:
            page = case["page_table"][s, (n - 1) // 8]
            expect += [(kv, page, (n - 1) % 8) for kv in range(2)]
    assert sorted(map(tuple, changed)) == sorted(expect)
    assert not (to_np(kp)[:, 0] != case["k_pool"][:, 0]).any()  # trash page


def test_read_only_reference_matches_jax(jnp):
    case = make_case(6, 4, 2, 16, 8, 4, [0, 9, 16, 5, 25, 32])
    with jax_reference() as ref:
        jo = np.asarray(ref.paged_attention.paged_attention_reference(
            *(jnp.asarray(case[k]) for k in (
                "q", "k_pool", "v_pool", "page_table", "lengths"))))
    o = pa.paged_attention_reference(
        *(torch.from_numpy(case[k]) for k in (
            "q", "k_pool", "v_pool", "page_table", "lengths")))
    live = case["lengths"] > 0
    np.testing.assert_allclose(to_np(o)[live], jo[live], atol=OUT_TOL,
                               rtol=0)


def test_kernel_tolerance_holds_rounding_not_a_wrong_page():
    """The bf16 bound (one ulp) takes the plain version's own rounding to
    bf16 but not a kernel that reads one wrong page of a slot."""
    case = make_case(6, 4, 2, 128, 8, 4, [0, 9, 16, 5, 25, 32])
    bf = {k: torch.from_numpy(v) for k, v in case.items()}
    for k in ("q", "k_pool", "v_pool"):
        bf[k] = bf[k].to(torch.bfloat16)
    args = ("q", "k_pool", "v_pool", "page_table", "lengths")
    plain = pa.paged_attention_reference(*(bf[k] for k in args))
    exact = pa.paged_attention_reference(
        *(bf[k].float() if bf[k].is_floating_point() else bf[k]
          for k in args))
    live = case["lengths"] > 0
    tol = pa.kernel_tolerance(plain)
    assert ((plain.float() - exact).abs()[live] <= tol[live]).all()
    # slot 5 reads slot 4's second page in place of its own
    wrong = bf["page_table"].clone()
    wrong[5, 1] = wrong[4, 1]
    bad = pa.paged_attention_reference(bf["q"], bf["k_pool"], bf["v_pool"],
                                       wrong, bf["lengths"])
    assert ((bad.float() - plain.float()).abs()[5] > tol[5]).any(-1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    require_cuda()
    case = make_case(6, 4, 2, 128, 8, 4, [0, 9, 16, 5, 25, 32],
                     share=(4, 5, 2))
    dev = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    args = [dev[k] for k in ("q", "k_new", "v_new")]
    tail = [dev["page_table"], dev["lengths"]]
    kp, vp = dev["k_pool"].clone(), dev["v_pool"].clone()
    before = pa.launches
    o, _, _ = pa.paged_decode_attention_inplace(*args, kp, vp, *tail)
    kr, vr = dev["k_pool"].clone(), dev["v_pool"].clone()
    o_ref, _, _ = pa.paged_decode_attention_inplace_reference(
        *args, kr, vr, *tail)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    live = dev["lengths"] > 0
    # elementwise: f32 within 1e-4, bf16 within one ulp (2^-7 |plain|)
    err = (o.float() - o_ref.float()).abs()[live]
    assert (err <= pa.kernel_tolerance(o_ref)[live]).all()
    assert torch.equal(kp, kr) and torch.equal(vp, vr)
    assert (o[~live] == 0).all()


# --- K5: read-only paged decode attention ---------------------------------------

READ_TOL = 1e-6
POISON = 1e3


def make_read_case(H, KV, HD=16, seed=1):
    """Six slots over pages of 8 (maxP 4): slot 0 has length 0 and an
    all-trash table row; slot 3 holds one page and its other entries point
    at trash page 0; slots 4 and 5 share their first two (full) pages. Also
    returns, per slot, the pool rows past its length that only it owns
    (and the trash page), which may hold anything."""
    lengths = [0, 9, 16, 5, 25, 32]
    case = make_case(6, H, KV, HD, 8, 4, lengths, share=(4, 5, 2), seed=seed)
    table = case["page_table"]
    table[0, :] = 0
    table[3, 1:] = 0
    dead = np.zeros(case["k_pool"].shape[1:3], bool)     # [NP, ps]
    dead[0] = True
    for s, n in enumerate(lengths):
        for j in range(4):
            page = table[s, j]
            lo = min(max(n - j * 8, 0), 8)
            if page != 0 and lo < 8:
                dead[page, lo:] = True
    return case, dead


def _poisoned(case, dead, value):
    out = dict(case)
    for k in ("k_pool", "v_pool"):
        pool = case[k].copy()
        pool[:, dead] = value
        out[k] = pool
    return out


READ_ARGS = ("q", "k_pool", "v_pool", "page_table", "lengths")


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2), (8, 1)])
def test_paged_attention_matches_jax(H, KV, jnp):
    case, dead = make_read_case(H, KV)
    poisoned = _poisoned(case, dead, POISON)
    live = case["lengths"] > 0
    outs = []
    for c in (case, poisoned):
        with jax_reference() as ref:
            jo = np.asarray(ref.paged_attention.paged_attention(
                *(jnp.asarray(c[k]) for k in READ_ARGS)))
        t = {k: torch.from_numpy(c[k].copy()) for k in READ_ARGS}
        before = pa.launches_read
        o = pa.paged_attention(*(t[k] for k in READ_ARGS))
        assert pa.launches_read == before       # the CPU takes the plain path
        assert o.shape == (6, H, 16) and o.dtype == torch.float32
        np.testing.assert_allclose(to_np(o)[live], jo[live], atol=READ_TOL,
                                   rtol=0)
        # read-only: the pools are untouched
        assert np.array_equal(t["k_pool"].numpy(), c["k_pool"])
        assert np.array_equal(t["v_pool"].numpy(), c["v_pool"])
        outs.append(to_np(o))
    # rows past each length (and the trash page) do not reach live outputs
    np.testing.assert_allclose(outs[1][live], outs[0][live], atol=READ_TOL,
                               rtol=0)


def test_paged_attention_reads_what_k6_wrote():
    """K5 over the pools K6 just wrote, with the same q and lengths, gives
    K6's output (both plain versions on the CPU)."""
    case = make_case(6, 4, 2, 16, 8, 4, [0, 9, 16, 5, 25, 32],
                     share=(4, 5, 2))
    o6, kp, vp, t = run_torch(case, pa.paged_decode_attention_inplace)
    o5 = pa.paged_attention(t["q"], kp, vp, t["page_table"], t["lengths"])
    live = case["lengths"] > 0
    torch.testing.assert_close(o5[live], o6[live], atol=READ_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", [(4, 2), (8, 8)])
def test_paged_attention_kernel_matches_plain_on_card(dtype, H, KV):
    """K5 against its plain version: live rows within kernel_tolerance,
    dead rows zero, the pools unchanged byte for byte; NaN in every row
    past a length (and in the trash page) reaches no output, since the
    kernel reads no such row."""
    require_cuda()
    case, dead = make_read_case(H, KV, HD=128)
    dev = {k: torch.from_numpy(case[k]).cuda() for k in READ_ARGS}
    for k in ("q", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    o_ref = pa.paged_attention_reference(*(dev[k] for k in READ_ARGS))
    dmask = torch.from_numpy(dead).cuda()
    for k in ("k_pool", "v_pool"):
        dev[k][:, dmask] = float("nan")
    kp0, vp0 = dev["k_pool"].clone(), dev["v_pool"].clone()
    before = pa.launches_read
    o = pa.paged_attention(*(dev[k] for k in READ_ARGS))
    torch.cuda.synchronize()
    assert pa.launches_read == before + 1
    live = dev["lengths"] > 0
    assert torch.isfinite(o.float()[live]).all()
    err = (o.float() - o_ref.float()).abs()[live]
    assert (err <= pa.kernel_tolerance(o_ref)[live]).all()
    assert (o[~live] == 0).all()
    # byte for byte (NaN != NaN, so compare the bits)
    assert torch.equal(_bits(dev["k_pool"]), _bits(kp0))
    assert torch.equal(_bits(dev["v_pool"]), _bits(vp0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_reads_what_k6_wrote_on_card(dtype):
    require_cuda()
    case = make_case(6, 4, 2, 128, 8, 4, [0, 9, 16, 5, 25, 32],
                     share=(4, 5, 2))
    dev = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    o6, kp, vp = pa.paged_decode_attention_inplace(
        dev["q"], dev["k_new"], dev["v_new"], dev["k_pool"], dev["v_pool"],
        dev["page_table"], dev["lengths"])
    o5 = pa.paged_attention(dev["q"], kp, vp, dev["page_table"],
                            dev["lengths"])
    torch.cuda.synchronize()
    live = dev["lengths"] > 0
    err = (o5.float() - o6.float()).abs()[live]
    assert (err <= pa.kernel_tolerance(o6)[live]).all()


def _refuse_plain(monkeypatch):
    """Make the plain versions raise while a kernel wrapper runs: a CUDA
    tensor must launch the kernel, never fall back."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA launch ran the plain version")

    for name in ("paged_attention_reference",
                 "paged_decode_attention_inplace_reference"):
        monkeypatch.setattr(pa, name, refuse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,HD", [
    (6, 2, 128), (7, 1, 64), (16, 1, 128), (4, 2, 48), (2, 2, 80),
    (4, 4, 96), (8, 1, 256), (2, 1, 256), (3, 1, 100)])
def test_any_shape_kernels_match_plain_on_card(dtype, H, KV, HD,
                                               monkeypatch):
    """K6 and K5 at group counts 3, 7 and 16 and head dims 48, 80, 96, 100
    and 256 (the fixed-G kernel for the shapes it is compiled for, the
    any-shape kernel for the others): the launch counters move, the plain
    versions are not called, live rows within kernel_tolerance, dead rows
    zero, K6's pools equal to the plain version's, K5's unchanged."""
    require_cuda()
    case = make_case(6, H, KV, HD, 8, 4, [0, 9, 16, 5, 25, 32],
                     share=(4, 5, 2), seed=3)
    dev = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    args = [dev[k] for k in ("q", "k_new", "v_new")]
    tail = [dev["page_table"], dev["lengths"]]
    kp, vp = dev["k_pool"].clone(), dev["v_pool"].clone()
    before = (pa.launches, pa.launches_read)
    with monkeypatch.context() as m:
        _refuse_plain(m)
        o6, _, _ = pa.paged_decode_attention_inplace(*args, kp, vp, *tail)
        k5p, v5p = kp.clone(), vp.clone()
        o5 = pa.paged_attention(dev["q"], k5p, v5p, *tail)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_read) == (before[0] + 1, before[1] + 1)
    kr, vr = dev["k_pool"].clone(), dev["v_pool"].clone()
    o_ref, _, _ = pa.paged_decode_attention_inplace_reference(*args, kr, vr,
                                                              *tail)
    live = dev["lengths"] > 0
    tol = pa.kernel_tolerance(o_ref)[live]
    for o in (o6, o5):
        assert o.shape == (6, H, HD) and o.dtype == dtype
        assert ((o.float() - o_ref.float()).abs()[live] <= tol).all()
        assert (o[~live] == 0).all()
    assert torch.equal(kp, kr) and torch.equal(vp, vr)
    assert torch.equal(k5p, kp) and torch.equal(v5p, vp)


@pytest.mark.cuda
def test_head_dim_above_256_raises_on_card():
    require_cuda()
    case = make_case(2, 2, 2, 264, 8, 2, [3, 9])
    dev = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    with pytest.raises(NotImplementedError, match="256"):
        pa.paged_attention(*(dev[k] for k in READ_ARGS))
