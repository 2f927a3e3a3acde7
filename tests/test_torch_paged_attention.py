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
    and 256 (bf16 at a head dim that is a multiple of 8 on the ring
    kernel; f32 on the fixed-G kernel at its shapes, the any-shape kernel
    at the others, as bf16 at HD 100): the launch counters move, the plain
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,HD", [(1, 320), (4, 320), (1, 512), (4, 512),
                                  (4, 1040)])
def test_wide_paged_kernels_match_plain_on_card(dtype, G, HD, monkeypatch):
    """K6 and K5 above head dim 256 (the any-shape kernel in both dtypes,
    counted by the wide counters): HD 320 and 512 at G 1 and 4, and 1040,
    whose p . V takes two passes in bf16 and three in f32; pages of 16,
    splits of 256 tokens, the ring tests' lengths, every dead pool row NaN
    (``_paged_round_trip``)."""
    require_cuda()
    KV = 2
    geo = pa.block_geometry(G, HD, torch.tensor([], dtype=dtype)
                            .element_size(), S=6, KV=KV, ps=16, maxP=8)
    assert geo.kernel == "any"
    _paged_round_trip(6, G * KV, KV, HD, 16, 8, [0, 1, 32, 33, 80, 47],
                      (4, 5, 2), G + HD, monkeypatch, dtype=dtype,
                      counters=("launches_wide", "launches_read_wide"))


# --- the split rule and the blocks' geometry (plain Python) ----------------


@pytest.mark.parametrize("S,KV,chunks,maxP,expect", [
    (16, 32, 1, 32, 8),     # the 7b serving shape (and Phi-3-mini): 512 tokens
    (16, 8, 1, 32, 2),      # the 1b preset's GQA (and Llama-3.2-3B)
    (16, 1, 1, 32, 1),      # Gemma-2B: one kv head, one page a split
    (16, 1, 2, 32, 1),      # G 16: two chunks of 8 query heads
    (64, 32, 1, 128, 125),  # 64 slots of 8,192 tokens
    (1, 1, 1, 1, 1),
])
def test_split_pages_rule(S, KV, chunks, maxP, expect):
    """pps = ceil(S KV chunks maxP / (16 x 132)): a launch of about 16
    blocks an SM if every slot were full, never fewer pages than 1."""
    pps = pa.split_pages(S, KV, chunks, maxP)
    assert pps == expect
    blocks = S * KV * chunks * -(-maxP // pps)
    assert blocks <= pa.SPLIT_BLOCKS + S * KV * chunks
    if pps > 1:
        assert S * KV * chunks * -(-maxP // (pps - 1)) > pa.SPLIT_BLOCKS


# (name, G, HD, KV, ring geometry at 16 slots of 32 pages of 64, f32's
# kernel). A stage holds 16 K and 16 V rows in TMA boxes, 64 HD bytes
# rounded up to 1 KB (7b: 8,192; Phi-3-mini 6,144; Gemma-2B 16,384; HD 64
# 4,096); the ring at least 32 KB in 1-4 slots a consumer warp (4, 8, 4,
# 8); then the new k/v row (4 HD bytes), 8 bytes of mbarrier a slot twice
# and one more, 256 of the warps' (max, sum), the page ids (pps rounded
# up to 4 ints: 8 pages at 7b and Phi-3-mini, 1 at the others) and 1 KB
# to align the ring
PUBLIC_PAGED = [
    ("7b", 1, 128, 32,
     ("ring", 1, 1, 8, 4, 4, 32768 + 512 + 72 + 256 + 32 + 1024), "fixed"),
    ("phi3-mini", 1, 96, 32,
     ("ring", 1, 1, 8, 4, 8, 49152 + 384 + 136 + 256 + 32 + 1024), "any"),
    ("gemma-2b", 8, 256, 1,
     ("ring", 8, 1, 1, 32, 4, 65536 + 1024 + 72 + 256 + 16 + 1024), "any"),
    ("g16", 16, 64, 1,
     ("ring", 8, 2, 1, 32, 8, 32768 + 256 + 136 + 256 + 16 + 1024), "any"),
]


@pytest.mark.parametrize("name,G,HD,KV,expect,f32_kernel", PUBLIC_PAGED,
                         ids=[c[0] for c in PUBLIC_PAGED])
def test_ring_geometry_at_public_shapes(name, G, HD, KV, expect, f32_kernel):
    """bf16 takes the ring kernel with ``split_pages``' split; f32 at the
    same shape the fixed (G 1, 2, 4, 8 at a power-of-two row) or the
    any-shape kernel, with 256-token splits (4 pages)."""
    geo = pa.block_geometry(G, HD, 2, S=16, KV=KV, ps=64, maxP=32)
    assert tuple(geo) == expect
    f32 = pa.block_geometry(G, HD, 4, S=16, KV=KV, ps=64, maxP=32)
    assert (f32.kernel, f32.pps, f32.n_split, f32.slots) == (f32_kernel, 4,
                                                            8, 0)
    assert (f32.heads, f32.chunks) == (geo.heads, geo.chunks)


def _ring_chunk(HD, ps, r, ch):
    """Shared-memory offset of 16-byte chunk ch of stage row r in a ring
    tensor, as csrc/paged_attention.cu's RingSmem::at lays it: boxes of
    the largest of 32, 16, 8 columns that divides HD, 16 rows of 2 bc
    bytes each; TMA's swizzle (chunk c of row r at c ^ ((r >> xs) & (bc /
    8 - 1))) where bc >= 16 and the copies' rows (16, or the largest power
    of two dividing ps) are >= 8."""
    bc = next(b for b in (32, 16, 8) if HD % b == 0)
    lc = {32: 2, 16: 1, 8: 0}[bc]
    br = min(16, ps & -ps)
    m = (1 << lc) - 1
    x = (r >> (3 - lc)) & m if bc >= 16 and br >= 8 else 0
    return (ch >> lc) * 16 * 2 * bc + r * 2 * bc + (((ch & m) ^ x) << 4)


def test_ring_geometry_fits_every_head_dim():
    """At every head dim that is a multiple of 8 up to 256 and page sizes
    of 8, 16 and 64: each row's chunks in distinct places inside the
    stage's 32 HD bytes, the 8 rows an ldmatrix phase reads at one chunk
    in 8 distinct bank groups (conflict-free), at least RING_BYTES of ring
    in 1-4 slots a consumer warp (or 4 slots), room on the ring for the
    warps' f32 outputs at the block's end, and a block within the card's
    227 KB even at 256 pages a split."""
    for HD in range(8, 257, 8):
        for ps in (8, 16, 64):
            offs = {_ring_chunk(HD, ps, r, ch)
                    for r in range(16) for ch in range(HD // 8)}
            assert len(offs) == 2 * HD and max(offs) < 32 * HD
            for r0 in (0, 8):
                for ch in range(HD // 8):
                    banks = {_ring_chunk(HD, ps, r0 + r, ch) // 16 % 8
                             for r in range(8)}
                    assert len(banks) == 8, (HD, ps, r0, ch)
            for pps in (1, 4, 256):
                geo = pa.block_geometry(8, HD, 2, S=1, KV=1, ps=ps,
                                        maxP=pps)
                ring = geo.slots * -(-64 * HD // 1024) * 1024
                assert geo.kernel == "ring"
                assert geo.slots % pa.RING_WARPS == 0
                assert 1 <= geo.slots // pa.RING_WARPS <= 4
                assert (ring >= pa.RING_BYTES
                        or geo.slots == 4 * pa.RING_WARPS)
                assert pa.RING_WARPS * 8 * HD * 4 <= ring
                assert geo.smem <= pa._MAX_SMEM


# --- the ring kernel on the card --------------------------------------------


def _force_pps(monkeypatch, S, KV, chunks, maxP, pps):
    """Set SPLIT_BLOCKS so that ``split_pages`` gives `pps` at this shape."""
    n = S * KV * chunks * maxP
    for blocks in range(1, n + 1):
        if -(-n // blocks) == pps:
            monkeypatch.setattr(pa, "SPLIT_BLOCKS", blocks)
            assert pa.split_pages(S, KV, chunks, maxP) == pps
            return
    raise AssertionError(f"no SPLIT_BLOCKS gives {pps} pages a split")


def _paged_round_trip(S, H, KV, HD, ps, maxP, lengths, share, seed,
                      monkeypatch, dtype=torch.bfloat16,
                      counters=("launches", "launches_read")):
    """K6 twice, then K5 twice over the pools K6 wrote, on the card in
    `dtype`, against the plain version (the two launch `counters` of K6
    and K5 moving by 2 each): live rows within kernel_tolerance,
    dead rows zero, the pools equal to the plain version's (and unchanged
    by K5), each kernel's two runs bit-identical, and K5 bit-identical to
    K6 (the new rows it reads from the pools are the ones K6 took from
    k_new/v_new). Every pool row but the live ones holds NaN: a copy
    brings whole box rows of a slot's last page, and none of the rows past
    a length may reach an output."""
    case = make_case(S, H, KV, HD, ps, maxP, lengths, share=share, seed=seed)
    dev = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    args = [dev[k] for k in ("q", "k_new", "v_new")]
    tail = [dev["page_table"], dev["lengths"]]
    # the plain version on clean pools: it multiplies every row by its p
    kr, vr = dev["k_pool"].clone(), dev["v_pool"].clone()
    o_ref, _, _ = pa.paged_decode_attention_inplace_reference(*args, kr, vr,
                                                              *tail)
    live_rows = np.zeros(case["k_pool"].shape[1:3], bool)   # [NP, ps]
    for s, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            live_rows[case["page_table"][s, j], :min(n - j * ps, ps)] = True
    dmask = torch.from_numpy(~live_rows).cuda()
    for k in ("k_pool", "v_pool"):
        dev[k][:, dmask] = float("nan")
    kp, vp = dev["k_pool"].clone(), dev["v_pool"].clone()
    before = [getattr(pa, c) for c in counters]
    with monkeypatch.context() as m:
        _refuse_plain(m)
        o6, _, _ = pa.paged_decode_attention_inplace(*args, kp, vp, *tail)
        k6p, v6p = kp.clone(), vp.clone()
        o6b, _, _ = pa.paged_decode_attention_inplace(*args, kp, vp, *tail)
        o5 = pa.paged_attention(dev["q"], kp, vp, *tail)
        o5b = pa.paged_attention(dev["q"], kp, vp, *tail)
    # the pools: the plain version's write into the poisoned pools
    kr, vr = dev["k_pool"].clone(), dev["v_pool"].clone()
    pa.paged_decode_attention_inplace_reference(*args, kr, vr, *tail)
    torch.cuda.synchronize()
    assert [getattr(pa, c) - b for c, b in zip(counters, before)] == [2, 2]
    live = dev["lengths"] > 0
    tol = pa.kernel_tolerance(o_ref)[live]
    assert ((o6.float() - o_ref.float()).abs()[live] <= tol).all()
    assert torch.equal(_bits(k6p), _bits(kr))
    assert torch.equal(_bits(v6p), _bits(vr))
    assert torch.equal(_bits(kp), _bits(k6p))
    assert torch.equal(_bits(vp), _bits(v6p))
    assert torch.isfinite(o6.float()[live]).all()
    assert torch.equal(o6, o6b) and torch.equal(o5, o5b)
    assert torch.equal(o5[live], o6[live])
    assert (o6[~live] == 0).all() and (o5[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("HD", [64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 8, 16])
def test_ring_kernel_matches_plain_on_card(G, HD, monkeypatch):
    """The ring kernel at G 1, 2, 3, 8 and 16 (two chunks of 8) and head
    dims 64-256, pages of 16, splits of 2 pages (32 tokens): a length-0
    slot; a one-token slot (the tip in a split's first page and first
    stage); a slot ending exactly on a split boundary; one whose tip opens
    a split (33); one ending on a page boundary (80); one whose first split
    is slot 4's shared prefix pages, its tip on the page right after them
    (47)."""
    require_cuda()
    KV = 1 if G == 16 else 2
    _force_pps(monkeypatch, 6, KV, -(-G // 8), 8, 2)
    assert pa.block_geometry(G, HD, 2, S=6, KV=KV, ps=16,
                             maxP=8).kernel == "ring"
    _paged_round_trip(6, G * KV, KV, HD, 16, 8, [0, 1, 32, 33, 80, 47],
                     (4, 5, 2), G * HD, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("G,HD", [(3, 96), (8, 256)])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_ring_kernel_stages_and_pages_on_card(ps, G, HD, monkeypatch):
    """Page sizes 8, 16 and 64 with splits of 256 tokens (16 stages, the
    ring of 8 slots at HD 96 and of 4 at 256 walked around more than once)
    and, for the same lengths, of one page: tips in every stage of a split
    (the ring's last slot among them), lengths on a split boundary (256)
    and the whole table (512), and a slot whose pages before its tip page
    are another slot's."""
    require_cuda()
    maxP = 512 // ps
    lengths = ([0] + [1 + 16 * i + (5 * i) % 16 + 256 * (i % 2)
                      for i in range(16)] + [256, 512, 255])
    share = (18, 19, 254 // ps)
    for pps in (256 // ps, 1):
        with monkeypatch.context() as m:
            _force_pps(m, len(lengths), 1, 1, maxP, pps)
            _paged_round_trip(len(lengths), G, 1, HD, ps, maxP, lengths,
                             share, ps + pps, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,HD,symbol", [
    (torch.bfloat16, 128, "paged_decode_ring_kernel"),
    (torch.bfloat16, 96, "paged_decode_ring_kernel"),
    (torch.bfloat16, 40, "paged_decode_ring_kernel"),
    (torch.bfloat16, 100, "paged_decode_split_any_kernel"),
    (torch.float32, 128, "paged_decode_split_kernel"),
    (torch.float32, 96, "paged_decode_split_any_kernel"),
])
def test_paged_routes_on_card(dtype, HD, symbol):
    """The kernels a launch runs, by the profiler's names: bf16 at a head
    dim that is a multiple of 8 (40: a half k-step) the ring kernel, bf16
    at HD 100 the any-shape kernel; f32 the fixed-G kernel at G 2 and
    HD 128, the any-shape kernel at HD 96; each with the merge pass, and
    the outputs within kernel_tolerance."""
    require_cuda()
    from torch.profiler import ProfilerActivity, profile

    case = make_case(6, 4, 2, HD, 8, 4, [0, 9, 16, 5, 25, 32],
                     share=(4, 5, 2), seed=5)
    dev = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    args = [dev[k] for k in ("q", "k_new", "v_new", "k_pool", "v_pool",
                             "page_table", "lengths")]
    o, _, _ = pa.paged_decode_attention_inplace(*args)
    # CUPTI now and then drops a short trace's kernels: a trace without
    # both passes is taken again, up to 5 times, each on copies of the
    # inputs; every trace's names are kept
    names: set = set()
    for _ in range(5):
        again = [a.clone() for a in args]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pa.paged_decode_attention_inplace(*again)
            torch.cuda.synchronize()
        traced = {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        names |= traced
        if (any("merge" in n for n in traced)
                and any("paged_decode" in n and "merge" not in n
                        for n in traced)):
            break
    split = [n for n in names if "paged_decode" in n and "merge" not in n]
    assert split and all(symbol in n for n in split), names
    assert any("paged_decode_merge_kernel" in n for n in names), names
    kr, vr = dev["k_pool"].clone(), dev["v_pool"].clone()
    case2 = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        case2[k] = case2[k].to(dtype)
    o_ref, _, _ = pa.paged_decode_attention_inplace_reference(
        case2["q"], case2["k_new"], case2["v_new"], case2["k_pool"],
        case2["v_pool"], case2["page_table"], case2["lengths"])
    live = dev["lengths"] > 0
    tol = pa.kernel_tolerance(o_ref)[live]
    assert ((o.float() - o_ref.float()).abs()[live] <= tol).all()
    assert torch.equal(kr, case2["k_pool"])
