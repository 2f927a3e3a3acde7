"""Paged decode attention for the continuous-batching LLM engine.

Port of ``ray_tpu/ops/paged_attention.py``. KV lives in a global pool of
fixed-size pages, ``[KV, NP, ps, HD]`` per layer; each decode slot owns a
row of page indices (its page table), so device memory scales with the
tokens in use, not with ``slots * max_seq``. Page 0 is the trash page.

Two kernels, one CUDA source (``csrc/paged_attention.cu``; a split pass
over pieces of each slot's pages, then a merge pass):

- ``paged_decode_attention_inplace`` is the fused decode step (TPU kernel
  K6, ``_kernel_inplace``): write each live slot's new k/v at position
  ``length - 1`` of its tip page and attend. The pools are updated IN
  PLACE (the JAX version aliases them through donated buffers);
- ``paged_attention`` is read-only decode attention (TPU kernel K5,
  ``_kernel``): the same split kernel with the write compiled out, every
  K/V row read from the pool, the pools never written.

bf16 at a head dim up to 256 that is a multiple of 8 runs the ring kernel
(``paged_decode_ring_kernel``): a producer warp loads the split's pages by
TMA, 16 keys a stage, through a tensor map of each pool (encoded once per
pool and kept) into a ring with mbarriers, and four consumer warps each
take every fourth stage in one pass (scores by ``mma.sync``, the online
softmax, ``O += P V``); splits of ``split_pages(S, KV, chunks, maxP)``
pages, then a merge pass (which also stores K6's new rows). f32 runs the
fixed-G kernel at G 1, 2, 4, 8 and power-of-two rows, every other shape
(and bf16 at HD 100, and bf16 above 256) the any-shape kernel, both with
256-token splits (64 above head dim 256).
``block_geometry`` says which a launch takes, with its split and shared
memory.

For CPU tensors each wrapper runs its plain version
(``paged_decode_attention_inplace_reference``,
``paged_attention_reference``); for CUDA tensors it launches its kernel or
raises.

Shapes: q [S, H, HD] (one new token per slot), k_new/v_new [S, KV, HD],
pools [KV, NP, ps, HD], page_table [S, maxP] int32, lengths [S] int32
(tokens INCLUDING the current one; 0 marks an inactive slot). Any
G = H / KV >= 1 and any HD (the any-shape kernel takes HD at run time,
with no upper limit but its block's shared memory); the ring and any-shape
kernels take a kv head's query heads in chunks of at most 8 (G 16: two
blocks a kv head).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

#: launches of the fused write+attend kernel (K6) and of the read-only one
#: (K5) at head dims up to 256, each counted where it is launched, nowhere
#: else
launches = 0
launches_read = 0
#: the same two above 256, where the any-shape kernel runs in both dtypes
launches_wide = 0
launches_read_wide = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GROUP_CHUNK = 8                # query heads a block
RING_MAX_HEAD_DIM = 256         # above it bf16 takes the any-shape kernel
_SPLIT_TOKENS = 256             # tokens a block of the any-shape kernel
# above head dim 256: its rows are long, so a split of 64 tokens keeps a
# block's walk short and the blocks many (at HD 512, 16 slots of 8,594
# live tokens: 0.110 ms for K5 against 0.28 at 256; PERF.md)
_WIDE_SPLIT_TOKENS = 64
_THREADS = 128                  # threads a block of the any-shape kernel
_MAX_SMEM = 232448
SMS = 132                       # the H100's SMs: the unit of the split rule
SPLIT_BLOCKS = 16 * SMS         # blocks a launch aims at if slots were full
RING_KEYS = 16                  # keys a ring stage
RING_WARPS = 4                  # consumer warps a ring block
RING_BYTES = 32768              # bytes a block's ring holds at least


class PagedGeometry(NamedTuple):
    """How ``csrc/paged_attention.cu`` runs one launch: ``kernel`` "ring"
    (bf16 at HD <= 256), "fixed" (f32 at G 1, 2, 4, 8 and HD a power of two
    <= 128) or "any"; ``heads`` query heads a block (a chunk of <= 8 of a kv
    head's G), ``chunks`` of them a kv head; ``pps`` pages a split,
    ``n_split`` splits a slot; ``slots`` ring slots (ring kernel; 0 for
    the other); ``smem`` a block's shared-memory bytes."""
    kernel: str
    heads: int
    chunks: int
    pps: int
    n_split: int
    slots: int
    smem: int

def paged_attention_reference(q, k_pool, v_pool, page_table, lengths):
    """Plain version: gather the pages, mask, attend. Materializes the
    [S, maxP * ps] view that the kernel exists to avoid."""
    S, H, HD = q.shape
    KV, NP, ps, _ = k_pool.shape
    maxP = page_table.shape[1]
    groups = H // KV
    pt = page_table.long()
    k = k_pool[:, pt].reshape(KV, S, maxP * ps, HD)    # [KV, S, T, HD]
    v = v_pool[:, pt].reshape(KV, S, maxP * ps, HD)
    qf = q.reshape(S, KV, groups, HD).float()
    s = torch.einsum("skgd,kstd->skgt", qf, k.float()) * (HD ** -0.5)
    pos = torch.arange(maxP * ps, device=q.device)[None, :]
    mask = pos < lengths.long()[:, None]                # [S, T]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (inactive slots) produce uniform p; output unused
    out = torch.einsum("skgt,kstd->skgd", p, v.float())
    return out.reshape(S, H, HD).to(q.dtype)


def paged_decode_attention_inplace_reference(q, k_new, v_new, k_pool,
                                             v_pool, page_table, lengths):
    """Plain version of the fused write+attend step: write each live
    slot's new k/v into its tip page (in place), then attend. Inactive
    slots (length 0) write nothing."""
    ps = k_pool.shape[2]
    lengths = lengths.long()
    live = torch.nonzero(lengths > 0).flatten()
    pos = lengths[live] - 1
    page = page_table.long()[live, pos // ps]
    off = pos % ps
    k_pool[:, page, off, :] = k_new[live].transpose(0, 1).to(k_pool.dtype)
    v_pool[:, page, off, :] = v_new[live].transpose(0, 1).to(v_pool.dtype)
    o = paged_attention_reference(q, k_pool, v_pool, page_table, lengths)
    return o, k_pool, v_pool


def kernel_tolerance(plain_out):
    """Elementwise bound on |kernel - plain| on live rows. Both compute in
    f32 and round o to q.dtype once. f32: 1e-4 (the sums run in another
    order). bf16: two roundings of f32 values that agree to f32 precision
    land at most one bf16 ulp apart, and an ulp is at most 2^-7 |o|; 1e-5
    covers values so small that the f32 order decides them."""
    if plain_out.dtype == torch.float32:
        return torch.full(plain_out.shape, 1e-4, device=plain_out.device)
    return 2.0 ** -7 * plain_out.float().abs() + 1e-5


def split_pages(S: int, KV: int, chunks: int, maxP: int) -> int:
    """The ring kernel's pages a split: a launch of S x KV x chunks x
    splits blocks aims at about SPLIT_BLOCKS (16 an SM) if every slot held
    maxP pages. Slots use a fraction of their pages and the blocks past a
    slot's length exit at once, so the live blocks come to a few an SM: 8
    pages (512 tokens at page 64) at the 7b serving shape (S 16, KV 32,
    maxP 32), 2 at the 1b preset's (KV 8), 1 where S x KV is small
    (Gemma-2B's one kv head). From the shapes alone: the lengths live on
    the card. (Aiming at 32 an SM, or 64, ran the bf16 rows 0-25% slower
    on an H100: more splits, more merging; PERF.md.)"""
    return max(1, -(-(S * KV * chunks * maxP) // SPLIT_BLOCKS))


def _ring_smem(HD: int, ps: int, pps: int):
    """(slots, bytes) of a ring block: the csrc's RingSmem. A stage holds
    16 K rows and 16 V rows in TMA boxes (2 HD bytes a row each: 64 HD bytes,
    rounded up to 1 KB); at least RING_BYTES of ring in 1-4 slots a
    consumer warp; then the new k/v row, three mbarriers' words (full and
    empty a slot, one for the new row), the warps' (max, sum) of 8 heads,
    the split's page ids, and 1 KB to align the ring."""
    slot = -(-2 * RING_KEYS * 2 * HD // 1024) * 1024   # K and V rows, bf16
    depth = min(4, max(1, -(-RING_BYTES // (RING_WARPS * slot))))
    slots = RING_WARPS * depth
    return slots, (slots * slot + 4 * HD + 8 * (2 * slots + 1)
                   + 4 * RING_WARPS * 8 * 2 + 4 * (-(-pps // 4) * 4) + 1024)


@functools.lru_cache(maxsize=256)
def block_geometry(G: int, HD: int, elt: int, *, S: int, KV: int, ps: int,
                   maxP: int) -> PagedGeometry:
    """Which paged decode kernel a launch with G query heads a kv head,
    head dim HD and elements of `elt` bytes takes, and its split and shared
    memory (the wrapper's check and the C launch compute the same): bf16
    at HD a multiple of 8 up to 256 the ring kernel, split by
    ``split_pages``; f32 at G 1, 2, 4 or 8 and rows of a power of two of
    16-byte chunks the fixed kernel, every other shape the any-shape
    kernel, both 256-token splits (64 above head dim 256), their shared
    memory the split's scores, q, the new row and the
    p . V partial rows of 128 / (HD / vw) token groups."""
    chunks = -(-G // _GROUP_CHUNK)
    heads = -(-G // chunks)
    if elt == 2 and HD % 8 == 0 and HD <= RING_MAX_HEAD_DIM:
        pps = split_pages(S, KV, chunks, maxP)
        slots, smem = _ring_smem(HD, ps, pps)
        return PagedGeometry("ring", heads, chunks, pps, -(-maxP // pps),
                             slots, smem)
    vec = 16 // elt
    nch = HD // vec if HD % vec == 0 else HD
    fixed = (elt == 4 and G in (1, 2, 4, 8) and HD % vec == 0
             and 32 % nch == 0)
    groups = _THREADS // nch if nch <= _THREADS else 1
    tokens = _SPLIT_TOKENS if HD <= RING_MAX_HEAD_DIM else _WIDE_SPLIT_TOKENS
    pps = max(1, tokens // ps)
    smem = 4 * (heads * HD + 2 * HD + heads * pps * ps
                + groups * heads * HD + 2 * heads)
    if fixed:
        return PagedGeometry("fixed", heads, chunks, pps, -(-maxP // pps), 0,
                             smem)
    return PagedGeometry("any", heads, chunks, pps, -(-maxP // pps), 0, smem)


def _lib():
    lib = _build.load("paged_attention")
    P = ctypes.c_void_p
    I = ctypes.c_int
    for name, n_ptr in (("paged_decode_attention_inplace", 10),
                        ("paged_attention", 8)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [I] + [P] * n_ptr + [I] * 9 + [ctypes.c_float, P]
            fn.restype = I
    return lib


def _launch(what, q, k_pool, v_pool, page_table, lengths, k_new=None,
            v_new=None):
    """Check the inputs and launch K6 (given k_new/v_new) or K5 on the
    current stream; returns o [S, H, HD]."""
    S, H, HD = q.shape
    KV, NP, ps, _ = k_pool.shape
    maxP = page_table.shape[1]
    new = [t for t in (k_new, v_new) if t is not None]
    tensors = (q, k_pool, v_pool, page_table, lengths, *new)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    dt = q.dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in
                                (k_pool, v_pool, *new)):
        raise TypeError(f"{what}: q, the pools (and k_new, v_new) must share "
                        f"one dtype of {list(_DTYPES)}; got "
                        f"{[t.dtype for t in tensors]}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if (any(t.shape != (S, KV, HD) for t in new)
            or v_pool.shape != k_pool.shape or k_pool.shape[3] != HD
            or page_table.shape[0] != S or lengths.shape != (S,)
            or KV == 0 or H % KV):
        raise ValueError(
            f"{what}: bad shapes q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} table {tuple(page_table.shape)} lengths "
            f"{tuple(lengths.shape)} new "
            f"{[tuple(t.shape) for t in new]}")
    G = H // KV
    if HD == 0:
        raise ValueError(f"{what}: head dim 0")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the pools are read (and K6 updates them) in place "
                         "and must be contiguous")
    geo = block_geometry(G, HD, q.element_size(), S=S, KV=KV, ps=ps,
                         maxP=maxP)
    if geo.smem > _MAX_SMEM:
        raise ValueError(f"paged decode block needs {geo.smem} bytes of "
                         f"shared memory (G={G}, HD={HD}, page_size={ps})")
    q = q.contiguous()
    new = [t.contiguous() for t in new]
    page_table, lengths = page_table.contiguous(), lengths.contiguous()
    if HD * q.element_size() % 16 == 0 and any(
            t.data_ptr() % 16 for t in (q, k_pool, v_pool, *new)):
        raise ValueError("q, the pools (and k_new, v_new) must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    # per-split softmax state, merged by the kernel's second pass
    part_o = torch.empty((S, KV, geo.n_split, G, HD), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((S, KV, geo.n_split, G, 2), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    fn = getattr(lib, what)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[dt], q.data_ptr(), *(t.data_ptr() for t in new),
                k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), part_o.data_ptr(),
                part_ml.data_ptr(), S, H, KV, NP, ps, HD, maxP, geo.pps,
                geo.n_split, HD ** -0.5, stream)
    _build.check(lib, rc, what)
    return out


def paged_decode_attention_inplace(q, k_new, v_new, k_pool, v_pool,
                                   page_table, lengths):
    """Fused decode step: write each live slot's new k/v [S, KV, HD] into
    its tip page AND attend. The pools are updated in place; returns
    (o [S, H, HD], k_pool, v_pool). Length-0 slots write nothing and their
    output rows are zeros on the card (garbage on the CPU); callers mask
    them."""
    global launches, launches_wide
    _build.reject_dtensor("paged_decode_attention_inplace", q, k_new, v_new,
                          k_pool, v_pool, page_table, lengths)
    if not q.is_cuda:
        return paged_decode_attention_inplace_reference(
            q, k_new, v_new, k_pool, v_pool, page_table, lengths)
    out = _launch("paged_decode_attention_inplace", q, k_pool, v_pool,
                  page_table, lengths, k_new, v_new)
    if q.shape[-1] > RING_MAX_HEAD_DIM:
        launches_wide += 1
    else:
        launches += 1
    return out, k_pool, v_pool


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q [S, H, HD] -> [S, H, HD], read-only. lengths INCLUDE the current
    token (its k/v already in the pool). Length-0 slots output zeros on the
    card (garbage on the CPU, as in JAX); callers mask them."""
    global launches_read, launches_read_wide
    _build.reject_dtensor("paged_attention", q, k_pool, v_pool, page_table,
                          lengths)
    if not q.is_cuda:
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths)
    out = _launch("paged_attention", q, k_pool, v_pool, page_table, lengths)
    if q.shape[-1] > RING_MAX_HEAD_DIM:
        launches_read_wide += 1
    else:
        launches_read += 1
    return out
