"""Paged decode attention for the continuous-batching LLM engine.

Port of ``ray_tpu/ops/paged_attention.py``. KV lives in a global pool of
fixed-size pages, ``[KV, NP, ps, HD]`` per layer; each decode slot owns a
row of page indices (its page table), so device memory scales with the
tokens in use, not with ``slots * max_seq``. Page 0 is the trash page.

Two kernels, one CUDA source (``csrc/paged_attention.cu``; a split pass
over ~256-token pieces of each slot, then a merge pass):

- ``paged_decode_attention_inplace`` is the fused decode step (TPU kernel
  K6, ``_kernel_inplace``): write each live slot's new k/v at position
  ``length - 1`` of its tip page and attend. The pools are updated IN
  PLACE (the JAX version aliases them through donated buffers);
- ``paged_attention`` is read-only decode attention (TPU kernel K5,
  ``_kernel``): the same split kernel with the write compiled out, every
  K/V row read from the pool, the pools never written.

For CPU tensors each wrapper runs its plain version
(``paged_decode_attention_inplace_reference``,
``paged_attention_reference``); for CUDA tensors it launches its kernel or
raises.

Shapes: q [S, H, HD] (one new token per slot), k_new/v_new [S, KV, HD],
pools [KV, NP, ps, HD], page_table [S, maxP] int32, lengths [S] int32
(tokens INCLUDING the current one; 0 marks an inactive slot). Any
G = H / KV >= 1 and any HD <= MAX_HEAD_DIM: G in {1, 2, 4, 8} with rows of
a power of two of 16-byte chunks (every preset) runs the kernel compiled
for that G; every other shape (Phi-3-mini's HD 96, Llama-3.2-3B's G 3)
the same kernel with G and HD at run time, in chunks of at most 8 query
heads.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

#: launches of the fused write+attend kernel (K6) and of the read-only one
#: (K5), each counted where it is launched, nowhere else
launches = 0
launches_read = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GROUPS = (1, 2, 4, 8)          # query heads per kv head of the fixed kernel
_GROUP_CHUNK = 8                # query heads a block of the any-G kernel
MAX_HEAD_DIM = 256
_SPLIT_TOKENS = 256             # tokens of one slot a block attends over
_THREADS = 128
_MAX_SMEM = 232448


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


def block_geometry(G: int, HD: int, elt: int):
    """(fixed, heads, lanes, vw): how ``csrc/paged_attention.cu`` lays one
    split block out for G query heads a kv head, head dim HD and elements
    of `elt` bytes. fixed: the kernel compiled for G runs (G in _GROUPS,
    HD a power of two of 16-byte chunks <= 32); else the any-shape one.
    heads: query heads a block takes (G, or a chunk of at most 8); lanes:
    threads sharing one K/V row in p . V (the reduction buffer holds
    128 / lanes partial rows); vw: elements a lane loads at once."""
    vec = 16 // elt
    lpt = HD // vec
    if G in _GROUPS and HD % vec == 0 and 0 < lpt <= 32 and 32 % lpt == 0:
        return True, G, lpt, vec
    vw = vec if HD % vec == 0 else 1
    n_chunks = -(-G // _GROUP_CHUNK)
    return False, -(-G // n_chunks), min(HD // vw, _THREADS), vw


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
    if not 0 < HD <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: the paged decode kernels take head dims up to "
            f"{MAX_HEAD_DIM}; got {HD}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the pools are read (and K6 updates them) in place "
                         "and must be contiguous")
    pps = max(1, _SPLIT_TOKENS // ps)     # pages a block attends over
    n_split = -(-maxP // pps)
    _, gb, lanes, vw = block_geometry(G, HD, q.element_size())
    smem = 4 * (gb * HD + 2 * HD + gb * pps * ps
                + (_THREADS // lanes) * gb * HD + 2 * gb)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged decode block needs {smem} bytes of shared "
                         f"memory (G={G}, HD={HD}, page_size={ps})")
    q = q.contiguous()
    new = [t.contiguous() for t in new]
    page_table, lengths = page_table.contiguous(), lengths.contiguous()
    if vw > 1 and any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError("the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    # per-split softmax state, merged by the kernel's second pass
    part_o = torch.empty((S, KV, n_split, G, HD), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((S, KV, n_split, G, 2), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    fn = getattr(lib, what)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[dt], q.data_ptr(), *(t.data_ptr() for t in new),
                k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), part_o.data_ptr(),
                part_ml.data_ptr(), S, H, KV, NP, ps, HD, maxP, pps, n_split,
                HD ** -0.5, stream)
    _build.check(lib, rc, what)
    return out


def paged_decode_attention_inplace(q, k_new, v_new, k_pool, v_pool,
                                   page_table, lengths):
    """Fused decode step: write each live slot's new k/v [S, KV, HD] into
    its tip page AND attend. The pools are updated in place; returns
    (o [S, H, HD], k_pool, v_pool). Length-0 slots write nothing and their
    output rows are zeros on the card (garbage on the CPU); callers mask
    them."""
    global launches
    _build.reject_dtensor("paged_decode_attention_inplace", q, k_new, v_new,
                          k_pool, v_pool, page_table, lengths)
    if not q.is_cuda:
        return paged_decode_attention_inplace_reference(
            q, k_new, v_new, k_pool, v_pool, page_table, lengths)
    out = _launch("paged_decode_attention_inplace", q, k_pool, v_pool,
                  page_table, lengths, k_new, v_new)
    launches += 1
    return out, k_pool, v_pool


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q [S, H, HD] -> [S, H, HD], read-only. lengths INCLUDE the current
    token (its k/v already in the pool). Length-0 slots output zeros on the
    card (garbage on the CPU, as in JAX); callers mask them."""
    global launches_read
    _build.reject_dtensor("paged_attention", q, k_pool, v_pool, page_table,
                          lengths)
    if not q.is_cuda:
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths)
    out = _launch("paged_attention", q, k_pool, v_pool, page_table, lengths)
    launches_read += 1
    return out
