"""Fused causal / sliding-window attention (flash-style) for Hopper, forward
and backward.

Port of ``ray_tpu/ops/flash_attention.py``:

- forward, ``flash_attention_fwd``: TPU kernels K1 (``_fwd_kernel_loop``,
  causal or full) and K2 (``_fwd_kernel_stream``, the sliding window) are
  one CUDA kernel here (``csrc/flash_attention.cu``) with a ``window``
  argument, which streams only the K/V tiles inside the causal band, so a
  window costs O(S * W). bf16 with head dim 64, 80, 96, 128 or 256 runs
  the Hopper kernel (TMA, mbarriers, warp-specialised ``wgmma``, 128-row
  query tiles; head dim 80 in five 16-column boxes; 64-key tiles and one V
  stage at head dim 256); bf16 with head dim 16 or 32 the small-head
  kernel (64-row blocks, a TMA ring of 128-key stages, ``mma.sync`` from
  registers, as in the backward's small-head kernels); f32 exact
  CUDA-core FMAs; head dims above 256, in either dtype, the wide kernel
  (``flash_fwd_wide_kernel``: D a run-time argument, a block one 64-column
  chunk of the output, the scores summed over every chunk);
- backward, ``flash_attention_bwd``: the FlashAttention-2 split of the TPU
  kernels K3 (``_bwd_dq_kernel``) and K4 (``_bwd_dkdv_kernel``) in
  ``csrc/flash_attention_bwd.cu``: a dQ pass over query tiles and a dK/dV
  pass over key tiles, both recomputing P from the saved log-sum-exp, with
  no atomics (the gradients are deterministic, so a remat recompute is
  bit-identical). bf16 with head dim 64, 80, 96, 128 or 256 runs the
  Hopper kernels in both passes (TMA, mbarriers, warp-specialised
  ``wgmma``; head dim 80 in five 16-column boxes): dQ
  over 128-row query tiles, dK/dV over 128-key blocks that stream every
  query head of their kv head (at head dim 256 64-key blocks, one
  consumer a gradient, the query heads split over a thread block cluster
  where the grid is short of two waves); bf16 with head dim 16 or 32 the
  small-head kernels (64-row blocks, a TMA ring of 128-row stages,
  ``mma.sync`` from registers, the walk split over a cluster of up to 8
  blocks where the heaviest block's chain is long:
  ``bwd_cluster_sizes``); f32 exact CUDA-core FMAs; head dims above 256,
  in either dtype, the wide kernels (``flash_bwd_dq_wide_kernel``,
  ``flash_bwd_dkdv_wide_kernel``, laid out as the forward's);
- ``_Flash``, a ``torch.autograd.Function``, takes the place of ``_flash``'s
  ``custom_vjp``.

GQA is handled in the kernels (kv_head = h // groups), with no K/V
broadcast; K4 loops over the query heads of its kv head inside the block,
so no per-head f32 dK/dV buffers exist. For CPU tensors each wrapper runs
its plain version (``flash_attention_reference``,
``flash_attention_bwd_reference``), which follows ``llama._attention_xla``
and ``_reference_chunked_bwd``.

Shapes: q [B, S, H, D], k/v [B, T, KV, D] -> out [B, S, H, D] in q.dtype,
lse [B, H, S] f32 (the TPU kernel's 128-lane broadcast of the LSE existed
only for Mosaic and is dropped). Unlike the TPU wrapper, S and T need not
divide a block: the kernels mask the ragged edge. Head dims: any D, like
the TPU kernels, whose blocks span the whole D. Up to 256 the kernels are
compiled for KERNEL_HEAD_DIMS; above 256 the wide kernels take D at run
time in multiples of WIDE_MULTIPLE. Any other D runs at the next of those
(``kernel_head_dim``) with q, k, v (and out, dO) zero-padded along D and
the scale of the true D (``on_kernel_head_dim``), which is exact: zero
columns add nothing to q.k and give zero columns of out, dq, dk and dv,
which are sliced off.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

#: launches of the CUDA forward kernel without a window (K1) and with one
#: (K2), and of the backward kernels K3 (dQ) and K4 (dK/dV), at head dims
#: up to 256; each counted where it is launched, nowhere else
launches = 0
launches_window = 0
launches_dq = 0
launches_dkdv = 0
#: the same four above 256, where the wide kernels run
launches_wide = 0
launches_wide_window = 0
launches_dq_wide = 0
launches_dkdv_wide = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the kernels (forward and backward, both dtypes) are
#: compiled for; bf16 runs the wgmma kernels at 64, 80, 96, 128 and 256
#: and the small-head kernels at 16 and 32, in both passes
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
#: above the last of them, the wide kernels take any head dim that is a
#: multiple of this (16-byte rows of bf16)
WIDE_MULTIPLE = 8


def _window(window) -> int:
    """None or 0 mean no window, as ``int(window or 0)`` in the JAX
    wrapper."""
    w = int(window or 0)
    if w < 0:
        raise ValueError(f"window must be positive, got {window}")
    return w


def band_mask(S: int, T: int, *, causal: bool, window=None, device=None):
    """[S, T] bool: key t is visible to query s (positions from 0):
    s >= t when causal, and s - t < window under a window."""
    if not causal:
        return torch.ones((S, T), dtype=torch.bool, device=device)
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = qpos >= kpos
    if _window(window):
        mask = mask & (qpos - kpos < window)
    return mask


def kernel_head_dim(D: int) -> int:
    """The head dim the kernels run a head dim D at: D where they are
    compiled for it, else the next of KERNEL_HEAD_DIMS (D zero-padded);
    above 256, D rounded up to a multiple of WIDE_MULTIPLE (the wide
    kernels)."""
    for dk in KERNEL_HEAD_DIMS:
        if D <= dk:
            return dk
    return -(-D // WIDE_MULTIPLE) * WIDE_MULTIPLE


def _wide(D: int) -> bool:
    """Whether a launch at kernel head dim D runs the wide kernels."""
    return D > KERNEL_HEAD_DIMS[-1]


def on_kernel_head_dim(fn, heads, n_out: int):
    """``fn(*heads, scale=D ** -0.5)`` at the kernels' head dim: `heads`
    are the [..., D] inputs (q, k, v, and out / dO in the backward),
    zero-padded along D to ``kernel_head_dim(D)`` where that is larger;
    the first `n_out` outputs of fn, [..., Dk], are sliced back to D. The
    scale stays that of the true D. Exact: zero columns add nothing to any
    q.k or dO.v and give zero output columns (the tests run it on the
    plain versions)."""
    D = heads[0].shape[-1]
    dk = kernel_head_dim(D)
    if dk != D:
        heads = [F.pad(t, (0, dk - D)) for t in heads]
    outs = fn(*heads, scale=D ** -0.5)
    if dk == D:
        return outs
    return tuple(o[..., :D].contiguous() if i < n_out else o
                 for i, o in enumerate(outs))


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None):
    """Plain version: einsum attention with f32 scores (the math of
    ``llama._attention_xla``, band mask included), scaled by 1/sqrt(D)
    unless `scale` is given. Returns (out in q.dtype, lse [B, H, S])."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    groups = H // KV
    qg = q.reshape(B, S, KV, groups, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = (scores / (D ** 0.5) if scale is None
              else scores * scale)
    if causal:
        mask = band_mask(S, T, causal=True, window=window, device=q.device)
        scores = torch.where(mask, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1).reshape(B, H, S)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D), lse


def _bwd_terms(q, k, v, out, lse, g, causal, window, scale=None):
    """The f32 intermediates of the backward, with keys last:
    (q5, g5, kf, vf, p, ds) with p, ds [B, S, KV, G, T]."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    groups = H // KV
    scale = D ** -0.5 if scale is None else scale
    q5 = q.float().reshape(B, S, KV, groups, D)
    g5 = g.float().reshape(B, S, KV, groups, D)
    kf, vf = k.float(), v.float()
    delta5 = (out.float() * g.float()).sum(-1).reshape(B, S, KV, groups)
    lse5 = lse.float().transpose(1, 2).reshape(B, S, KV, groups)
    s = torch.einsum("bskgd,btkd->bskgt", q5, kf) * scale
    if causal:
        mask = band_mask(S, T, causal=True, window=window, device=q.device)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.exp(s - lse5[..., None])
    dp = torch.einsum("bskgd,btkd->bskgt", g5, vf)
    ds = p * (dp - delta5[..., None]) * scale
    return q5, g5, kf, vf, p, ds


def flash_attention_bwd_reference(q, k, v, out, lse, g, *,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None):
    """Plain backward, the math of ``_reference_chunked_bwd`` in one chunk:
    delta = rowsum(O * dO) in f32, P recomputed from the saved LSE,
    dS = P * (dP - delta) * scale (1/sqrt(D) unless given), GQA groups
    summed. Returns (dq in q.dtype, dk in k.dtype, dv in v.dtype)."""
    B, S, H, D = q.shape
    q5, g5, kf, _, p, ds = _bwd_terms(q, k, v, out, lse, g, causal, window,
                                      scale)
    dv = torch.einsum("bskgt,bskgd->btkd", p, g5)
    dq = torch.einsum("bskgt,btkd->bskgd", ds, kf)
    dk = torch.einsum("bskgt,bskgd->btkd", ds, q5)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def kernel_tolerance(q, k, v, plain_out, *, causal: bool = True,
                     window: Optional[int] = None):
    """Elementwise bound on |kernel - plain| for the forward, where
    plain_out is ``flash_attention_reference``'s output with its products
    accumulated in f32. f32: 1e-4 (both sum in f32, in another order).
    bf16: each side rounds its probabilities to bf16 before p.v, which
    moves o by at most 2^-8 * A with A = sum_t P[s, t] |v[t]| (the
    attention of |v|), and rounds o once (half an ulp, 2^-8 |o|); so the
    two differ by at most 2^-7 * (A + |plain|), plus 1e-5 for the order of
    the f32 sums."""
    if q.dtype == torch.float32:
        return torch.full(plain_out.shape, 1e-4, device=plain_out.device)
    a, _ = flash_attention_reference(q.float(), k.float(), v.float().abs(),
                                     causal=causal, window=window)
    return 2.0 ** -7 * (a + plain_out.float().abs()) + 1e-5


def grad_tolerance(q, k, v, out, lse, g, plain, *, causal: bool = True,
                   window: Optional[int] = None):
    """Elementwise bounds (tol_dq, tol_dk, tol_dv) on |kernel - plain| for
    the backward, where plain = ``flash_attention_bwd_reference``'s
    (dq, dk, dv) on the same inputs (exact f32 math from the inputs as
    stored).

    Derivation. Let e = 2^-24 (f32 unit roundoff), u the unit roundoff of
    what the kernel feeds its tensor-core products (bf16 path: u = 2^-8,
    since it rounds P and dS to bf16; f32 path: exact FMAs, u = 0), u_out
    that of the output type (2^-8 for bf16, e for f32), L = max(S, T).

    - Scores s = q.k scale are D-long f32 sums taken in another order on
      the two sides: |ds| <= D 2e scale (|q|.|k|). P = exp(s - lse) uses
      the same lse on both sides, so P moves by P rel with
      rel = D 2e scale (|q|.|k|) + 4e (4e for the two exps).
    - dP = dO.V and delta = rowsum(O dO) are D-long f32 sums as well: dS =
      P (dP - delta) scale moves by |dS| rel + E with E = P scale D 2e
      (|dO|.|V| + rowsum|O dO|).
    - The bf16 kernel rounds P (for dV) and dS (for dK, dQ): u P, u |dS|.
    - dV = sum_s P dO, dK = sum_s dS Q, dQ = sum_t dS K sum up to L
      products in another order: L e times the sum of their magnitudes.
    - Each side rounds its output once: u_out |x| each.

    So tol_dv = sum_s P (u + rel + L e) |dO| + 2 u_out |plain_dv|,
    tol_dk = sum_s (|dS| (u + rel + L e) + E) |Q| + 2 u_out |plain_dk|,
    tol_dq = sum_t (|dS| (u + rel + L e) + E) |K| + 2 u_out |plain_dq|;
    each is doubled (the terms are first order, exact to a factor
    1 + O(u)), and 1e-6 is added for results that round to 0."""
    B, S, H, D = q.shape
    T = k.shape[1]
    low = q.dtype != torch.float32
    e = 2.0 ** -24
    u = 2.0 ** -8 if low else 0.0
    u_out = 2.0 ** -8 if low else e
    scale = D ** -0.5
    q5, g5, kf, vf, p, ds = _bwd_terms(q, k, v, out, lse, g, causal, window)
    groups = q5.shape[3]
    aq5, ag5, akf, avf = q5.abs(), g5.abs(), kf.abs(), vf.abs()
    rel = (D * 2 * e * scale
           * torch.einsum("bskgd,btkd->bskgt", aq5, akf) + 4 * e
           + u + max(S, T) * e)
    rowsum = (out.float() * g.float()).abs().sum(-1).reshape(
        B, S, -1, groups)
    err_ds = ds.abs() * rel + p * scale * D * 2 * e * (
        torch.einsum("bskgd,btkd->bskgt", ag5, avf) + rowsum[..., None])
    tol_dv = torch.einsum("bskgt,bskgd->btkd", p * rel, ag5)
    tol_dk = torch.einsum("bskgt,bskgd->btkd", err_ds, aq5)
    tol_dq = torch.einsum("bskgt,btkd->bskgd", err_ds, akf).reshape(
        B, S, H, D)
    dq_p, dk_p, dv_p = (x.float().abs() for x in plain)
    return (2 * (tol_dq + 2 * u_out * dq_p) + 1e-6,
            2 * (tol_dk + 2 * u_out * dk_p) + 1e-6,
            2 * (tol_dv + 2 * u_out * dv_p) + 1e-6)


def _lib(name: str):
    lib = _build.load(name)
    P, I = ctypes.c_void_p, ctypes.c_int

    def launch(n_ptr):
        return [I, I, I] + [P] * n_ptr + [I] * 6 + [ctypes.c_float, P]

    # the forward's library holds the first entry point, the backward's
    # the other three
    for fn_name, argtypes in (("flash_attention_fwd", launch(5)),
                              ("flash_attention_bwd_dq", launch(8)),
                              ("flash_attention_bwd_dkdv", launch(8)),
                              ("flash_attention_bwd_small_splits", [I] * 8)):
        fn = getattr(lib, fn_name, None)
        if fn is None or fn.argtypes is not None:
            continue
        fn.argtypes = argtypes
        fn.restype = I
    return lib


def _check(what, q, k, v, *rest):
    """Device, dtype, shape and head-dim checks of a kernel launch."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if any(t.device != q.device for t in (k, v, *rest)):
        raise ValueError(f"{what}: all tensors must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (k.shape != (B, T, KV, D) or v.shape != k.shape or KV == 0
            or H % KV or T == 0 or D == 0):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")


def _aligned(*ts):
    """Contiguous copies where needed; the kernels load 16-byte vectors
    (and TMA maps need 16-byte aligned bases)."""
    ts = [t.contiguous() for t in ts]
    return [t.clone() if t.data_ptr() % 16 else t for t in ts]


def _fwd_launch(q, k, v, causal, w, *, scale):
    """K1 (K2 under a window) at a kernel head dim."""
    global launches, launches_window, launches_wide, launches_wide_window
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], int(causal), w, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S, T, H, KV, D,
            scale, stream)
    _build.check(lib, rc, "flash_attention_fwd")
    if _wide(D):
        if w:
            launches_wide_window += 1
        else:
            launches_wide += 1
    elif w:
        launches_window += 1
    else:
        launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q [B,S,H,D], k/v [B,T,KV,D] -> (out [B,S,H,D] in q.dtype,
    lse [B,H,S] f32). CUDA tensors launch the kernel (K1, or K2 under a
    window) at ``kernel_head_dim(D)``; CPU tensors take the plain
    version."""
    _build.reject_dtensor("flash_attention_fwd", q, k, v)
    w = _window(window)
    if w and not causal:
        raise ValueError("window= requires causal=True")
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal, window=w)
    _check("flash_attention", q, k, v)
    return on_kernel_head_dim(
        lambda q, k, v, scale: _fwd_launch(q, k, v, causal, w, scale=scale),
        (q, k, v), n_out=1)


def _bwd_inputs(what, q, k, v, out, lse, g):
    _check(what, q, k, v, out, lse, g)
    B, S, H, _ = q.shape
    if out.shape != q.shape or g.shape != q.shape or \
            lse.shape != (B, H, S):
        raise ValueError(f"{what}: bad shapes out {tuple(out.shape)} g "
                         f"{tuple(g.shape)} lse {tuple(lse.shape)}")
    q, k, v, out, g, lse = _aligned(q, k, v, out, g.to(q.dtype), lse.float())
    return q, k, v, out, lse, g


def _dq_launch(q, k, v, out, g, lse, causal, w, *, scale):
    """K3 at a kernel head dim: (dq, delta)."""
    global launches_dq, launches_dq_wide
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_dq(
            _DTYPES[q.dtype], int(causal), w, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), delta.data_ptr(), B, S, T, H, KV, D, scale,
            stream)
    _build.check(lib, rc, "flash_attention_bwd_dq")
    if _wide(D):
        launches_dq_wide += 1
    else:
        launches_dq += 1
    return dq, delta


def _dkdv_launch(q, k, v, g, lse, delta, causal, w, *, scale):
    """K4 at a kernel head dim, from K3's delta: (dk, dv)."""
    global launches_dkdv, launches_dkdv_wide
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_dkdv(
            _DTYPES[q.dtype], int(causal), w, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, H, KV, D, scale, stream)
    _build.check(lib, rc, "flash_attention_bwd_dkdv")
    if _wide(D):
        launches_dkdv_wide += 1
    else:
        launches_dkdv += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, out, lse, g, *, causal: bool = True,
                           window: Optional[int] = None):
    """K3 on CUDA tensors: (dq in q.dtype, delta = rowsum(out * g) f32
    [B, H, S], which K4 reads)."""
    _build.reject_dtensor("flash_attention_bwd_dq", q, k, v, out, lse, g)
    w = _window(window)
    q, k, v, out, lse, g = _bwd_inputs("flash_attention_bwd_dq", q, k, v,
                                       out, lse, g)
    return on_kernel_head_dim(
        lambda q, k, v, out, g, scale: _dq_launch(
            q, k, v, out, g, lse, causal, w, scale=scale),
        (q, k, v, out, g), n_out=1)


def flash_attention_bwd_dkdv(q, k, v, lse, g, delta, *, causal: bool = True,
                             window: Optional[int] = None):
    """K4 on CUDA tensors, from K3's delta: (dk, dv) in k.dtype."""
    _build.reject_dtensor("flash_attention_bwd_dkdv", q, k, v, lse, g, delta)
    w = _window(window)
    q, k, v, _, lse, g = _bwd_inputs("flash_attention_bwd_dkdv", q, k, v,
                                     q, lse, g)
    B, S, H, D = q.shape
    if delta.shape != (B, H, S) or delta.dtype != torch.float32 or \
            delta.device != q.device:
        raise ValueError("flash_attention_bwd_dkdv: delta must be f32 "
                         "[B, H, S] on the inputs' device")
    delta, = _aligned(delta)
    return on_kernel_head_dim(
        lambda q, k, v, g, scale: _dkdv_launch(
            q, k, v, g, lse, delta, causal, w, scale=scale),
        (q, k, v, g), n_out=2)


def bwd_cluster_sizes(B: int, S: int, T: int, H: int, KV: int, *,
                      causal: bool = True,
                      window: Optional[int] = None) -> tuple:
    """(K3's, K4's) blocks a thread block cluster at this shape, as the bf16
    kernels at kernel head dims 16 and 32 pick them on the current card
    (from the heaviest block's chain and the grid; 1: no cluster)."""
    lib = _lib("flash_attention_bwd")
    w = _window(window)
    return tuple(lib.flash_attention_bwd_small_splits(
        which, int(causal), w, B, S, T, H, KV) for which in (0, 1))


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients (dq in q.dtype, dk/dv in k.dtype) of flash attention for
    the output cotangent g [B,S,H,D], from the forward's out and lse. CUDA
    tensors launch K3 (dQ, and delta = rowsum(out * g) for K4) then K4
    (dK/dV) at ``kernel_head_dim(D)``; CPU tensors take the plain
    version."""
    _build.reject_dtensor("flash_attention_bwd", q, k, v, out, lse, g)
    w = _window(window)
    if w and not causal:
        raise ValueError("window= requires causal=True")
    if not q.is_cuda:
        return flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=w)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, g, causal=causal,
                                       window=w)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, g, delta, causal=causal,
                                      window=w)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """``_flash``'s custom_vjp: the forward saves (q, k, v, out, lse); the
    backward recomputes P from lse (K3/K4 on CUDA, the plain backward on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q [B,S,H,D], k/v [B,T,KV,D] -> [B,S,H,D] in q.dtype, differentiable
    in q, k and v. Query and key positions both start at 0 (causal keeps
    key t for query s iff s >= t); window=W (causal only) keeps only the
    last W keys, s - t < W (Mistral-style sliding window)."""
    _build.reject_dtensor("flash_attention", q, k, v)
    return _Flash.apply(q, k, v, causal, _window(window))
