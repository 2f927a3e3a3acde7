"""Ring attention: sequence-parallel causal attention over the 'sp' mesh axis.

Port of ``ray_tpu/ops/ring_attention.py``. Each rank holds a contiguous
sequence chunk of Q, K, V; the K/V chunks rotate around the ring of the
sp axis (``parallel.spmd.ppermute``, P2P send/recv) while every rank
accumulates its chunk's attention with the online-softmax recurrence.
After sp steps every Q has attended to every K/V at O(S/sp) activation
memory per rank.

Called on this rank's chunks, with the axis the chunks are laid over:

    out = ring_attention(q, k, v, axis=spmd.Axis.of(mesh, "sp"))

Causality across chunks: chunk i attends fully to chunks j < i, causally to
its own chunk, not at all to j > i; the mask of each rotation step comes
from the global chunk offsets, so the result is full causal attention.

Differentiable: the recurrence is torch ops and ``spmd.ppermute``, whose
backward is the inverse rotation, so autograd runs the ring backward (each
rank builds the same graph, so the exchanges of the backward pair up).

The block attention is plain torch, as JAX computes it with ``jnp``
einsums outside any Pallas kernel. It keeps the reference's dtype flow: q
in f32, each K chunk cast to q's dtype, the scores in f32, the
probabilities cast to v's dtype and the p.v products summed in f32 (JAX's
``preferred_element_type``). The ring skips the reference's last rotation,
whose result its scan discards.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel import spmd

NEG_INF = -1e30


def _block_attn(q, k, v, mask):
    """One (q-chunk x kv-chunk) block. q [B,S,KV,G,D]; k/v [B,T,KV,D].
    Returns unnormalized o plus (m, l) for the online-softmax merge."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgd,btkd->bskgt", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    # all-masked rows: keep m finite so exp() underflows to 0 cleanly
    m = torch.clamp(m, min=-1e29)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype).float(), v.float())
    return o, m, l


def ring_attention(q, k, v, axis: spmd.Axis = None, causal: bool = True):
    """q [B,Sc,H,D], k/v [B,Sc,KV,D]: this rank's chunk Sc of the sequence
    laid over `axis` (default: a 1-rank axis, the whole sequence here)."""
    axis = axis or spmd.Axis.local()
    B, Sc, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    sp, my = axis.size, axis.index

    q5 = q.reshape(B, Sc, KV, G, D).float()
    pos = torch.arange(Sc, device=q.device)

    def mask_for(kv_chunk_idx):
        if not causal:
            return torch.ones((1, Sc, 1, 1, Sc), dtype=torch.bool,
                              device=q.device)
        # global positions: q at my*Sc + i, k at kv_chunk_idx*Sc + j
        qg = my * Sc + pos
        kg = kv_chunk_idx * Sc + pos
        return (qg[:, None] >= kg[None, :])[None, :, None, None, :]

    o = torch.zeros((B, Sc, KV, G, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sc, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sc, KV, G), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    kk, vv = k, v
    for step in range(sp):
        # after `step` rotations this rank holds the chunk of rank my - step
        src = (my - step) % sp
        bo, bm, bl = _block_attn(q5, kk.to(q.dtype), vv, mask_for(src))
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = l * alpha + bl * beta
        o = o * alpha[..., None] + bo * beta[..., None]
        m = m_new
        if step + 1 < sp:
            # rotate kv to the next rank on the ring
            kk = spmd.ppermute(kk, perm, axis)
            vv = spmd.ppermute(vv, perm, axis)
    l = torch.clamp(l, min=1e-30)
    out = (o / l[..., None]).reshape(B, Sc, H, D)
    return out.to(q.dtype)
