"""Ulysses sequence parallelism: head-sharded all-to-all attention.

Port of ``ray_tpu/ops/ulysses.py`` (DeepSpeed Ulysses, Jacobs et al.
2023). Where ring attention keeps the sequence sharded and rotates K/V
around the ring (sp exchanges), Ulysses does ONE all-to-all each way:
scatter heads / gather sequence, run full-sequence attention on H/sp local
heads, then invert. Its traffic is O(S·D·H/sp) per rank whatever sp is,
so it beats the ring when the head count divides over the axis and the
full-S attention fits in memory; the ring wins at extreme S. Both run over
the same 'sp' axis.

Called on this rank's chunks, with the axis the chunks are laid over:

    out = ulysses_attention(q, k, v, axis=spmd.Axis.of(mesh, "sp"))

Constraints: n_heads % sp == 0 and n_kv_heads % sp == 0 (contiguous head
blocks keep GQA groups rank-local; the group ratio G = H/KV is kept
because H/sp = G·(KV/sp)).

Differentiable: ``spmd.all_to_all``'s backward is the inverse exchange.
The per-rank attention is plain torch, as JAX computes it with ``jnp``
einsums outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel import spmd


def _full_attention(q, k, v, causal: bool):
    """Reference einsum attention with GQA broadcast (the per-rank compute
    after the exchange; mirrors models/llama.py _attention_xla, duplicated
    here so ops does not import models)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    groups = H // KV
    q = q.reshape(B, S, KV, groups, D)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k.float()) / (D ** 0.5)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)


def ulysses_attention(q, k, v, axis: spmd.Axis = None, causal: bool = True):
    """q [B, Sc, H, D], k/v [B, Sc, KV, D]: this rank's chunk Sc of the
    sequence laid over `axis` (default: a 1-rank axis). Positions (RoPE)
    must already be applied with global offsets, exactly as the ring path
    does."""
    axis = axis or spmd.Axis.local()
    sp = axis.size
    H, KV = q.shape[2], k.shape[2]
    if H % sp or KV % sp:
        raise ValueError(
            f"ulysses needs heads divisible by the sp axis: "
            f"H={H}, KV={KV}, sp={sp} (use ring attention instead)")

    def scatter_heads(x):
        # [B, Sc, N, D] -> [B, Sc*sp, N/sp, D]: each rank receives every
        # rank's chunk for its head block (one all-to-all)
        return spmd.all_to_all(x, split_dim=2, concat_dim=1, axis=axis)

    qg = scatter_heads(q)
    kg = scatter_heads(k)
    vg = scatter_heads(v)
    out = _full_attention(qg, kg, vg, causal)
    # inverse exchange: split seq back out, gather this rank's heads
    return spmd.all_to_all(out, split_dim=1, concat_dim=2, axis=axis)
