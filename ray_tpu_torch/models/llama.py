"""Llama-family transformer (RMSNorm + RoPE + GQA + SwiGLU) in PyTorch.

Port of ``ray_tpu/models/llama.py``, function for function, for three
paths:

- paged serving: ``prefill`` -> ``scatter_prefill_pages`` ->
  ``decode_step_paged`` (fused paged decode kernel K6 on every layer) and
  ``prefill_paged_tail`` for prefix-cache hits and chunked prefill;
- contiguous serving: ``prefill`` into a ``KVCache`` row per slot ->
  ``decode_step`` (per-row positions, the ``active`` mask, the sliding
  window band), ``prefill_tail_contiguous`` for chunked prefill and
  ``forward_with_cache``;
- training: ``loss_fn`` -> ``forward``, each layer under
  ``torch.utils.checkpoint`` when ``cfg.remat`` (the JAX
  ``jax.checkpoint``), run by ``parallel/train_step.py``.

``attn_impl="flash"`` sends sequences of at least 128 tokens that start at
position 0 to the flash kernels: the forward K1 (K2 under
``sliding_window``) and, in training, the backward K3/K4 through
``ops.flash_attention``'s autograd Function.

Weights may be int8 (``quantize_params_int8``, for serving): each matmul
weight becomes ``{"q8": int8, "s8": bf16 per-output-channel scale}`` and
every layer loop dequantizes one weight at its use (``_dq``). Eager
PyTorch writes that bf16 copy to device memory, where XLA fused the
convert into the dot.

PyTorch idiom, JAX layouts: plain functions on tensors; parameters are the
JAX pytree as a dict of tensors, matmul weights ``[in, out]`` (``h @ w``),
stacked ``[L, ...]`` per layer as in ``param_specs``; a Python loop over
layers replaces ``lax.scan``; the paged KV pools ``[L, KV, NP, ps, HD]``
(page 0 = trash page) and the contiguous cache ``[L, B, max_seq, KV, HD]``
are updated IN PLACE where the JAX version donates them to ``jax.jit``.
``params_from_jax`` turns the JAX param tree (as numpy) into these
tensors, so the weights cross over by plain copy.

Sharded (``mesh=``/``rules=``, params as DTensors placed by
``param_specs`` and the rules): ``forward``/``loss_fn`` compute each rank's
batch rows on local tensors. Every weight is gathered at its use over the
data axes (all-gather forward, reduce-scatter or all-reduce of its
gradient backward, through DTensor's ``redistribute``); the ``tp`` axis
splits attention and the MLP Megatron-style (local heads, column- and
row-parallel matmuls, ``parallel.sharding``'s f and g all-reduces). Rules
that lay seq over sp (``ShardingRules.full()``) split the sequence too:
each rank computes its chunk, and flash or xla attention gathers the
chunks' k and v (and q for flash) over sp. The serving functions take
sharded params too and gather each weight whole at its use.

Sequence parallel (``forward_sp``): each sp rank runs ``forward`` on its
chunk of the sequence, RoPE at its global offset, and attention is ring
(``ops/ring_attention.py``) or Ulysses (``ops/ulysses.py``) over the sp
axis; each rank's weight gradients are a part, summed over sp with the data
axes'. Pipeline parallel (``forward_pp``): embedding and head on every
stage, the layers split into pp stages of ``parallel/pipeline.py``'s trunk
(``cfg.pp_schedule``: "gpipe" or "1f1b"); a stage with flash at S >= 128
runs K1 and, in its backward, K3/K4.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import is_dtensor


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16        # activation/compute dtype
    param_dtype: Any = torch.float32   # master weights
    attn_impl: str = "xla"             # "xla" | "flash" | "ring" | "ulysses"
    # Mistral-style sliding window: each query sees only the last
    # `sliding_window` keys (None = full causal); flash runs K2, which never
    # loads K/V tiles outside the band. The paged path rejects it (as in JAX)
    sliding_window: Any = None
    remat: bool = True                 # checkpoint each layer in forward
    # what the per-layer checkpoint keeps: "none" (recompute the whole
    # layer) or "dots" (keep the outputs of the projection matmuls,
    # aten.mm, recompute the rest: jax's dots_with_no_batch_dims_saveable)
    remat_policy: str = "none"
    # one [D, (H+2KV)*HD] matmul (and one [D, 2F]) instead of three (two)
    fused_matmuls: bool = False
    # [B, S, vocab] logits in f32, or kept in the compute dtype (loss_fn
    # takes its logsumexp in f32 either way)
    f32_logits: bool = True
    # forward_pp's schedule: "gpipe" | "1f1b" (parallel/pipeline.py)
    pp_schedule: str = "gpipe"
    # accepted for the JAX config's sake: the port's only layer loop is a
    # Python loop over the stacked [L, ...] params (JAX's scan_layers=False
    # form); lax.scan has no eager counterpart
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


# Size presets (BASELINE.md target configs), the same shapes as ray_tpu.
PRESETS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=128, max_seq_len=128),
    "debug-125m": LlamaConfig(vocab_size=32000, d_model=768, n_layers=12,
                              n_heads=12, n_kv_heads=12, d_ff=2048,
                              max_seq_len=1024),
    "1b": LlamaConfig(vocab_size=32000, d_model=2048, n_layers=16,
                      n_heads=16, n_kv_heads=8, d_ff=5632, max_seq_len=2048),
    "2b7": LlamaConfig(vocab_size=32000, d_model=2560, n_layers=32,
                       n_heads=20, n_kv_heads=20, d_ff=6912,
                       max_seq_len=2048),
    "7b": LlamaConfig(),  # llama-2 7B shapes
    "70b": LlamaConfig(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                       d_ff=28672, vocab_size=32000, max_seq_len=4096),
}


def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (the JAX package's sharding
    vocabulary; kept so the layouts stay documented side by side)."""
    L = ("layers",)
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": L + ("embed_nr",),
            "wq": L + ("embed", "heads"),
            "wk": L + ("embed", "kv_heads"),
            "wv": L + ("embed", "kv_heads"),
            "wo": L + ("heads", "embed"),
            "ffn_norm": L + ("embed_nr",),
            "w_gate": L + ("embed", "mlp"),
            "w_up": L + ("embed", "mlp"),
            "w_down": L + ("mlp", "embed"),
        },
        "final_norm": ("embed_nr",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                leaf=None) -> Dict[str, Any]:
    """Random weights on the generator's device, in cfg.param_dtype: the
    JAX shapes and scales (normal / sqrt(fan_in), embed * 0.02). The
    numbers differ from those jax.random draws; tests share weights through
    params_from_jax instead. ``leaf(path, tensor)``, where given, replaces
    each leaf as soon as it is drawn, before the next one is
    (``init_params_int8`` quantizes there)."""
    return draw_params(generator, init_specs(cfg), cfg.param_dtype, leaf)


def init_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """(shape, std) of every leaf, in the order init_params draws them;
    std None: ones (norms)."""
    L, D, H, KV, HD, Fd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                              cfg.vocab_size)
    return {
        "embed": ((V, D), 0.02),
        "layers": {
            "attn_norm": ((L, D), None),
            "wq": ((L, D, H * HD), D ** -0.5),
            "wk": ((L, D, KV * HD), D ** -0.5),
            "wv": ((L, D, KV * HD), D ** -0.5),
            "wo": ((L, H * HD, D), (H * HD) ** -0.5),
            "ffn_norm": ((L, D), None),
            "w_gate": ((L, D, Fd), D ** -0.5),
            "w_up": ((L, D, Fd), D ** -0.5),
            "w_down": ((L, Fd, D), Fd ** -0.5),
        },
        "final_norm": ((D,), None),
        "lm_head": ((D, V), D ** -0.5),
    }


def draw_params(generator: torch.Generator, specs, dtype,
                leaf=None) -> Dict[str, Any]:
    """A tree of tensors drawn from `specs` (nested dicts of (shape, std);
    std None: ones, 0.0: zeros, else normal(0, std)) on the generator's
    device, leaf by leaf in the specs' order; ``leaf(path, tensor)``, where
    given, replaces each leaf as soon as it is drawn."""
    dev = generator.device

    def make(path, spec):
        if isinstance(spec, dict):
            return {k: make(path + (k,), s) for k, s in spec.items()}
        shape, std = spec
        if std is None:
            w = torch.ones(shape, dtype=dtype, device=dev)
        elif std == 0.0:
            w = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            w = torch.empty(shape, dtype=dtype, device=dev).normal_(
                0.0, std, generator=generator)
        return leaf(path, w) if leaf else w

    return make((), specs)


def init_params_int8(generator: torch.Generator, cfg: LlamaConfig,
                     device=None, place=None) -> Dict[str, Any]:
    """``quantize_params_int8(init_params(generator, cfg), device)`` made
    leaf by leaf: each leaf is drawn on the generator's device and
    quantized onto `device` before the next one is drawn, so the float
    tree never exists whole on either device. The same tree bit for bit:
    the draws are init_params' own, and the quantization gives the same
    bits on the CPU and on the card. ``place(path, w)``, where given,
    shards each leaf (a DTensor of this rank's block) before it is
    quantized."""

    def leaf(path, w):
        if place is not None:
            w = place(path, w)
        tree = w
        for k in reversed(path):
            tree = {k: tree}
        tree = quantize_params_int8(tree, device)
        for k in path:
            tree = tree[k]
        return tree

    return init_params(generator, cfg, leaf)


def num_params(cfg: LlamaConfig) -> int:
    D, H, KV, HD, Fd, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.n_layers,
                              cfg.vocab_size)
    per_layer = 2 * D + D * H * HD + 2 * D * KV * HD + H * HD * D + 3 * D * Fd
    return V * D + L * per_layer + D + D * V


def params_from_jax(tree, device, dtype: Optional[torch.dtype] = None):
    """The JAX param pytree (nested dicts of arrays; numpy or anything
    np.asarray takes) -> the same dict of tensors on `device`, floating
    leaves cast to `dtype` when given (integer leaves, such as int8
    weights' ``q8``, stay integer). Layouts are identical, so this is a
    plain copy."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    to = dtype
    if a.dtype.name == "bfloat16":       # ml_dtypes: no torch counterpart
        a = a.astype(np.float32)
        to = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(a, copy=True))
    if not t.is_floating_point():
        to = None
    return t.to(device=device, dtype=to or t.dtype)


# --- building blocks --------------------------------------------------------


def _is_q8(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def quantize_params_int8(params, device=None) -> Dict[str, Any]:
    """Weight-only per-output-channel int8 quantization for serving (int8
    is not differentiable; training never sees it). Matmul weights (embed,
    lm_head, the per-layer projections) become {"q8": int8, "s8": bf16
    scale}, with s8 [1, D] for embed, [1, V] for lm_head and [L, 1, N] for
    layer weights; norms stay float. Idempotent: quantized leaves pass
    through. The scale is max |w| / 127 over the input axes, in f32; q8 =
    round(w / s) (half to even, as jnp.round) clipped to [-127, 127], so
    the tree equals the JAX one bit for bit. The result lies on `device`
    (default: each leaf's own). Each 2-D weight (embed, lm_head, one layer
    of a layer weight) is quantized in place in its own f32 copy on
    `device`, which bounds the float transient there to that copy."""

    def move(w):
        return w if device is None or is_dtensor(w) else w.to(device)

    def quant_one(w, groups=()):
        # a private f32 copy of a 2-D weight on `device`, quantized in
        # place: the transient is that copy alone
        f = w.to(device=device or w.device, dtype=torch.float32, copy=True)
        lo, hi = torch.aminmax(f, dim=0, keepdim=True)
        m = torch.maximum(hi, -lo)   # max |w| over the input axis
        for g in groups:             # ... over its shards on other ranks
            torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                         group=g)
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # product with its reciprocal, which may differ in the last bit
        s = m / torch.full_like(m, 127.0)
        s = torch.clamp(s, min=1e-8)
        q = f.div_(s).round_().clamp_(-127, 127).to(torch.int8)
        return q, s.to(torch.bfloat16)

    def quant_local(w, keep_first: bool, groups=()):
        if not keep_first:
            q, s = quant_one(w, groups)
            return q, s
        dev = w.device if device is None else device
        q = torch.empty(w.shape, dtype=torch.int8, device=dev)
        s = torch.empty((w.shape[0], 1, w.shape[-1]), dtype=torch.bfloat16,
                        device=dev)
        for i in range(w.shape[0]):
            q[i], s[i] = quant_one(w[i], groups)
        return q, s

    def quant(w, keep_first: bool):
        if _is_q8(w):
            return {k: move(x) for k, x in w.items()}
        if w.ndim < 2 or not w.is_floating_point():
            return move(w)
        if not is_dtensor(w):
            q, s = quant_local(w, keep_first)
            return {"q8": q, "s8": s}
        # a sharded weight: quantize this rank's block, the max taken over
        # the input axis' shards on the ranks that share its columns
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from ray_tpu_torch.parallel.sharding import contiguous_stride

        in_dim = 1 if keep_first else 0
        names = w.device_mesh.mesh_dim_names
        groups = [w.device_mesh.get_group(names[i])
                  for i, p in enumerate(w.placements) if p == Shard(in_dim)]
        q, s = quant_local(w.to_local(), keep_first, groups)
        s_pl = [Replicate() if p == Shard(in_dim) else p
                for p in w.placements]
        s_shape = w.shape[:in_dim] + (1,) + w.shape[in_dim + 1:]
        return {"q8": DTensor.from_local(q, w.device_mesh, w.placements,
                                         shape=w.shape, stride=w.stride()),
                "s8": DTensor.from_local(s, w.device_mesh, s_pl,
                                         shape=s_shape,
                                         stride=contiguous_stride(s_shape))}

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {kk: (move(vv) if kk.endswith("norm")
                           else quant(vv, keep_first=True))
                      for kk, vv in v.items()}
        elif k in ("embed", "lm_head"):
            out[k] = quant(v, keep_first=False)
        else:
            out[k] = move(v)
    return out


def _whole(w):
    """A param leaf as a whole local tensor: a DTensor (a sharded param)
    is gathered here, at its use; a plain tensor passes."""
    if is_dtensor(w):
        from ray_tpu_torch.parallel.sharding import gathered

        return gathered(w)
    return w


def _dq(w, dt):
    """One weight in the compute dtype; int8 leaves dequantize here, at
    their use (a bf16 copy on the card, where XLA fused the convert into
    the consuming dot). Sharded leaves are gathered whole first."""
    if _is_q8(w):
        return _whole(w["q8"]).to(dt) * _whole(w["s8"]).to(dt)
    return _whole(w).to(dt)


def _unbind(v):
    """A stacked [L, ...] leaf (or {"q8", "s8"} pair) as L per-layer
    views. A DTensor that every rank holds whole and that takes no
    gradient (serving) is unbound as its local tensor."""
    if isinstance(v, dict):
        cols = {k: _unbind(x) for k, x in v.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    if is_dtensor(v) and not v.requires_grad:
        from torch.distributed.tensor import Replicate

        if all(isinstance(p, Replicate) for p in v.placements):
            v = v.to_local()
    return v.unbind(0)


def _unstack_layers(layers: Dict[str, Any]):
    """The stacked [L, ...] params as L per-layer dicts of views. One
    ``unbind`` a tensor: its backward stacks the L gradients once, where L
    ``v[i]`` selects would each scatter into a full-size zero tensor."""
    cols = {k: _unbind(v) for k, v in layers.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _save_mm(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(body, cfg: "LlamaConfig"):
    """body under a non-reentrant checkpoint: "none" recomputes the whole
    layer in the backward; "dots" keeps the outputs of aten.mm (the
    projections of [B*S, D] activations, no batch dims) and recomputes the
    rest."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    if cfg.remat_policy == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_mm)
        return lambda *a: checkpoint(body, *a, use_reentrant=False,
                                     context_fn=ctx_fn)
    if cfg.remat_policy != "none":
        raise ValueError(
            f"remat_policy must be 'none' or 'dots', got "
            f"{cfg.remat_policy!r}")
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def _embed(params, tokens, dt):
    """Embedding lookup: gather the rows, then cast or dequantize only
    them (never the whole [V, D] table)."""
    w = params["embed"]
    if _is_q8(w):
        return (_whole(w["q8"])[tokens.long()].to(dt)
                * _whole(w["s8"]).to(dt))
    return _whole(w)[tokens.long()].to(dt)


def rms_norm(x, scale, eps):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * _whole(scale).to(
        x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_tables_cached(theta: float, seq_len: int, head_dim: int,
                        device: str):
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)                  # [S, HD/2]
    return torch.cos(angles), torch.sin(angles)


def _rope_tables(theta: float, seq_len: int, head_dim: int, device=None):
    """(cos, sin) [seq_len, head_dim/2] f32, cached per device (read-only;
    the JAX version is a jitted, inlined function)."""
    return _rope_tables_cached(float(theta), int(seq_len), int(head_dim),
                               str(torch.device(device or "cpu")))


def _rope_at(cfg: LlamaConfig, offset, S: int, device):
    """(cos, sin) [S, HD/2] of positions offset .. offset + S - 1, the
    start clamped to [0, max_seq_len - S] so the slice fits, as
    dynamic_slice_in_dim clamps it. `offset` is an int or a 0-d tensor
    (a sequence shard's offset), which is clamped on its device, with no
    host sync."""
    cos, sin = _rope_tables(cfg.rope_theta, cfg.max_seq_len, cfg.head_dim,
                            device)
    hi = cfg.max_seq_len - S
    if isinstance(offset, torch.Tensor):
        rows = (offset.to(device=cos.device, dtype=torch.long).clamp(0, hi)
                + torch.arange(S, device=cos.device))
        return cos[rows], sin[rows]
    st = max(0, min(int(offset), hi))
    return cos[st:st + S], sin[st:st + S]


def _rotate(x, c, s):
    """Half-split rotary (not interleaved), in f32, back to x.dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x, cos, sin):
    """x: [B, S, N, HD]; cos/sin: [S, HD/2] (already offset for decode)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _attention_xla(q, k, v, causal: bool, q_offset=0, window=None):
    """Plain einsum attention. q: [B, S, H, D], k/v: [B, T, KV, D]
    (GQA broadcast)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    groups = H // KV
    qg = q.reshape(B, S, KV, groups, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / (D ** 0.5)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + q_offset
        kpos = torch.arange(T, device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)


def _attention(q, k, v, cfg: LlamaConfig, causal=True, q_offset=0,
               sp=None):
    """sp: the ``parallel.spmd.Axis`` the sequence is laid over (None: a
    1-rank axis, the whole sequence here): ring and Ulysses exchange over
    it, and flash or xla attention gather the chunks (``_attention_seq``).
    """
    win = cfg.sliding_window
    if win is not None and cfg.attn_impl in ("ring", "ulysses"):
        # silently computing FULL attention here would train a different
        # model than the config describes
        raise ValueError(
            "sliding_window is not supported with ring/ulysses attention "
            "(the band would have to chase blocks around the ring); use "
            "attn_impl='flash' or 'xla' for windowed models")
    if sp is not None and sp.size > 1 and cfg.attn_impl not in ("ring",
                                                                 "ulysses"):
        return _attention_seq(q, k, v, cfg, sp)
    # flash builds positions from 0, so offset chunks take the xla path,
    # which honors q_offset
    at_origin = isinstance(q_offset, int) and q_offset == 0
    if cfg.attn_impl == "flash" and causal and q.shape[1] >= 128 \
            and at_origin:
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, window=win)
    if cfg.attn_impl == "ring":
        from ray_tpu_torch.ops.ring_attention import ring_attention

        return ring_attention(q, k, v, axis=sp)
    if cfg.attn_impl == "ulysses":
        from ray_tpu_torch.ops.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, axis=sp)
    return _attention_xla(q, k, v, causal, q_offset, window=win)


def _attention_seq(q, k, v, cfg: LlamaConfig, sp):
    """Causal attention of this rank's chunk of a sequence split over `sp`
    (chunk ``sp.index`` of S * sp.size tokens; q, k, v [B, S, heads, D],
    this rank's heads under tp), as the reference's GSPMD computes it: the
    route is chosen from the whole sequence's length. flash gathers q, k
    and v, runs the kernels over the whole sequence (they take no query
    offset) and keeps this rank's query rows; xla gathers k and v and
    attends the local queries at their global offset."""
    from ray_tpu_torch.parallel.spmd import all_gather

    S = q.shape[1]
    start = sp.index * S
    k, v = all_gather(k, 1, sp), all_gather(v, 1, sp)
    if cfg.attn_impl == "flash" and S * sp.size >= 128:
        from ray_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(all_gather(q, 1, sp), k, v, causal=True,
                              window=cfg.sliding_window)
        return out.narrow(1, start, S)
    return _attention_xla(q, k, v, True, start, window=cfg.sliding_window)


def _layer(x, lp, cfg: LlamaConfig, cos, sin, cache=None, collect_kv=False,
           tp=None, sp=None):
    """One transformer block. x: [B, S, D]. cache: (k, v, offset) with k/v
    one layer's [B, max_seq, KV, HD] cache, written IN PLACE at offset, or
    None. collect_kv=True returns this layer's (k, v) for cache seeding;
    otherwise the second value is the (k, v) cache or None. tp (a
    ``_TensorParallel``): lp holds this rank's column blocks of wq/wk/wv/
    w_gate/w_up and row blocks of wo/w_down, attention runs on its
    H/tp query heads and the KV/tp kv heads they read, and the block
    outputs are summed over the tp ranks. sp: the axis the sequence is
    split over (``_attention``)."""
    B, S, D = x.shape
    n = tp.size if tp is not None else 1
    H, KV, HD = cfg.n_heads // n, cfg.n_kv_heads // n, cfg.head_dim
    dt = cfg.dtype
    f, g = (tp.f, tp.g) if tp is not None else (_same, _same)

    h = f(rms_norm(x, lp["attn_norm"], cfg.norm_eps))
    if cfg.fused_matmuls:
        wqkv = torch.cat([_dq(lp["wq"], dt), _dq(lp["wk"], dt),
                          _dq(lp["wv"], dt)], dim=-1)
        q, k, v = torch.split(h @ wqkv, [H * HD, KV * HD, KV * HD], dim=-1)
        q = q.reshape(B, S, H, HD)
        k = k.reshape(B, S, KV, HD)
        v = v.reshape(B, S, KV, HD)
    else:
        q = (h @ _dq(lp["wq"], dt)).reshape(B, S, H, HD)
        k = (h @ _dq(lp["wk"], dt)).reshape(B, S, KV, HD)
        v = (h @ _dq(lp["wv"], dt)).reshape(B, S, KV, HD)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        ck, cv, offset = cache
        # dynamic_update_slice clamps its start so the update fits
        start = max(0, min(offset, ck.shape[1] - S))
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        # keys past offset + S are masked by the causal offset
        attn = _attention(q, ck.to(dt), cv.to(dt), cfg, causal=True,
                          q_offset=offset)
        new_cache = (ck, cv)
    else:
        attn = _attention(q, k, v, cfg, causal=True, sp=sp)
    attn = attn.reshape(B, S, H * HD)
    x = x + g(attn @ _dq(lp["wo"], dt))

    h = f(rms_norm(x, lp["ffn_norm"], cfg.norm_eps))
    if cfg.fused_matmuls:
        w_gu = torch.cat([_dq(lp["w_gate"], dt), _dq(lp["w_up"], dt)],
                         dim=-1)
        gate, up = torch.chunk(h @ w_gu, 2, dim=-1)
        gate = F.silu(gate)
    else:
        gate = F.silu(h @ _dq(lp["w_gate"], dt))
        up = h @ _dq(lp["w_up"], dt)
    x = x + g((gate * up) @ _dq(lp["w_down"], dt))
    if collect_kv:
        return x, (k, v)
    return x, new_cache


def _same(x):
    return x


# per-layer weights split by the tp axis at their use: column-parallel
# (the output dim, dim 1 of a layer's [in, out]) and row-parallel (dim 0)
_TP_COLUMNS = ("wq", "wk", "wv", "w_gate", "w_up")
_TP_ROWS = ("wo", "w_down")


class _TensorParallel(NamedTuple):
    size: int
    groups: list

    def f(self, x):
        """Megatron's f: before the column-parallel matmuls."""
        from ray_tpu_torch.parallel.sharding import sum_in_backward

        return sum_in_backward(x, self.groups)

    def g(self, x):
        """Megatron's g: after a row-parallel matmul."""
        from ray_tpu_torch.parallel.sharding import sum_in_forward

        return sum_in_forward(x, self.groups)


class _MeshPlan:
    """How the sharded forward runs on `mesh` under `rules`: each rank
    computes its rows of the [batch, seq, embed] activation (the rules'
    placement of it) on local tensors, and where the rules lay seq over an
    sp axis of more than one rank, its chunk of the sequence too (``sp``,
    that axis; a forward that computes whole sequences takes
    ``whole_sequences(rules)``). A weight is made local at its use
    (``use``): redistributed to whole over every mesh axis but tp (an
    all-gather of its fsdp shards), and over tp to the block its rank
    computes with (column or row block of a layer's projections; embed,
    lm_head and the norms whole). Its gradient is declared Partial over
    the data axes (each rank's rows contribute a part), so the backward of
    the redistribute reduce-scatters (fsdp) or all-reduces (dp) it into
    the param's own placement; over tp it is the rank's block (or, for
    weights whole on every tp rank, the same on each).

    ``split_tp=False`` (the MoE and ViT models): every weight is used
    whole over every axis, tp included; the tp ranks then compute the same
    rows, so the gradient is Replicate over tp."""

    def __init__(self, cfg, mesh, rules, split_tp: bool = True):
        from torch.distributed.tensor import Shard

        from ray_tpu_torch.parallel import sharding as sh

        if mesh is None or rules is None:
            raise ValueError("the sharded forward takes mesh= and rules= "
                             "together")
        self.mesh = mesh
        self.names = sh.axis_names(mesh)
        sizes = sh.axis_sizes(mesh)
        self.act = _act_placements(mesh, rules)
        self.sp = None
        if Shard(1) in self.act:
            from ray_tpu_torch.parallel.spmd import Axis

            self.sp = Axis.of(mesh, "sp")
        self.rows = _act_constraint(mesh, rules)
        self.data = [n for n, p in zip(self.names, self.act)
                     if isinstance(p, Shard)]
        self.data_groups = sh.mesh_groups(mesh, self.data)
        n_tp = sizes["tp"]
        self.tp = None
        if n_tp > 1 and split_tp:
            for what, dim in (("n_heads", cfg.n_heads),
                              ("n_kv_heads", cfg.n_kv_heads),
                              ("d_ff", cfg.d_ff)):
                if dim % n_tp:
                    raise ValueError(f"tp={n_tp} does not divide {what}="
                                     f"{dim}")
            self.tp = _TensorParallel(n_tp, sh.mesh_groups(mesh, ["tp"]))

    def _placements(self, name: str, lead: int):
        """(use, grad) placements of weight `name`; `lead` stacked dims
        ([L, ...] leaves: 1) before the weight's own."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        split = Replicate()
        if self.tp is not None and name in _TP_COLUMNS:
            split = Shard(1 + lead)
        elif self.tp is not None and name in _TP_ROWS:
            split = Shard(lead)
        use = tuple(split if a == "tp" else Replicate() for a in self.names)
        grad = tuple(Partial() if a in self.data else u
                     for a, u in zip(self.names, use))
        return use, grad

    def use(self, name: str, w, lead: int = 0):
        """A weight (a DTensor) as the local tensor this rank computes
        with; ``lead=1`` for a whole stacked [L, ...] leaf."""
        if not is_dtensor(w):
            raise TypeError(
                f"{name}: a sharded forward takes params placed as DTensors "
                f"(parallel.sharding.shard_params, or make_train_state_init "
                f"with a mesh), got {type(w).__name__}")
        use, grad = self._placements(name, lead)
        if tuple(w.placements) == use == grad:
            return w.to_local()
        return w.redistribute(self.mesh, use).to_local(grad_placements=grad)

    def _as_is(self, name: str, placements) -> bool:
        """Whether a weight of these placements is used as it rests, its
        gradient too (every placement of a 1-rank mesh; a weight no data or
        tp axis touches): then it is simply made local, no redistribute."""
        use, grad = self._placements(name, 0)
        return placements == use == grad

    def layers(self, layers):
        """The stacked [L, ...] leaves as L per-layer dicts. A leaf whose
        layers are used as they rest is made local once and unbound as a
        plain tensor; the others are unbound as DTensors, each layer's
        slice made local at its use (``layer``), inside the layer's
        checkpointed body."""
        from torch.distributed.tensor import Shard

        def per_layer(placements):
            # a stacked leaf's placements read on one layer's slice
            if Shard(0) in placements:
                return None
            return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                         for p in placements)

        return _unstack_layers({
            k: v.to_local() if self._as_is(k, per_layer(v.placements))
            else v for k, v in layers.items()})

    def stacked(self, layers):
        """The stacked [L, ...] leaves made local whole (``use`` with
        lead 1), for the pipeline's stages."""
        return {k: self.use(k, v, lead=1) for k, v in layers.items()}

    def layer(self, lp):
        return {k: self.use(k, v) if is_dtensor(v) else v
                for k, v in lp.items()}

    def whole(self, x_local, shape):
        """Local rows back as the global DTensor of `shape`."""
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.sharding import contiguous_stride

        return DTensor.from_local(x_local, self.mesh, self.act,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))


def _act_placements(mesh, rules):
    """The DTensor placement of the [batch, seq, embed] activation: Shard(0)
    over the batch's axes and, where the rules lay seq over sp (``full()``),
    Shard(1) over sp."""
    from ray_tpu_torch.parallel import sharding as sh

    return sh.spec_placements(
        sh.logical_to_mesh(("batch", "seq", None), rules, mesh), mesh)


def whole_sequences(rules):
    """`rules` with the sequence unsplit, for a forward that computes whole
    sequences (``forward_pp``, the ViT's): the batch's chunks are gathered
    over sp and the sp ranks compute the same rows, the reference's
    results (its GSPMD splits what it likes)."""
    return rules and rules.with_(seq=None)


def _act_constraint(mesh, rules):
    """JAX pins the [batch, seq, embed] activation to its rules sharding.
    The port computes each rank's rows on local tensors, so the activation
    keeps that placement by construction: the constraint is the
    redistribution of the forward's input to it (a DTensor redistributed,
    a whole tensor cut to this rank's block), then made local. The
    identity without a mesh."""
    if mesh is None or rules is None:
        return _same
    from ray_tpu_torch.parallel.sharding import local_shard

    act = _act_placements(mesh, rules)

    def rows(x):
        if is_dtensor(x):
            return x.redistribute(mesh, act).to_local()
        return local_shard(x, mesh, act, "batch")

    return rows


def forward(params, tokens, cfg: LlamaConfig, pos_offset=0, mesh=None,
            rules=None):
    """Teacher-forced logits. tokens: [B, S] int -> [B, S, vocab] (f32
    unless ``cfg.f32_logits`` is False). pos_offset shifts RoPE positions.
    Differentiable in the params; each layer runs under ``_checkpoint``
    when ``cfg.remat``.

    mesh+rules: params are DTensors (``parallel.sharding.shard_params`` by
    ``param_specs``); tokens a DTensor or the whole [B, S] tensor, cut to
    this rank's rows (``_act_constraint``); the result is the global
    logits as a DTensor of the activation's placement. Each layer's
    weights are gathered inside its checkpointed body, so remat gathers
    them again in the backward, and tp splits the block (``_MeshPlan``).
    Where the rules lay seq over sp (``full()``), each rank computes its
    chunk of the sequence, at the RoPE positions of that chunk in the
    whole sequence, and attention gathers the chunks over sp
    (``_attention_seq``), as the reference's GSPMD splits the sequence
    through the whole forward."""
    plan = _MeshPlan(cfg, mesh, rules) if (
        mesh is not None or rules is not None) else None
    B, S = tokens.shape
    sp = rope = None
    if plan is not None:
        tokens = plan.rows(tokens)
        sp = plan.sp
    if sp is not None:
        n = tokens.shape[1]
        rope = tuple(t.narrow(0, sp.index * n, n) for t in _rope(
            cfg, pos_offset, S, tokens.device))
    logits = _forward_local(params, tokens, cfg, pos_offset, plan, sp, rope)
    if plan is None:
        return logits
    return plan.whole(logits, (B, S, logits.shape[-1]))


def _rope(cfg: LlamaConfig, pos_offset, S: int, device):
    """(cos, sin) of S positions from pos_offset, as ``forward`` takes
    them: the tables of S positions at offset 0, else ``_rope_at``."""
    if isinstance(pos_offset, int) and pos_offset == 0:
        return _rope_tables(cfg.rope_theta, S, cfg.head_dim, device)
    return _rope_at(cfg, pos_offset, S, device)


def _forward_local(params, tokens, cfg: LlamaConfig, pos_offset, plan,
                   sp=None, rope=None):
    """``forward`` on this rank's tokens (its rows, and under sp its
    chunk): the local logits. sp: the axis the sequence is split over
    (``_attention``); rope: the chunk's (cos, sin), else those of
    ``pos_offset``."""
    dt = cfg.dtype
    S = tokens.shape[1]

    def use(name, w):
        return plan.use(name, w) if plan is not None else w

    x = _embed({"embed": use("embed", params["embed"])}, tokens, dt)
    cos, sin = rope or _rope(cfg, pos_offset, S, x.device)
    tp = plan.tp if plan is not None else None

    def body(x, lp):
        if plan is not None:
            lp = plan.layer(lp)
        return _layer(x, lp, cfg, cos, sin, tp=tp, sp=sp)[0]

    if cfg.remat:
        body = _checkpoint(body, cfg)
    layers = (plan.layers(params["layers"]) if plan is not None
              else _unstack_layers(params["layers"]))
    for lp in layers:
        x = body(x, lp)
    return _head(x, params, cfg, use)


def _head(x, params, cfg: LlamaConfig, use):
    x = rms_norm(x, use("final_norm", params["final_norm"]), cfg.norm_eps)
    logits = x @ _dq(use("lm_head", params["lm_head"]), cfg.dtype)
    return logits.float() if cfg.f32_logits else logits


def _sp_plan(cfg, mesh, rules):
    """forward_sp's plan: the rules with the sequence laid over sp (JAX's
    ``in_specs=P(None, "sp")`` whatever the rules say of seq)."""
    return _MeshPlan(cfg, mesh, rules and rules.with_(seq="sp"))


def forward_sp(params, tokens, cfg: LlamaConfig, mesh, rules=None):
    """Sequence-parallel forward: the sequence sharded over the 'sp' mesh
    axis. Two interchangeable exchanges: ring attention (K/V rotate around
    the sp ring, ops/ring_attention.py) or Ulysses (head-scatter
    all-to-all, ops/ulysses.py); cfg.attn_impl "ulysses" picks Ulysses,
    anything else the ring. Each sp rank runs ``forward``'s layers on its
    chunk of S/sp tokens with ``pos_offset = sp_rank * S/sp``.

    mesh+rules: params are DTensors, gathered at use as in ``forward``;
    each rank computes its rows (dp/fsdp) and its chunk (sp), and its
    weight gradients are declared partial over all of those axes. Without
    rules the params are whole tensors on every rank. Returns the global
    logits as a DTensor (the sequence on sp); ``mesh=None`` runs one chunk,
    the whole sequence, and returns a tensor."""
    from ray_tpu_torch.parallel import spmd

    cfg_ring = cfg if cfg.attn_impl == "ulysses" \
        else cfg.replace(attn_impl="ring")
    sp = spmd.Axis.of(mesh, "sp")
    B, S = tokens.shape
    plan = _sp_plan(cfg, mesh, rules) if rules is not None else None
    if plan is not None:
        tok = plan.rows(tokens)
    else:
        if S % sp.size:
            raise ValueError(f"sequence length {S} does not split over "
                             f"sp={sp.size}")
        tok = tokens.narrow(1, sp.index * (S // sp.size), S // sp.size)
    offset = sp.index * tok.shape[1]
    logits = _forward_local(params, tok, cfg_ring, offset, plan, sp)
    shape = (B, S, logits.shape[-1])
    if plan is not None:
        return plan.whole(logits, shape)
    if mesh is None:
        return logits
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.sharding import contiguous_stride

    pl = [Shard(1) if n == "sp" and sp.size > 1 else Replicate()
          for n in mesh.mesh_dim_names]
    return DTensor.from_local(logits, mesh, pl, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def forward_pp(params, tokens, cfg: LlamaConfig, mesh, num_microbatches=None,
               rules=None):
    """Pipeline-parallel forward: the layers split into pp stages under the
    microbatch schedule of ``cfg.pp_schedule`` ("gpipe" or "1f1b",
    parallel/pipeline.py), M = num_microbatches or 2*pp. Embedding and
    head run on every stage, outside the trunk; each stage runs ``_layer``
    over its L/pp layers (under remat when ``cfg.remat``).

    mesh+rules: params are DTensors; each rank computes its rows (dp/fsdp)
    of whole sequences (a sequence the rules lay over sp is gathered:
    ``whole_sequences``), tp splits the blocks, and the stacked layer
    leaves are made local whole
    at the trunk (``_MeshPlan.stacked``: one gather for the schedule where
    ``forward`` gathers each layer at its use); the layers rest replicated
    over pp and each gets its full gradient on every stage (the trunk sums
    the stages' slices over pp). Without rules the params are whole
    tensors. Returns the logits (a DTensor of the rows' placement under
    rules); ``mesh=None`` is one stage."""
    from ray_tpu_torch.parallel.pipeline import pipeline_trunk, stack_stages
    from ray_tpu_torch.parallel.spmd import Axis

    pp = Axis.of(mesh, "pp").size
    M = num_microbatches or max(2 * pp, 1)
    dt = cfg.dtype
    plan = (_MeshPlan(cfg, mesh, whole_sequences(rules))
            if rules is not None else None)
    B, S = tokens.shape
    if plan is not None:
        tokens = plan.rows(tokens)

    def use(name, w):
        return plan.use(name, w) if plan is not None else w

    x = _embed({"embed": use("embed", params["embed"])}, tokens, dt)
    cos, sin = _rope_tables(cfg.rope_theta, S, cfg.head_dim, x.device)
    tp = plan.tp if plan is not None else None

    def stage_fn(stage_layers, x):
        def body(x, lp):
            return _layer(x, lp, cfg, cos, sin, tp=tp)[0]

        if cfg.remat:
            body = _checkpoint(body, cfg)
        for lp in _unstack_layers(stage_layers):
            x = body(x, lp)
        return x

    layers = (plan.stacked(params["layers"]) if plan is not None
              else params["layers"])
    trunk = pipeline_trunk(stage_fn, mesh, M, schedule=cfg.pp_schedule)
    x = trunk(stack_stages(layers, pp), x)
    logits = _head(x, params, cfg, use)
    if plan is None:
        return logits
    return plan.whole(logits, (B, S, logits.shape[-1]))


def loss_fn(params, batch, cfg: LlamaConfig, mesh=None, rules=None):
    """Next-token cross-entropy. batch: {"tokens": [B, S+1]} or
    {"inputs": [B, S], "targets": [B, S]}, each with an optional "mask"
    (for "tokens" [B, S+1], whose first column is dropped). nll =
    logsumexp(logits in f32) - the target's logit, with no [B, S, V]
    log_softmax.

    Routing as in JAX: ring/ulysses attention with sp > 1 goes to
    ``forward_sp`` and pp > 1 to ``forward_pp``. With mesh+rules, batch
    leaves are DTensors or whole tensors; each rank sums its rows' (and
    under sp its chunk's) nll and divides by the GLOBAL token (or mask)
    count, and the parts are summed over the data ranks (forward only:
    each rank back-propagates its own part, and the weights' redistribute
    sums the gradients), so the loss is the global batch mean on every
    rank, masks differing by rank included."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    sizes = {}
    if mesh is not None:
        from ray_tpu_torch.parallel.sharding import axis_sizes

        sizes = axis_sizes(mesh)
    on_sp = cfg.attn_impl in ("ring", "ulysses") and sizes.get("sp", 1) > 1
    if on_sp:
        logits = forward_sp(params, inputs, cfg, mesh, rules=rules)
    elif sizes.get("pp", 1) > 1:
        logits = forward_pp(params, inputs, cfg, mesh, rules=rules)
    else:
        logits = forward(params, inputs, cfg, mesh=mesh, rules=rules)
    if not is_dtensor(logits):
        return _nll_mean(logits, targets, mask)
    from ray_tpu_torch.parallel.sharding import sum_in_forward

    if on_sp:
        plan = _sp_plan(cfg, mesh, rules)
    elif sizes.get("pp", 1) > 1:
        plan = _MeshPlan(cfg, mesh, whole_sequences(rules))
    else:
        plan = _MeshPlan(cfg, mesh, rules)
    n_tokens = targets.numel()
    logits, targets = logits.to_local(), plan.rows(targets)
    nll = _nll(logits, targets)
    if mask is None:
        part = nll.sum() / n_tokens
    else:
        mask = plan.rows(mask).to(nll.dtype)
        count = sum_in_forward(mask.sum(), plan.data_groups)
        part = (nll * mask).sum() / torch.clamp(count, min=1.0)
    return sum_in_forward(part, plan.data_groups)


def _nll(logits, targets):
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0].float()
    return lse - ll


def _nll_mean(logits, targets, mask):
    nll = _nll(logits, targets)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _mlp_block(x, lp, dt, eps):
    h = rms_norm(x, lp["ffn_norm"], eps)
    gate = F.silu(h @ _dq(lp["w_gate"], dt))
    up = h @ _dq(lp["w_up"], dt)
    return x + (gate * up) @ _dq(lp["w_down"], dt)


# --- inference (contiguous KV cache) ----------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, max_seq, KV, HD]
    v: torch.Tensor
    length: torch.Tensor   # [B] int32: per-sequence filled length


def init_cache(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               dtype=None, device=None) -> KVCache:
    """A zeroed contiguous cache, one [max_seq] row per slot, on `device`
    (None means CUDA; raises without CUDA unless given "cpu")."""
    from ray_tpu_torch import resolve_device

    device = resolve_device(device)
    S = max_seq or cfg.max_seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def cache_specs(cfg: LlamaConfig):
    return KVCache(("layers", None, None, "kv_heads", "head_dim"),
                   ("layers", None, None, "kv_heads", "head_dim"),
                   (None,))


@torch.no_grad()
def decode_step(params, tokens, cache: KVCache, cfg: LlamaConfig,
                active=None) -> Tuple[torch.Tensor, KVCache]:
    """One continuous-batching decode step with PER-ROW positions.
    tokens [B, 1]; cache.length [B] gives each row's write position; rows
    where active == 0 keep their cache row as it was. Returns (logits
    [B, V] f32, the cache with lengths advanced on active rows); k/v are
    written in place. Softmax in f32, then p in the compute dtype for the
    p.v product, as in JAX."""
    dt = cfg.dtype
    B = tokens.shape[0]
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dev = tokens.device
    pos = cache.length.long()                             # [B]
    if active is None:
        active = torch.ones((B,), dtype=torch.int32, device=dev)
    live = active > 0
    cos_full, sin_full = _rope_tables(cfg.rope_theta, cfg.max_seq_len,
                                      cfg.head_dim, dev)
    # a jnp gather clamps an out-of-range index
    rpos = pos.clamp(0, cfg.max_seq_len - 1)
    c = cos_full[rpos][:, None, None, :]                  # [B, 1, 1, HD/2]
    s = sin_full[rpos][:, None, None, :]

    x = _embed(params, tokens, dt)                        # [B, 1, D]
    S = cache.k.shape[2]
    kpos = torch.arange(S, device=dev)[None, :]           # [1, S]
    attn_mask = (kpos <= pos[:, None]) & live[:, None]    # [B, S]
    if cfg.sliding_window is not None:
        # banded decode matches banded training: only the last W cached
        # keys are visible (cache layout unchanged)
        attn_mask = attn_mask & (pos[:, None] - kpos < cfg.sliding_window)
    rows = torch.arange(B, device=dev)
    # one row written per slot; dynamic_update_slice clamps its start
    wpos = pos.clamp(0, S - 1)
    keep = live[:, None, None]
    for i, lp in enumerate(_unstack_layers(params["layers"])):
        ck, cv = cache.k[i], cache.v[i]                   # [B, S, KV, HD]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _rotate((h @ _dq(lp["wq"], dt)).reshape(B, 1, H, HD), c, s)
        k = _rotate((h @ _dq(lp["wk"], dt)).reshape(B, 1, KV, HD), c, s)
        v = (h @ _dq(lp["wv"], dt)).reshape(B, 1, KV, HD)
        # inactive rows write back the value already there
        ck[rows, wpos] = torch.where(keep, k[:, 0].to(ck.dtype),
                                     ck[rows, wpos])
        cv[rows, wpos] = torch.where(keep, v[:, 0].to(cv.dtype),
                                     cv[rows, wpos])
        kk, vv = ck.to(dt), cv.to(dt)
        q5 = q.reshape(B, 1, KV, G, HD)
        sc = torch.einsum("bqkgd,bskd->bkgqs", q5.float(),
                          kk.float()) / (HD ** 0.5)
        sc = torch.where(attn_mask[:, None, None, None, :], sc, -1e30)
        p = torch.softmax(sc, dim=-1).to(dt)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vv).reshape(B, 1, H * HD)
        x = x + o @ _dq(lp["wo"], dt)
        x = _mlp_block(x, lp, dt, cfg.norm_eps)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _dq(params["lm_head"], dt)).float()
    new_len = cache.length + active.to(cache.length.dtype)
    return logits, KVCache(cache.k, cache.v, new_len)


@torch.no_grad()
def prefill_tail_contiguous(params, tokens, tail_len, prefix_len,
                            cache: KVCache, slot_ids, cfg: LlamaConfig
                            ) -> Tuple[torch.Tensor, KVCache]:
    """Chunked prefill of a prompt segment into CONTIGUOUS cache rows, the
    contiguous twin of ``prefill_paged_tail``. tokens [B, T] right-padded;
    tail_len [B] true chunk lengths; prefix_len [B] tokens already in each
    row; slot_ids [B] DISTINCT cache rows. Writes the chunk's KV at
    positions prefix..prefix+tail of each slot row (in place), attends
    causally over the row's filled length, and returns (logits at each
    row's final chunk token [B, V] f32, the cache with length[slot] set to
    prefix+tail on rows with tail_len > 0). Probabilities and V stay in
    f32 until o is cast, as in JAX."""
    dt = cfg.dtype
    B, T = tokens.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = cache.k.shape[2]
    grp = H // KV
    dev = tokens.device
    tail_len = tail_len.long()
    prefix_len = prefix_len.long()
    sl = slot_ids.long()

    ar = torch.arange(T, device=dev)[None, :]
    qpos = prefix_len[:, None] + ar                              # [B, T]
    valid = ar < tail_len[:, None]                               # [B, T]
    safe_q = torch.clamp(qpos, max=S - 1)
    cos_full, sin_full = _rope_tables(cfg.rope_theta, cfg.max_seq_len,
                                      cfg.head_dim, dev)
    safe_pos = torch.clamp(qpos, max=cfg.max_seq_len - 1)
    c = cos_full[safe_pos][:, :, None, :]                        # [B,T,1,HD/2]
    s = sin_full[safe_pos][:, :, None, :]

    kv_pos = torch.arange(S, device=dev)[None, :]                # [1, S]
    total = (prefix_len + tail_len)[:, None]
    mask = (kv_pos < total)[:, None, :] & \
        (kv_pos[:, None, :] <= qpos[:, :, None])                 # [B, T, S]
    if cfg.sliding_window is not None:
        mask = mask & (qpos[:, :, None] - kv_pos[:, None, :]
                       < cfg.sliding_window)
    # only the valid tokens are written: pad positions all clamp to S - 1,
    # where JAX writes back the old value in an undefined order; skipping
    # them lets a valid token at S - 1 win
    vb, vt = torch.nonzero(valid, as_tuple=True)
    w_slot, w_pos = sl[vb], safe_q[vb, vt]

    x = _embed(params, tokens, dt)                               # [B, T, D]
    for i, lp in enumerate(_unstack_layers(params["layers"])):
        ck, cv = cache.k[i], cache.v[i]                          # [Bc,S,KV,HD]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _rotate((h @ _dq(lp["wq"], dt)).reshape(B, T, H, HD), c, s)
        k = _rotate((h @ _dq(lp["wk"], dt)).reshape(B, T, KV, HD), c, s)
        v = (h @ _dq(lp["wv"], dt)).reshape(B, T, KV, HD)
        ck[w_slot, w_pos] = k[vb, vt].to(ck.dtype)
        cv[w_slot, w_pos] = v[vb, vt].to(cv.dtype)
        kg = torch.repeat_interleave(ck[sl].transpose(1, 2), grp, dim=1)
        vg = torch.repeat_interleave(cv[sl].transpose(1, 2), grp, dim=1)
        qh = q.transpose(1, 2)                                   # [B,H,T,HD]
        scores = torch.einsum("bhtd,bhsd->bhts", qh.float(),
                              kg.float()) / (HD ** 0.5)
        scores = torch.where(mask[:, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhts,bhsd->bhtd", probs, vg.float()).to(dt)
        o = o.transpose(1, 2).reshape(B, T, H * HD)
        x = x + o @ _dq(lp["wo"], dt)
        x = _mlp_block(x, lp, dt, cfg.norm_eps)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = torch.clamp(tail_len - 1, 0, T - 1)
    last = x[torch.arange(B, device=dev), idx]
    logits = (last @ _dq(params["lm_head"], dt)).float()
    old_len = cache.length[sl]
    new_len = torch.where(tail_len > 0,
                          (prefix_len + tail_len).to(old_len.dtype), old_len)
    length = cache.length.clone()
    length[sl] = new_len
    return logits, KVCache(cache.k, cache.v, length)


@torch.no_grad()
def forward_with_cache(params, tokens, cache: KVCache, cfg: LlamaConfig,
                       offset) -> Tuple[torch.Tensor, KVCache]:
    """Run [B, S] tokens at position `offset` (an int, uniform across the
    batch), filling the cache in place. Returns last-position logits
    [B, V] f32 and the cache with every length advanced by S. At offset 0
    with ``attn_impl="flash"`` and S >= 128 the attention is the flash
    kernel over the whole [max_seq] row (causality masks the keys past
    S)."""
    dt = cfg.dtype
    B, S = tokens.shape
    offset = int(offset)
    x = _embed(params, tokens, dt)
    cos, sin = _rope_at(cfg, offset, S, x.device)
    for i, lp in enumerate(_unstack_layers(params["layers"])):
        x, _ = _layer(x, lp, cfg, cos, sin,
                      cache=(cache.k[i], cache.v[i], offset))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1, :] @ _dq(params["lm_head"], dt)
    return logits.float(), KVCache(cache.k, cache.v, cache.length + S)


# --- inference (paged KV cache) ---------------------------------------------


@torch.no_grad()
def prefill(params, tokens, lengths, cfg: LlamaConfig):
    """Batched prefill for the continuous-batching engine. tokens [n, P]
    right-padded; lengths [n] true lengths. Returns (logits_at_last
    [n, V] f32, k_layers [L, n, P, KV, HD], v_layers). Pad positions
    produce garbage k/v that is never attended."""
    dt = cfg.dtype
    B, P = tokens.shape
    x = _embed(params, tokens, dt)
    cos, sin = _rope_tables(cfg.rope_theta, P, cfg.head_dim, x.device)
    ks, vs = [], []
    for lp in _unstack_layers(params["layers"]):
        x, (k, v) = _layer(x, lp, cfg, cos, sin, collect_kv=True)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # logits at each row's final REAL position
    idx = torch.clamp(lengths.long() - 1, 0, P - 1)
    last = x[torch.arange(B, device=x.device), idx]
    logits = last @ _dq(params["lm_head"], dt)
    return logits.float(), torch.stack(ks), torch.stack(vs)


def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     dtype=None, device=None):
    """Paged KV pools [L, KV, num_pages, page_size, HD] (page 0 is the
    trash page inactive slots and padding write into), on `device` (None
    means CUDA; raises without CUDA unless given "cpu")."""
    from ray_tpu_torch import resolve_device

    device = resolve_device(device)
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, cfg.n_kv_heads, num_pages, page_size,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


@torch.no_grad()
def decode_step_paged(params, tokens, k_pools, v_pools, page_table,
                      lengths, cfg: LlamaConfig, active=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One continuous-batching decode step over a PAGED KV cache.
    tokens [S, 1]; k_pools/v_pools [L, KV, NP, ps, HD]; page_table
    [S, maxP] int32; lengths [S] int32 = tokens already stored per slot.
    Returns (logits [S, V] f32, k_pools, v_pools, new lengths); the pools
    are the same tensors, updated IN PLACE by the fused write+attend
    kernel (ops/paged_attention.py, K6) on every layer. Rows with
    active == 0 write nothing and keep their length."""
    from ray_tpu_torch.ops.paged_attention import (
        paged_decode_attention_inplace)

    if cfg.sliding_window is not None:
        raise ValueError("paged decode does not support sliding_window")
    dt = cfg.dtype
    S = tokens.shape[0]
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if active is None:
        active = torch.ones((S,), dtype=torch.int32, device=tokens.device)
    pos = lengths.long().clamp(max=cfg.max_seq_len - 1)   # write position
    cos_full, sin_full = _rope_tables(cfg.rope_theta, cfg.max_seq_len,
                                      cfg.head_dim, tokens.device)
    c = cos_full[pos][:, None, None, :]                   # [S, 1, 1, HD/2]
    s = sin_full[pos][:, None, None, :]
    # the kernel derives each slot's tip page/offset from attn_len;
    # inactive rows (attn_len 0) skip the write entirely
    live = active > 0
    attn_len = torch.where(live, lengths + 1, 0).to(torch.int32)

    x = _embed(params, tokens, dt)                        # [S, 1, D]
    for i, lp in enumerate(_unstack_layers(params["layers"])):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _rotate((h @ _dq(lp["wq"], dt)).reshape(S, 1, H, HD), c, s)
        k = _rotate((h @ _dq(lp["wk"], dt)).reshape(S, 1, KV, HD), c, s)
        v = (h @ _dq(lp["wv"], dt)).reshape(S, 1, KV, HD)
        kp, vp = k_pools[i], v_pools[i]
        o, _, _ = paged_decode_attention_inplace(
            q[:, 0].to(dt), k[:, 0].to(kp.dtype), v[:, 0].to(vp.dtype),
            kp, vp, page_table, attn_len)
        # inactive rows return garbage (CPU) or zeros (kernel) — zero them
        o = torch.where(live[:, None, None], o, 0.0)
        x = x + o.reshape(S, 1, H * HD) @ _dq(lp["wo"], dt)
        x = _mlp_block(x, lp, dt, cfg.norm_eps)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _dq(params["lm_head"], dt)).float()
    return logits, k_pools, v_pools, lengths + active.to(lengths.dtype)


@torch.no_grad()
def prefill_paged_tail(params, tokens, tail_len, prefix_len, page_table,
                       k_pools, v_pools, cfg: LlamaConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked prefill of a prompt TAIL against existing paged prefix KV
    (prefix-cache hits and chunked prefill). tokens [B, T] right-padded
    tail tokens; tail_len [B]; prefix_len [B] tokens already in the pages;
    page_table [B, maxP]. Writes the tail's KV into the pages (in place)
    and returns (logits at each row's final tail token [B, V] f32,
    k_pools, v_pools). Attention is plain PyTorch over the gathered page
    view, as the JAX version computes it outside Pallas."""
    dt = cfg.dtype
    B, T = tokens.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ps = k_pools.shape[3]
    maxP = page_table.shape[1]
    S_view = maxP * ps
    grp = H // KV
    dev = tokens.device
    pt = page_table.long()
    tail_len = tail_len.long()
    prefix_len = prefix_len.long()

    # absolute positions of the tail tokens, per row
    ar = torch.arange(T, device=dev)[None, :]
    qpos = prefix_len[:, None] + ar                              # [B, T]
    valid = ar < tail_len[:, None]                               # [B, T]
    cos_full, sin_full = _rope_tables(cfg.rope_theta, cfg.max_seq_len,
                                      cfg.head_dim, dev)
    safe_pos = torch.clamp(qpos, max=cfg.max_seq_len - 1)
    c = cos_full[safe_pos][:, :, None, :]                        # [B,T,1,HD/2]
    s = sin_full[safe_pos][:, :, None, :]

    # physical write targets; padded rows land in trash page 0
    page_ids = torch.gather(pt, 1, torch.clamp(qpos // ps, max=maxP - 1))
    page_ids = torch.where(valid, page_ids, 0)
    pid_f = page_ids.reshape(-1)
    off_f = (qpos % ps).reshape(-1)

    # mask over the gathered page view [B, S_view]: causal against the
    # absolute key position, bounded by each row's total length
    kv_pos = torch.arange(S_view, device=dev)[None, :]
    total = (prefix_len + tail_len)[:, None]
    mask = (kv_pos < total)[:, None, :] & \
        (kv_pos[:, None, :] <= qpos[:, :, None])                 # [B, T, S_view]

    x = _embed(params, tokens, dt)                               # [B, T, D]
    for i, lp in enumerate(_unstack_layers(params["layers"])):
        kp, vp = k_pools[i], v_pools[i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _rotate((h @ _dq(lp["wq"], dt)).reshape(B, T, H, HD), c, s)
        k = _rotate((h @ _dq(lp["wk"], dt)).reshape(B, T, KV, HD), c, s)
        v = (h @ _dq(lp["wv"], dt)).reshape(B, T, KV, HD)
        # write the tail KV FIRST: the gathered view then covers
        # prefix + tail and one causal mask handles both
        kp[:, pid_f, off_f, :] = k.reshape(B * T, KV, HD).transpose(
            0, 1).to(kp.dtype)
        vp[:, pid_f, off_f, :] = v.reshape(B * T, KV, HD).transpose(
            0, 1).to(vp.dtype)
        # each row's pages as a contiguous [S_view] key space
        kg = kp[:, pt].permute(1, 0, 2, 3, 4).reshape(B, KV, S_view, HD)
        vg = vp[:, pt].permute(1, 0, 2, 3, 4).reshape(B, KV, S_view, HD)
        kg = torch.repeat_interleave(kg, grp, dim=1)             # [B,H,S,HD]
        vg = torch.repeat_interleave(vg, grp, dim=1)
        qh = q.transpose(1, 2)                                   # [B,H,T,HD]
        scores = torch.einsum("bhtd,bhsd->bhts", qh.float(),
                              kg.float()) / (HD ** 0.5)
        scores = torch.where(mask[:, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhts,bhsd->bhtd", probs, vg.float()).to(dt)
        o = o.transpose(1, 2).reshape(B, T, H * HD)
        x = x + o @ _dq(lp["wo"], dt)
        x = _mlp_block(x, lp, dt, cfg.norm_eps)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = torch.clamp(tail_len - 1, 0, T - 1)
    last = x[torch.arange(B, device=dev), idx]
    logits = (last @ _dq(params["lm_head"], dt)).float()
    return logits, k_pools, v_pools


@torch.no_grad()
def scatter_prefill_pages(k_pools, v_pools, ks, vs, page_table, slots,
                          lengths, page_size: int):
    """Write prefill k/v into the pools, in place, one layer at a time.
    ks/vs [L, n, P, KV, HD] (from prefill), slots [n] slot ids, lengths
    [n] true lengths; positions past a row's length go to trash page 0.
    Returns the (same) pools."""
    L, n, P, KV, HD = ks.shape
    ps = page_size
    dev = ks.device
    pos = torch.arange(P, device=dev)[None, :]                   # [1, P]
    rows = page_table.long()[slots.long()]                       # [n, maxP]
    chunk = torch.clamp(pos // ps, max=rows.shape[1] - 1).expand(n, P)
    pages = torch.gather(rows, 1, chunk)
    pages = torch.where(pos < lengths.long()[:, None], pages, 0)  # [n, P]
    pages_f = pages.reshape(-1)
    offs_f = (pos % ps).expand(n, P).reshape(-1)
    for i in range(L):
        kp, vp = k_pools[i], v_pools[i]
        kp[:, pages_f, offs_f, :] = ks[i].permute(2, 0, 1, 3).reshape(
            KV, n * P, HD).to(kp.dtype)
        vp[:, pages_f, offs_f, :] = vs[i].permute(2, 0, 1, 3).reshape(
            KV, n * P, HD).to(vp.dtype)
    return k_pools, v_pools
