"""GPT-2 family: LayerNorm + learned positions + GELU MLP + MHA, in PyTorch.

Port of ``ray_tpu/models/gpt2.py`` (BASELINE.md config 1: "GPT-2 125M
single-host Trainer"), in ``llama.py``'s conventions: plain functions on
a param dict of tensors, matmul weights ``[in, out]``, the per-layer
leaves stacked ``[L, ...]`` as ``param_specs`` gives them, a Python loop
over the layers for ``lax.scan`` and, when ``cfg.remat``, each layer under
a non-reentrant ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` on the scan body). ``params_from_jax`` is llama's: the
layouts are the same, so the JAX tree crosses over by plain copy.

Attention is llama's plain ``_attention_xla``, as in the reference, which
reaches no Pallas kernel: GPT-2 has no flash route in either package.

Three places where PyTorch's defaults differ from JAX's, each written the
reference's way:

- GELU: ``jax.nn.gelu`` is the tanh approximation by default, torch's the
  exact erf form, so the MLP takes ``approximate="tanh"``;
- LayerNorm: normalised in f32, cast to the compute dtype, and only then
  scaled and shifted by ``g`` and ``b`` cast to that dtype (``F.layer_norm``
  with f32 affine weights rounds otherwise in bf16);
- token indices: ``wte[tokens]`` wraps a negative index once and clamps
  into ``[0, vocab)`` as a JAX gather does, where torch would raise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (_attention_xla, _nll_mean,
                                        _unstack_layers, params_from_jax)

__all__ = ["GPT2Config", "PRESETS", "param_specs", "init_params",
           "num_params", "params_from_jax", "layer_norm", "forward",
           "loss_fn"]


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16        # activation/compute dtype
    param_dtype: Any = torch.float32   # master weights
    remat: bool = True                 # checkpoint each layer in forward

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "GPT2Config":
        return dataclasses.replace(self, **kw)


PRESETS: Dict[str, GPT2Config] = {
    "tiny": GPT2Config(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                       d_ff=128, max_seq_len=128),
    "125m": GPT2Config(),
    "350m": GPT2Config(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
    "1.5b": GPT2Config(d_model=1600, n_layers=48, n_heads=25, d_ff=6400),
}


def param_specs(cfg: GPT2Config) -> Dict[str, Any]:
    """Logical axis names per parameter (the sharding vocabulary)."""
    L = ("layers",)
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "layers": {
            "ln1_g": L + ("embed_nr",), "ln1_b": L + ("embed_nr",),
            "wqkv": L + ("embed", "heads"), "bqkv": L + ("heads",),
            "wo": L + ("heads", "embed"), "bo": L + ("embed_nr",),
            "ln2_g": L + ("embed_nr",), "ln2_b": L + ("embed_nr",),
            "w1": L + ("embed", "mlp"), "b1": L + ("mlp",),
            "w2": L + ("mlp", "embed"), "b2": L + ("embed_nr",),
        },
        "lnf_g": ("embed_nr",), "lnf_b": ("embed_nr",),
    }


def init_params(generator: torch.Generator,
                cfg: GPT2Config) -> Dict[str, Any]:
    """Random weights on the generator's device, in cfg.param_dtype: the
    reference's shapes and scales (wte * 0.02, wpe * 0.01, matmul weights
    normal / sqrt(fan_in), LayerNorm gains 1, biases 0). The numbers are
    not those jax.random draws; tests share weights through
    params_from_jax."""
    pd, dev = cfg.param_dtype, generator.device
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    # (shape, std) in the order the leaves are drawn; "ones" / "zeros" in
    # place of a std for the LayerNorm gains and the biases
    ones, zeros = "ones", "zeros"
    specs = {
        "wte": ((V, D), 0.02),
        "wpe": ((cfg.max_seq_len, D), 0.01),
        "layers": {
            "ln1_g": ((L, D), ones), "ln1_b": ((L, D), zeros),
            "wqkv": ((L, D, 3 * D), D ** -0.5),
            "bqkv": ((L, 3 * D), zeros),
            "wo": ((L, D, D), D ** -0.5), "bo": ((L, D), zeros),
            "ln2_g": ((L, D), ones), "ln2_b": ((L, D), zeros),
            "w1": ((L, D, F_), D ** -0.5), "b1": ((L, F_), zeros),
            "w2": ((L, F_, D), F_ ** -0.5), "b2": ((L, D), zeros),
        },
        "lnf_g": ((D,), ones), "lnf_b": ((D,), zeros),
    }

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, std = spec
        if std in (ones, zeros):
            return (torch.ones if std == ones else torch.zeros)(
                shape, dtype=pd, device=dev)
        return torch.empty(shape, dtype=pd, device=dev).normal_(
            0.0, std, generator=generator)

    return make(specs)


def num_params(cfg: GPT2Config) -> int:
    """Every parameter, the learned positions and the (tied) embedding
    counted once."""
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_layer = 4 * D + 3 * D * D + 3 * D + D * D + D + D * F_ + F_ \
        + F_ * D + D
    return (cfg.vocab_size + cfg.max_seq_len) * D + L * per_layer + 2 * D


def layer_norm(x, g, b, eps):
    """The reference's order: statistics and normalisation in f32, cast to
    x's dtype, then ``* g + b`` in that dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
            * g.to(x.dtype) + b.to(x.dtype))


def _token_rows(tokens, n: int):
    """Gather indices as a JAX gather reads them: a negative index counts
    from the end once, then every index is clamped into [0, n)."""
    idx = tokens.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def forward(params, tokens, cfg: GPT2Config):
    """Teacher-forced logits: tokens [B, S] int -> [B, S, vocab] f32.
    Differentiable in the params; the output projection is the tied
    embedding, so ``wte``'s gradient sums the gather's and the matmul's."""
    dt = cfg.dtype
    B, S = tokens.shape
    H, HD = cfg.n_heads, cfg.head_dim
    x = (params["wte"].to(dt)[_token_rows(tokens, cfg.vocab_size)]
         + params["wpe"].to(dt)[:S])

    def body(x, lp):
        h = layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
        qkv = h @ lp["wqkv"].to(dt) + lp["bqkv"].to(dt)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        attn = _attention_xla(q.reshape(B, S, H, HD), k.reshape(B, S, H, HD),
                              v.reshape(B, S, H, HD), causal=True)
        x = x + attn.reshape(B, S, H * HD) @ lp["wo"].to(dt) \
            + lp["bo"].to(dt)
        h = layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
        h = F.gelu(h @ lp["w1"].to(dt) + lp["b1"].to(dt), approximate="tanh")
        return x + h @ lp["w2"].to(dt) + lp["b2"].to(dt)

    if cfg.remat:
        from torch.utils.checkpoint import checkpoint

        run = lambda x, lp: checkpoint(body, x, lp, use_reentrant=False)  # noqa: E731
    else:
        run = body
    for lp in _unstack_layers(params["layers"]):
        x = run(x, lp)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.norm_eps)
    logits = x @ params["wte"].to(dt).T      # tied embeddings
    return logits.float()


def loss_fn(params, batch, cfg: GPT2Config, mesh=None):
    """Mean next-token cross-entropy. batch: {"tokens": [B, S+1]} or
    {"inputs": [B, S], "targets": [B, S]}. `mesh` is accepted and unused,
    as in the reference, so ``make_train_step`` can pass one."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    return _nll_mean(forward(params, inputs, cfg), targets, None)
