"""ViT family: patch-embedded image classification transformer, in PyTorch.

Port of ``ray_tpu/models/vit.py``: the vision family of the batch
inference and train paths. The same functional conventions as
``llama.py``/``gpt2.py``: ``init_params``/``forward``/``loss_fn``/
``param_specs`` over a stacked [L, ...] layer tree, a Python loop over the
layers, each under ``torch.utils.checkpoint`` when ``cfg.remat``. Images
are NHWC, as in JAX. The patch embedding is a reshape and one matmul (not
a convolution); attention is full (non-causal) over patches + cls through
``llama._attention_xla``; LayerNorm is ``gpt2.layer_norm``; GELU is the
tanh approximation (``jax.nn.gelu``'s default). bf16 activations over f32
params. No Pallas kernel.

Sharded (``mesh=``/``rules=``, params as DTensors placed by
``param_specs``): each data rank computes its images, every weight
gathered whole at its use (``llama._MeshPlan`` with ``split_tp=False``)
and its gradient reduced into its shards.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch import is_dtensor
from ray_tpu_torch.models import llama as _ll
from ray_tpu_torch.models.gpt2 import layer_norm
from ray_tpu_torch.models.llama import _attention_xla

params_from_jax = _ll.params_from_jax


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self):
        return self.patch_size * self.patch_size * self.channels

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


PRESETS: Dict[str, ViTConfig] = {
    "tiny": ViTConfig(image_size=32, patch_size=8, num_classes=10,
                      d_model=64, n_layers=2, n_heads=4, d_ff=128),
    "base": ViTConfig(),                                     # ViT-B/16
    "large": ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
    "huge": ViTConfig(patch_size=14, d_model=1280, n_layers=32,
                      n_heads=16, d_ff=5120),
}


def param_specs(cfg: ViTConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (embed/heads/mlp shardable; biases
    and norms replicated)."""
    L = ("layers",)
    return {
        "patch_w": (None, "embed"), "patch_b": ("embed_nr",),
        "pos": (None, "embed"), "cls": (None, None, "embed_nr"),
        "layers": {
            "ln1_g": L + ("embed_nr",), "ln1_b": L + ("embed_nr",),
            "wqkv": L + ("embed", "heads"), "bqkv": L + ("heads",),
            "wo": L + ("heads", "embed"), "bo": L + ("embed_nr",),
            "ln2_g": L + ("embed_nr",), "ln2_b": L + ("embed_nr",),
            "w1": L + ("embed", "mlp"), "b1": L + ("mlp",),
            "w2": L + ("mlp", "embed"), "b2": L + ("embed_nr",),
        },
        "lnf_g": ("embed_nr",), "lnf_b": ("embed_nr",),
        "head_w": ("embed", None), "head_b": (None,),
    }


def init_params(generator: torch.Generator, cfg: ViTConfig,
                leaf=None) -> Dict[str, Any]:
    """Random weights on the generator's device, in cfg.param_dtype, drawn
    leaf by leaf (``leaf`` as in ``llama.init_params``): the JAX shapes and
    scales (normal / sqrt(fan_in), pos * 0.02, zero biases and cls, unit
    norm gains). The numbers differ from those jax.random draws; tests
    share weights through params_from_jax instead."""
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    P = cfg.num_patches
    zero, one = 0.0, None
    specs = {
        "patch_w": ((cfg.patch_dim, D), cfg.patch_dim ** -0.5),
        "patch_b": ((D,), zero),
        "pos": ((P + 1, D), 0.02),
        "cls": ((1, 1, D), zero),
        "layers": {
            "ln1_g": ((L, D), one), "ln1_b": ((L, D), zero),
            "wqkv": ((L, D, 3 * D), D ** -0.5),
            "bqkv": ((L, 3 * D), zero),
            "wo": ((L, D, D), D ** -0.5),
            "bo": ((L, D), zero),
            "ln2_g": ((L, D), one), "ln2_b": ((L, D), zero),
            "w1": ((L, D, F_), D ** -0.5),
            "b1": ((L, F_), zero),
            "w2": ((L, F_, D), F_ ** -0.5),
            "b2": ((L, D), zero),
        },
        "lnf_g": ((D,), one), "lnf_b": ((D,), zero),
        "head_w": ((D, cfg.num_classes), D ** -0.5),
        "head_b": ((cfg.num_classes,), zero),
    }
    return _ll.draw_params(generator, specs, cfg.param_dtype, leaf)


def num_params(cfg: ViTConfig) -> int:
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_layer = 4 * D + 3 * D * D + 3 * D + D * D + D + D * F_ + F_ \
        + F_ * D + D
    return (cfg.patch_dim * D + D + (cfg.num_patches + 1) * D + D
            + L * per_layer + 2 * D + D * cfg.num_classes + cfg.num_classes)


def patchify(images, cfg: ViTConfig):
    """[B, H, W, C] -> [B, P, patch_dim] via reshape (one GEMM follows)."""
    B = images.shape[0]
    p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(B, n, p, n, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, n * n, cfg.patch_dim)


def _plan(cfg, mesh, rules):
    """Each rank's rows of whole images: the rules' "seq" (laid over sp by
    ``full()``) places the batch's dim 1, the images' rows, which are
    gathered over sp (``llama.whole_sequences``)."""
    if mesh is None and rules is None:
        return None
    return _ll._MeshPlan(cfg, mesh, _ll.whole_sequences(rules),
                         split_tp=False)


def forward(params, images, cfg: ViTConfig, mesh=None, rules=None):
    """[B, H, W, C] float images -> [B, num_classes] f32 logits (under
    mesh+rules the global logits as a DTensor of the rows' placement)."""
    dt = cfg.dtype
    plan = _plan(cfg, mesh, rules)
    B = images.shape[0]
    if plan is not None:
        images = plan.rows(images)

    def use(name, w):
        return plan.use(name, w) if plan is not None else w

    b = images.shape[0]
    H, HD = cfg.n_heads, cfg.head_dim
    x = patchify(images.to(dt), cfg) @ use("patch_w", params["patch_w"]).to(
        dt) + use("patch_b", params["patch_b"]).to(dt)
    cls = use("cls", params["cls"]).to(dt).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + use("pos", params["pos"]).to(dt)
    S = x.shape[1]

    def body(x, lp):
        if plan is not None:
            lp = plan.layer(lp)
        h = layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
        qkv = h @ lp["wqkv"].to(dt) + lp["bqkv"].to(dt)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        attn = _attention_xla(q.reshape(b, S, H, HD),
                              k.reshape(b, S, H, HD),
                              v.reshape(b, S, H, HD),
                              causal=False).reshape(b, S, H * HD)
        x = x + attn @ lp["wo"].to(dt) + lp["bo"].to(dt)
        h = layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
        h = F.gelu(h @ lp["w1"].to(dt) + lp["b1"].to(dt), approximate="tanh")
        return x + h @ lp["w2"].to(dt) + lp["b2"].to(dt)

    if cfg.remat:
        from torch.utils.checkpoint import checkpoint

        plain = body
        body = lambda x, lp: checkpoint(plain, x, lp, use_reentrant=False)
    layers = (plan.layers(params["layers"]) if plan is not None
              else _ll._unstack_layers(params["layers"]))
    for lp in layers:
        x = body(x, lp)
    x = layer_norm(x[:, 0], use("lnf_g", params["lnf_g"]),
                   use("lnf_b", params["lnf_b"]), cfg.norm_eps)
    logits = (x @ use("head_w", params["head_w"]).to(dt)
              + use("head_b", params["head_b"]).to(dt)).float()
    if plan is None:
        return logits
    return plan.whole(logits, (B, logits.shape[-1]))


def loss_fn(params, batch, cfg: ViTConfig, mesh=None, rules=None):
    """batch: {"images": [B,H,W,C], "labels": [B]} -> mean CE. mesh+rules:
    each rank's summed nll over the global B, summed over the data ranks
    (forward only, as ``llama.loss_fn``)."""
    logits = forward(params, batch["images"], cfg, mesh=mesh, rules=rules)
    labels = batch["labels"]
    if not is_dtensor(logits):
        return _nll(logits, labels).mean()
    from ray_tpu_torch.parallel.sharding import sum_in_forward

    plan = _plan(cfg, mesh, rules)
    nll = _nll(logits.to_local(), plan.rows(labels))
    return sum_in_forward(nll.sum() / labels.shape[0], plan.data_groups)


def _nll(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def predict_fn(params, images, cfg: ViTConfig):
    """Batch-inference entry (data.map_batches / serve replicas)."""
    return torch.argmax(forward(params, images, cfg), dim=-1)
