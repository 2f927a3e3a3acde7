"""Mixture-of-Experts Llama variant (the expert-parallel exercise), in PyTorch.

Port of ``ray_tpu/models/moe.py``. Experts live on the 'experts' logical
axis, which ``ShardingRules.ep()`` lays over the data axes ('dp', 'fsdp').
Routing is the reference's dense one-hot dispatch: top-k experts per
token, each (token, k) given a slot in its expert's capacity buffer by a
cumulative count, the expert FFN batched over experts, and the outputs
combined back with the gates. Dropped tokens pass through the residual
(Switch/GShard semantics). No Pallas kernel: the dispatch and combine
einsums are plain products, as XLA computed them; the attention is
``llama._attention`` (flash, K1 and in the backward K3/K4, at S >= 128).

Routing follows ``jax.lax.top_k``: a stable descending sort, so on a tie
the lower expert index comes first; the one-hot counts are int32, and the
capacity is ``int(capacity_factor * T * K / E)`` over the batch's T
tokens. The slot arithmetic is the reference's own, term for term
(``_positions``).

Sharded (``mesh=``/``rules=``, params as DTensors placed by
``param_specs``): each data rank computes its rows' attention; every
weight, experts included, is gathered whole at its use (``llama.
_MeshPlan`` with ``split_tp=False``), its gradient reduced into its shards
(under ``ep()`` each rank keeps its experts' slices and their AdamW
moments at rest). The routing is a function of the whole batch (the
capacity, the slot counts and the aux loss run over all T tokens), so each
layer's FFN input is all-gathered over the data axes, the MoE FFN computed
on the global tokens, and each rank keeps its rows (the gather's backward
reduce-scatters). An all-to-all token dispatch to the ranks holding the
experts is a ROADMAP follow-up; the results do not depend on it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch import is_dtensor
from ray_tpu_torch.models import llama as _ll

params_from_jax = _ll.params_from_jax


@dataclass(frozen=True)
class MoEConfig(_ll.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.5
    router_aux_weight: float = 0.01

    def replace(self, **kw) -> "MoEConfig":
        return dataclasses.replace(self, **kw)


PRESETS: Dict[str, MoEConfig] = {
    "tiny": MoEConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=96, max_seq_len=128, n_experts=4,
                      top_k=2),
    "8x1b": MoEConfig(vocab_size=32000, d_model=2048, n_layers=16,
                      n_heads=16, n_kv_heads=8, d_ff=5632, n_experts=8),
}


def param_specs(cfg: MoEConfig) -> Dict[str, Any]:
    spec = _ll.param_specs(cfg)
    L = ("layers",)
    lay = dict(spec["layers"])
    for w in ("w_gate", "w_up", "w_down"):
        del lay[w]
    lay["router"] = L + ("embed", "experts")
    lay["we_gate"] = L + ("experts", "embed", "expert_mlp")
    lay["we_up"] = L + ("experts", "embed", "expert_mlp")
    lay["we_down"] = L + ("experts", "expert_mlp", "embed")
    spec["layers"] = lay
    return spec


def init_params(generator: torch.Generator, cfg: MoEConfig,
                leaf=None) -> Dict[str, Any]:
    """Random weights on the generator's device, in cfg.param_dtype, drawn
    leaf by leaf (``leaf(path, tensor)`` as in ``llama.init_params``): the
    JAX shapes and scales (router normal * 0.02, expert weights normal /
    sqrt(fan_in)). The numbers differ from those jax.random draws; tests
    share weights through params_from_jax instead."""
    spec = _ll.init_specs(cfg)
    L, D, F_, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    lay = dict(spec["layers"])
    for w in ("w_gate", "w_up", "w_down"):
        del lay[w]
    lay["router"] = ((L, D, E), 0.02)
    lay["we_gate"] = ((L, E, D, F_), D ** -0.5)
    lay["we_up"] = ((L, E, D, F_), D ** -0.5)
    lay["we_down"] = ((L, E, F_, D), F_ ** -0.5)
    spec["layers"] = lay
    return _ll.draw_params(generator, spec, cfg.param_dtype, leaf)


def num_params(cfg: MoEConfig) -> int:
    D, H, KV, HD, F_, L, V, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, cfg.d_ff, cfg.n_layers,
                                 cfg.vocab_size, cfg.n_experts)
    per_layer = (2 * D + D * H * HD + 2 * D * KV * HD + H * HD * D + D * E
                 + 3 * E * D * F_)
    return V * D + L * per_layer + D + D * V


def capacity(cfg: MoEConfig, T: int) -> int:
    """Per-expert capacity for T tokens."""
    return max(1, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))


def _route(xt, router, cfg: MoEConfig):
    """xt [T, D] -> (probs [T, E] f32, gates [T, K], idx [T, K]): the
    router's softmax and its top-k (``jax.lax.top_k``: values descending,
    the lower index first on a tie)."""
    logits = (xt @ router.to(xt.dtype)).float()                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top[:, :cfg.top_k], order[:, :cfg.top_k]


def _positions(idx, E: int, C: int):
    """Each (token, k)'s slot in its expert's buffer and whether it is
    kept: the reference's arithmetic, (cumsum(one_hot) * one_hot - 1)
    summed over the experts, in int32."""
    flat_idx = idx.reshape(-1)                                   # [T*K]
    eo = F.one_hot(flat_idx.long(), E).to(torch.int32)           # [T*K, E]
    pos = torch.cumsum(eo, dim=0, dtype=torch.int32) * eo - 1
    pos = pos.sum(dim=-1, dtype=torch.int32)                     # [T*K]
    return pos, pos < C


def _moe_ffn(x, lp, cfg: MoEConfig):
    """x: [B, S, D] -> ([B, S, D], aux_loss). Dense one-hot dispatch."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(cfg, T)                                         # per expert
    dt = x.dtype

    xt = x.reshape(T, D)
    probs, gates, idx = _route(xt, lp["router"], cfg)

    # aux load-balancing loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0].long(), E).float().mean(dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each (token, k) within its expert's capacity buffer
    flat_idx = idx.reshape(-1)
    pos, keep = _positions(idx, E, C)
    flat_gate = gates.reshape(-1) * keep

    # dispatch tensor [T*K, E, C] one-hot -> combine with expert outputs
    disp = (F.one_hot(flat_idx.long(), E).to(dt)[:, :, None]
            * F.one_hot(torch.clamp(pos, 0, C - 1).long(), C).to(dt)[
                :, None, :]
            * keep[:, None, None].to(dt))                        # [T*K, E, C]
    xin = torch.einsum("tec,td->ecd", disp,
                       torch.repeat_interleave(xt, K, dim=0))    # [E, C, D]

    # expert FFN (batched over E)
    we_g = lp["we_gate"].to(dt)
    we_u = lp["we_up"].to(dt)
    we_d = lp["we_down"].to(dt)
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, we_g)) * torch.einsum(
        "ecd,edf->ecf", xin, we_u)
    out_e = torch.einsum("ecf,efd->ecd", h, we_d)                # [E, C, D]

    combine = disp * flat_gate[:, None, None].to(dt)             # [T*K, E, C]
    out = torch.einsum("tec,ecd->td", combine, out_e)            # [T*K, D]
    out = out.reshape(T, K, D).sum(dim=1)
    return out.reshape(B, S, D), aux


class _GlobalTokens:
    """The MoE FFN on the whole batch under a mesh: this rank's rows
    all-gathered over the data axes (the backward reduce-scatters), the
    FFN's output cut back to them."""

    def __init__(self, plan, B: int, S: int):
        from torch.distributed.tensor import Partial, Replicate

        self.plan, self.shape = plan, (B, S)
        self.grad = [Partial() if n in plan.data else Replicate()
                     for n in plan.names]

    def gather(self, h):
        if not self.plan.data:
            return h
        return self.plan.whole(h, self.shape + (h.shape[-1],)).full_tensor(
            grad_placements=self.grad)

    def rows(self, y):
        return self.plan.rows(y) if self.plan.data else y


def forward(params, tokens, cfg: MoEConfig, pos_offset=0, mesh=None,
            rules=None):
    """tokens [B, S] -> (logits [B, S, vocab] f32, aux loss). pos_offset is
    accepted and unused, as in the reference (positions start at 0).
    mesh+rules: params are DTensors; the logits come back as the global
    DTensor of the rows' placement and aux is the whole batch's, the same
    on every rank."""
    dt = cfg.dtype
    plan = (_ll._MeshPlan(cfg, mesh, rules, split_tp=False)
            if mesh is not None or rules is not None else None)
    B, S = tokens.shape
    if plan is not None:
        tokens = plan.rows(tokens)
        glob = _GlobalTokens(plan, B, S)

    def use(name, w):
        return plan.use(name, w) if plan is not None else w

    b = tokens.shape[0]
    x = _ll._embed({"embed": use("embed", params["embed"])}, tokens, dt)
    cos, sin = _ll._rope_tables(cfg.rope_theta, S, cfg.head_dim, x.device)
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = (plan.layers(params["layers"]) if plan is not None
              else _ll._unstack_layers(params["layers"]))
    for lp in layers:
        if plan is not None:
            lp = plan.layer(lp)
        h = _ll.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"].to(dt)).reshape(b, S, H, HD)
        k = (h @ lp["wk"].to(dt)).reshape(b, S, KV, HD)
        v = (h @ lp["wv"].to(dt)).reshape(b, S, KV, HD)
        q = _ll.apply_rope(q, cos, sin)
        k = _ll.apply_rope(k, cos, sin)
        attn = _ll._attention(q, k, v, cfg, causal=True)
        x = x + attn.reshape(b, S, H * HD) @ lp["wo"].to(dt)
        h = _ll.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        if plan is None:
            moe_out, a = _moe_ffn(h, lp, cfg)
        else:
            moe_out, a = _moe_ffn(glob.gather(h), lp, cfg)
            moe_out = glob.rows(moe_out)
        x = x + moe_out
        aux = aux + a
    x = _ll.rms_norm(x, use("final_norm", params["final_norm"]), cfg.norm_eps)
    logits = (x @ use("lm_head", params["lm_head"]).to(dt)).float()
    if plan is None:
        return logits, aux
    return plan.whole(logits, (B, S, logits.shape[-1])), aux


def loss_fn(params, batch, cfg: MoEConfig, mesh=None, rules=None):
    """Mean next-token cross-entropy (log_softmax) plus the router's aux
    loss. mesh+rules: each rank sums its rows' nll over the GLOBAL token
    count and adds its share of aux (aux over the data ranks' count), the
    parts summed over the data ranks (forward only, as ``llama.loss_fn``)."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    logits, aux = forward(params, inputs, cfg, mesh=mesh, rules=rules)
    if not is_dtensor(logits):
        return _nll(logits, targets).mean() + aux
    from ray_tpu_torch.parallel.sharding import axis_sizes, sum_in_forward

    plan = _ll._MeshPlan(cfg, mesh, rules, split_tp=False)
    n_tokens = targets.numel()
    nll = _nll(logits.to_local(), plan.rows(targets))
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in plan.data)
    return sum_in_forward(nll.sum() / n_tokens + aux / n_data,
                          plan.data_groups)


def _nll(logits, targets):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
