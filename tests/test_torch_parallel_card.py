"""The sharded entry points on the card: a 1-rank NCCL mesh
(``local_mesh``, which starts a one-rank group in an in-memory store).
Marked ``cuda``: they skip without a card (run them there with
``python3 -m pytest -m cuda tests/test_torch_parallel_card.py``). Two
NCCL ranks cannot share one card, so the multi-rank parity runs on the
CPU over gloo (tests/test_torch_parallel_train.py and
tests/test_torch_parallel_engine.py).

- The sharded train step at ``debug-125m`` (12 layers, d_model 768, head
  dim 64: the TMA/wgmma flash kernels in bf16), 2 AdamW steps, equals the
  unsharded step: on one rank every placement is Replicate and the step
  runs the same kernels in the same order, so the losses agree within
  1e-5 relative (the loss is a sum over the global count where the
  unsharded one is a mean) and the params within chip_smoke.py's AdamW
  rule (4 lr; at most 1e-4 of them more than 1e-5 apart).
- A DTensor handed to a kernel wrapper raises TypeError.
- Sequence and pipeline parallelism on the 1-rank mesh: forward_sp (ring,
  Ulysses) and forward_pp (gpipe, 1f1b) give forward's logits and
  gradients (debug-125m cut to 2 layers, f32). On one rank the ring has a
  single block and the pipeline a single stage: the multi-rank proof is
  tests/test_torch_parallel_sp_pp.py on 4 gloo ranks.
"""

import functools

import numpy as np
import pytest

from test_torch_support import require_cuda

LOSS_RTOL = 1e-5
PARAM_MAX = 4 * 3e-4
PARAM_FAR, PARAM_FAR_SHARE = 1e-5, 1e-4


@pytest.fixture(scope="module")
def card_mesh():
    require_cuda()
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh

    started = not dist.is_initialized()
    mesh = local_mesh(MeshSpec(fsdp=-1))
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_mesh_step_equals_unsharded_step_on_card(card_mesh):
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.sharding import ShardingRules

    cfg = llama.PRESETS["debug-125m"].replace(attn_impl="flash", remat=True)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 257)), device="cuda")
    rules = ShardingRules.fsdp_tp()
    out = {}
    for sharded in (False, True):
        kw = dict(mesh=card_mesh, rules=rules) if sharded else {}
        init, _ = ts.make_train_state_init(
            functools.partial(llama.init_params, cfg=cfg),
            ts.adamw(3e-4, weight_decay=0.01),
            param_logical=llama.param_specs(cfg), device="cuda", **kw)
        state = init(0)
        step = ts.make_train_step(
            lambda p, b, kw=kw: llama.loss_fn(p, b, cfg, **kw), **kw)
        losses = []
        for _ in range(2):
            state, m = step(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
        out[sharded] = (losses, [
            (p.full_tensor() if sharded else p).detach().float().cpu()
            for p in ts._leaves(state.params)])
    (la, pa), (lb, pb) = out[False], out[True]
    for a, b in zip(la, lb):
        assert abs(a - b) <= LOSS_RTOL * abs(a)
    far = n = 0
    for a, b in zip(pa, pb):
        d = (a - b).abs()
        assert float(d.max()) <= PARAM_MAX
        far += int((d > PARAM_FAR).sum())
        n += d.numel()
    assert far / n <= PARAM_FAR_SHARE


@pytest.mark.cuda
def test_dtensor_to_kernel_wrapper_raises_on_card(card_mesh):
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    before = (fa.launches, pa.launches_read)
    rep = [Replicate()] * card_mesh.ndim
    q = distribute_tensor(torch.zeros(1, 128, 4, 64, device="cuda",
                                      dtype=torch.bfloat16), card_mesh, rep)
    with pytest.raises(TypeError, match="DTensor"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="DTensor"):
        fa.flash_attention_fwd(q, q, q)
    qd = distribute_tensor(torch.zeros(2, 4, 64, device="cuda",
                                       dtype=torch.bfloat16), card_mesh, rep)
    pool = torch.zeros(4, 3, 16, 64, device="cuda", dtype=torch.bfloat16)
    table = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="DTensor"):
        pa.paged_attention(qd, pool, pool, table, lens)
    assert (fa.launches, pa.launches_read) == before


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["ring", "ulysses", "gpipe", "1f1b"])
def test_sp_pp_routes_equal_forward_on_card(card_mesh, route):
    """forward_sp (ring, Ulysses) and forward_pp (gpipe, 1f1b, M 2, flash)
    on the 1-rank mesh under ShardingRules.full(), debug-125m cut to 2
    layers in f32 (TF32 off; flash at S 256 runs the exact f32 K1/K3/K4):
    the logits within 1e-4 of forward's (attention of the same inputs in
    another order) and the loss's gradients within 1e-4 of forward's,
    relative to each leaf's largest element."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_params

    cfg = llama.PRESETS["debug-125m"].replace(
        n_layers=2, dtype=torch.float32, attn_impl="flash", remat=True)
    rules = ShardingRules.full()
    base = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 257)), device="cuda")
    x, y = toks[:, :-1], toks[:, 1:]
    mm = torch.backends.cuda.matmul
    tf32, mm.allow_tf32 = mm.allow_tf32, False
    try:
        out = {}
        for name in ("forward", route):
            p = ts._map(lambda t: t.requires_grad_(True), shard_params(
                card_mesh, base, llama.param_specs(cfg), rules))
            if name == "forward":
                logits = llama.forward(p, x, cfg, mesh=card_mesh,
                                       rules=rules)
            elif name in ("ring", "ulysses"):
                logits = llama.forward_sp(p, x, cfg.replace(attn_impl=name),
                                          card_mesh, rules=rules)
            else:
                logits = llama.forward_pp(p, x, cfg.replace(pp_schedule=name),
                                          card_mesh, num_microbatches=2,
                                          rules=rules)
            logits = logits.to_local()
            llama._nll(logits, y).mean().backward()
            out[name] = (logits.detach(), [t.grad.to_local() for t in
                                           ts._leaves(p)])
    finally:
        mm.allow_tf32 = tf32
    (lf, gf), (lr, gr) = out["forward"], out[route]
    assert float((lr - lf).abs().max()) <= 1e-4
    for a, b in zip(gr, gf):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
