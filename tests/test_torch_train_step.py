"""Parity of the port's training path (``ray_tpu_torch/models/llama.py``
``forward`` / ``loss_fn`` and ``ray_tpu_torch/parallel/train_step.py``)
against ``ray_tpu`` on the ``tiny`` preset in f32, with the same weights
(the JAX init, carried over by ``params_from_jax``) and the same numpy
tokens.

The JAX side runs as its own tests run it on the CPU: the flash route's
Pallas kernels (K1 forward, K3/K4 backward) in interpret mode. Tolerances
(f32 sums of width 64-256 in another order, through 2 layers):
logits and losses within 1e-4; gradients within 1e-4 absolute plus 1e-3
relative (the largest gradients, of the embedding rows and lm_head, reach
~1); the 3-step AdamW trajectory within 1e-4 on loss and grad_norm and
1e-5 on the params (each step moves a param by at most lr = 3e-4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_support import (REPO, jax_reference, jax_tree_to_np,
                                require_cuda, to_np)

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import train_step as ts

TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
PARAM_TOL = 1e-5


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def tiny(jax):
    """(JAX cfg, port cfg, numpy params) of the tiny preset in f32."""
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jax.numpy.float32)
        params = jax_tree_to_np(ref.llama.init_params(
            jax.random.PRNGKey(0), jcfg))
    tcfg = llama.PRESETS["tiny"].replace(dtype=torch.float32)
    return jcfg, tcfg, params


def _tokens(seed, shape=(2, 129)):
    return np.random.default_rng(seed).integers(
        0, 256, size=shape).astype(np.int32)


def _grad_params(params):
    """The numpy params as CPU leaf tensors that require grad."""
    return ts._map(lambda t: t.requires_grad_(True),
                   llama.params_from_jax(params, "cpu"))


def _assert_tree_close(ours, theirs, atol, rtol):
    if isinstance(theirs, dict):
        for k in theirs:
            _assert_tree_close(ours[k], theirs[k], atol, rtol)
        return
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("attn_impl,S,pos_offset", [
    ("xla", 128, 0), ("flash", 128, 0), ("xla", 16, 7)])
def test_forward_logits_match_jax(tiny, attn_impl, S, pos_offset):
    jcfg, tcfg, params = tiny
    toks = _tokens(1, (2, S))
    with jax_reference() as ref:
        jl = np.asarray(ref.llama.forward(
            params, toks, jcfg.replace(attn_impl=attn_impl),
            pos_offset=pos_offset))
    tl = llama.forward(llama.params_from_jax(params, "cpu"),
                       torch.from_numpy(toks),
                       tcfg.replace(attn_impl=attn_impl),
                       pos_offset=pos_offset)
    assert tl.dtype == torch.float32 and tl.shape == (2, S, 256)
    np.testing.assert_allclose(to_np(tl), jl, atol=TOL, rtol=0)


@pytest.mark.parametrize("form,masked", [("tokens", False), ("tokens", True),
                                         ("inputs", False), ("inputs", True)])
def test_loss_fn_matches_jax(tiny, form, masked):
    jcfg, tcfg, params = tiny
    toks = _tokens(2)
    rng = np.random.default_rng(3)
    if form == "tokens":
        batch = {"tokens": toks}
        if masked:
            batch["mask"] = rng.integers(0, 2, size=toks.shape).astype(
                np.int32)
    else:
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if masked:
            batch["mask"] = rng.integers(0, 2, size=(2, 128)).astype(
                np.float32)
    cfg_j, cfg_t = jcfg.replace(attn_impl="flash"), tcfg.replace(
        attn_impl="flash")
    with jax_reference() as ref:
        jloss = float(ref.llama.loss_fn(params, batch, cfg_j))
    tloss = llama.loss_fn(llama.params_from_jax(params, "cpu"),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          cfg_t)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss) - jloss) <= TOL


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("remat,policy", [(False, "none"), (True, "none"),
                                          (True, "dots")])
def test_loss_grads_match_jax(tiny, jax, attn_impl, remat, policy):
    """grads of loss_fn against jax.grad, with remat off, "none" and
    "dots"; the flash route's JAX backward is the Pallas K3/K4."""
    jcfg, tcfg, params = tiny
    batch = {"tokens": _tokens(4)}
    kw = dict(attn_impl=attn_impl, remat=remat, remat_policy=policy)
    with jax_reference() as ref:
        jcfg2 = jcfg.replace(**kw)
        jloss, jg = jax.value_and_grad(
            lambda p: ref.llama.loss_fn(p, batch, jcfg2))(params)
        jg = jax_tree_to_np(jg)
    tp = _grad_params(params)
    tloss = llama.loss_fn(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                          tcfg.replace(**kw))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL
    _assert_tree_close(ts._map(lambda t: t.grad, tp), jg, GRAD_ATOL,
                       GRAD_RTOL)


def test_remat_recompute_gives_the_same_grads(tiny):
    """Non-reentrant checkpoint reruns each layer's forward in the
    backward (the flash Function included); the plain versions have no
    atomics, so the grads equal the no-remat grads up to f32 rounding."""
    _, tcfg, params = tiny
    toks = torch.from_numpy(_tokens(5))
    grads = []
    for kw in (dict(remat=False), dict(remat=True, remat_policy="none"),
               dict(remat=True, remat_policy="dots")):
        tp = _grad_params(params)
        llama.loss_fn(tp, {"tokens": toks},
                      tcfg.replace(attn_impl="flash", **kw)).backward()
        grads.append(ts._map(lambda t: t.grad, tp))
    for g in grads[1:]:
        for a, b in zip(ts._leaves(g), ts._leaves(grads[0])):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_unknown_remat_policy_raises(tiny):
    _, tcfg, params = tiny
    with pytest.raises(ValueError, match="remat_policy"):
        llama.loss_fn(llama.params_from_jax(params, "cpu"),
                      {"tokens": torch.from_numpy(_tokens(6))},
                      tcfg.replace(remat_policy="everything"))


def test_train_trajectory_matches_jax(tiny, jax):
    """3 steps of the port's make_train_step + adamw(3e-4,
    weight_decay=0.01) against JAX make_train_step + optax.adamw on a
    one-device mesh, flash route: per-step loss and grad_norm, and the
    params after step 3."""
    import optax

    jcfg, tcfg, params = tiny
    jcfg, tcfg = (c.replace(attn_impl="flash") for c in (jcfg, tcfg))
    toks = _tokens(7)
    with jax_reference() as ref:
        mesh = ref.mesh.build_mesh(ref.mesh.MeshSpec(dp=-1),
                                   devices=jax.devices()[:1])
        rules = ref.sharding.ShardingRules.dp()
        opt = optax.adamw(3e-4, weight_decay=0.01)
        jp = jax.tree.map(jax.numpy.asarray, params)
        init_fn, state_sh = ref.train_step.make_train_state_init(
            lambda k: jp, opt, mesh, rules, ref.llama.param_specs(jcfg))
        state = init_fn(jax.random.PRNGKey(0))
        step = ref.train_step.make_train_step(
            lambda p, b: ref.llama.loss_fn(p, b, jcfg), opt, mesh, rules,
            state_sh)
        jm = []
        for _ in range(3):
            state, m = step(state, {"tokens": jax.numpy.asarray(toks)})
            jm.append((float(m["loss"]), float(m["grad_norm"]),
                       int(m["step"])))
        jparams = jax_tree_to_np(state.params)

    init, sh = ts.make_train_state_init(
        lambda g: llama.params_from_jax(params, "cpu"),
        ts.adamw(3e-4, weight_decay=0.01), device="cpu")
    assert sh is None
    tstate = init(0)
    tstep = ts.make_train_step(lambda p, b: llama.loss_fn(p, b, tcfg))
    for loss, gnorm, n in jm:
        tstate, m = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert m["step"] == n == tstate.step
        assert abs(float(m["loss"]) - loss) <= TOL
        assert abs(float(m["grad_norm"]) - gnorm) <= TOL
    assert jm[-1][0] < jm[0][0]
    _assert_tree_close(tstate.params, jparams, PARAM_TOL, 0)


def test_adamw_defaults_match_optax(jax):
    """``adamw(lr)`` keeps optax's defaults (weight_decay 1e-4, not
    torch's 1e-2): 5 updates of random params by random grads agree within
    1e-5 (each step moves a param by ~lr = 0.1; the two compute
    m / (sqrt(v) + eps) in another order, ~1e-5 relative apart)."""
    import optax

    rng = np.random.default_rng(8)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    opt = optax.adamw(0.1)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    st = opt.init(jp)
    for g in grads:
        upd, st = opt.update({k: jax.numpy.asarray(v) for k, v in g.items()},
                             st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p0.items()}
    topt = ts.adamw(0.1)(ts._leaves(tp))
    assert topt.defaults["weight_decay"] == 1e-4
    for g in grads:
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(to_np(tp[k]), np.asarray(jp[k]),
                                   atol=1e-5, rtol=0)


def test_eval_step_and_global_norm(tiny):
    _, tcfg, params = tiny
    init, _ = ts.make_train_state_init(
        lambda g: llama.params_from_jax(params, "cpu"), ts.adamw(1e-3),
        device="cpu")
    state = init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(_tokens(9))}
    ev = ts.make_eval_step(lambda p, b: llama.loss_fn(p, b, tcfg))
    loss = ev(state, batch)
    assert not loss.requires_grad
    with torch.no_grad():
        assert float(loss) == float(llama.loss_fn(state.params, batch, tcfg))
    tree = {"a": torch.tensor([3.0]), "b": [torch.tensor([[4.0]])]}
    assert float(ts.optax_global_norm(tree)) == 5.0


def test_mesh_raises_not_implemented(tiny, monkeypatch):
    """Routing and what the sharded path does not run: loss_fn sends
    ring/Ulysses attention with sp > 1 to forward_sp and pp > 1 to
    forward_pp (stand-ins here record the call); ``forward`` itself
    computes whole sequences, so rules that shard the sequence over sp
    raise there, naming forward_sp; a mesh whose axis sizes do not divide
    a dim names the dim. (Sizes are read from a MeshSpec: no process group
    needed.)"""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_params

    _, tcfg, params = tiny
    tp = llama.params_from_jax(params, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(8))}
    rules = ShardingRules.fsdp_tp()
    routed = []

    class Routed(Exception):
        pass

    def stand_in(name):
        def route(*args, **kwargs):
            routed.append(name)
            raise Routed(name)
        return route

    monkeypatch.setattr(llama, "forward_sp", stand_in("forward_sp"))
    monkeypatch.setattr(llama, "forward_pp", stand_in("forward_pp"))
    for impl in ("ring", "ulysses"):
        with pytest.raises(Routed):
            llama.loss_fn(tp, batch, tcfg.replace(attn_impl=impl),
                          mesh=MeshSpec(sp=2), rules=rules)
    with pytest.raises(Routed):
        llama.loss_fn(tp, batch, tcfg, mesh=MeshSpec(pp=2), rules=rules)
    assert routed == ["forward_sp", "forward_sp", "forward_pp"]
    with pytest.raises(NotImplementedError, match="runs in forward_sp"):
        llama.forward(tp, batch["tokens"], tcfg, mesh=MeshSpec(sp=2),
                      rules=ShardingRules.full())
    with pytest.raises(ValueError, match="tp=3 does not divide n_heads=4"):
        llama.forward(tp, batch["tokens"], tcfg, mesh=MeshSpec(tp=3),
                      rules=rules)
    with pytest.raises(ValueError, match=r"dim 0 of shape \(256, 64\)"):
        shard_params(MeshSpec(tp=3), tp, llama.param_specs(tcfg), rules)
    with pytest.raises(ValueError, match="rules="):
        ts.make_train_step(lambda p, b: 0.0, mesh=MeshSpec(dp=2))
    with pytest.raises(ValueError, match="mesh= and rules="):
        llama.forward(tp, batch["tokens"], tcfg, rules=rules)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    """device=None means the card; without CUDA it raises, and only an
    explicit "cpu" runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.make_train_state_init(lambda g: {}, ts.adamw(1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_paged_cache(cfg, 4, 8)
    kp, _ = llama.init_paged_cache(cfg, 4, 8, device="cpu")
    assert kp.device.type == "cpu"


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port, parallel included (spmd and
    pipeline too, and the sequence-parallel ops and the MoE, ViT and
    registry models), in a fresh interpreter loads neither jax nor any
    non-port ray_tpu module."""
    code = (
        "import sys, pkgutil, importlib, ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import ray_tpu_torch.parallel.train_step\n"
        "import ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding\n"
        "import ray_tpu_torch.parallel.presets\n"
        "import ray_tpu_torch.parallel.spmd, ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.ops.ring_attention, ray_tpu_torch.ops.ulysses\n"
        "import ray_tpu_torch.models.moe, ray_tpu_torch.models.vit\n"
        "import ray_tpu_torch.models.registry\n"
        "from ray_tpu_torch.parallel import MeshSpec, sharded_jit\n"
        "from ray_tpu_torch.parallel import pipeline_trunk, spmd\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'ray_tpu' or "
        "k.startswith('ray_tpu.'))\n"
        "print(len([k for k in sys.modules if k.startswith("
        "'ray_tpu_torch.')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]" and int(n) >= 13


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_flash_route_grads_match_plain_route_on_card(policy):
    """On the card, f32 without TF32: grads of loss_fn through the flash
    kernels (K1, K3, K4) against the same model with attn_impl="xla"
    (plain attention), 2 layers, head dim 64, under both remat policies
    (the selective "dots" checkpoint reruns the kernels' Function too)."""
    require_cuda()
    mm = torch.backends.cuda.matmul
    tf32 = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        cfg = llama.LlamaConfig(vocab_size=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq_len=256, dtype=torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(0)
        base = llama.init_params(gen, cfg)
        toks = torch.randint(0, 512, (2, 257), device="cuda",
                             generator=gen)
        grads = {}
        for impl in ("flash", "xla"):
            p = ts._map(lambda t: t.detach().clone().requires_grad_(True),
                        base)
            llama.loss_fn(p, {"tokens": toks},
                          cfg.replace(attn_impl=impl,
                                      remat_policy=policy)).backward()
            grads[impl] = ts._leaves(ts._map(lambda t: t.grad, p))
    finally:
        mm.allow_tf32 = tf32
    for a, b in zip(grads["flash"], grads["xla"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
