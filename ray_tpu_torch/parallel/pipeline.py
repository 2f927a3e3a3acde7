"""Pipeline parallelism: microbatch pipelines over the 'pp' mesh axis.

Port of ``ray_tpu/parallel/pipeline.py``. Every stage runs the same
program; activations move stage to stage by P2P send/recv over the pp
axis' process group (``parallel.spmd``), as JAX's ``ppermute`` moves them
over ICI. Schedule: with M microbatches and P stages there are M + P - 1
ticks; stage p works on microbatch t - p at tick t (the fill/drain bubble
is (P-1)/M).

The model trunk is ``stage_fn(stage_params, x) -> x``; its params are
stacked on a leading stages dim (``stack_stages``: [L, ...] ->
[P, L/P, ...]) and stage p computes with slice p. Embedding and head run
outside the trunk, on every stage.

Torch has no autograd through ``dist.send/recv``, and JAX gets its backward
pipeline by differentiating a scan every stage runs every tick. Here each
schedule is explicit, forward and backward: the trunk is one
``torch.autograd.Function`` whose backward runs the reverse pipeline tick
by tick (cotangents sent stage p -> p - 1), so every stage makes the same
exchanges in the same order. The bubble ticks' compute, which JAX runs on
garbage and masks, is skipped, and so are their sends; results do not
change.

The trunk acts as a function of replicated inputs with a replicated
output (JAX's ``in_specs=(P("pp"), P())``, ``out_specs=P()`` seen from
outside the shard_map): the last stage's output is broadcast over pp, and
the backward returns the input's cotangent (stage 0's, broadcast) and the
stacked params' full gradients (each stage's slice, summed over pp) on
every stage. So params that rest replicated over pp (the reference's
``layers: None``) get whole gradients on every rank.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ray_tpu_torch.parallel import spmd


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """A dict / list / tuple tree of tensors as (leaves, rebuild)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [t for p in parts for t in p[0]]

    def rebuild(flat):
        out, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(flat[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def _grad_leaves(ts):
    return [t.detach().requires_grad_(t.is_floating_point()) for t in ts]


def _vjp(stage_fn, rebuild, params, inp, ct):
    """Recompute stage_fn at (params, inp) and pull ct back: (dx, dparams)."""
    with torch.enable_grad():
        ps = _grad_leaves(params)
        x = inp.detach().requires_grad_(True)
        out = stage_fn(rebuild(ps), x)
        return _pull(out, x, ps, ct)


def _pull(out, x, ps, ct):
    wrt = [x] + [p for p in ps if p.requires_grad]
    grads = torch.autograd.grad(out, wrt, ct.to(out.dtype), allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]
    it = iter(grads[1:])
    return grads[0], [next(it) if p.requires_grad else None for p in ps]


class _Schedule:
    """One trunk call's schedule on this stage: ``forward`` banks the last
    stage's outputs, ``backward`` runs the reverse pipeline. gpipe keeps
    each microbatch's autograd graph from the forward; 1f1b keeps only
    its input (the stash of exactly M microbatches) and recomputes the
    stage forward in the backward."""

    def __init__(self, stage_fn, axis: spmd.Axis, M: int, schedule: str):
        self.stage_fn, self.axis, self.M = stage_fn, axis, M
        self.keep_graphs = schedule == "gpipe"
        self.stage, self.pp = axis.index, axis.size

    def _valid(self, stage, t, lag) -> bool:
        return 0 <= t - lag < self.M if 0 <= stage < self.pp else False

    def microbatches(self, x):
        if x.shape[0] % self.M:
            raise ValueError(
                f"the pipeline splits the batch into {self.M} microbatches: "
                f"{x.shape[0]} rows do not divide (num_microbatches)")
        return x.reshape((self.M, x.shape[0] // self.M) + x.shape[1:])

    def forward(self, x, params, rebuild, need_grad: bool):
        s, pp, M = self.stage, self.pp, self.M
        xs = self.microbatches(x)
        act, outs, saved = None, [None] * M, [None] * M
        for t in range(M + pp - 1):
            out = None
            if self._valid(s, t, s):
                m = t - s
                inp = xs[m] if s == 0 else act
                if need_grad and self.keep_graphs:
                    with torch.enable_grad():
                        ps = _grad_leaves(params)
                        xin = inp.detach().requires_grad_(True)
                        y = self.stage_fn(rebuild(ps), xin)
                    saved[m] = (xin, ps, y)
                    out = y.detach()
                else:
                    out = self.stage_fn(rebuild(params), inp)
                    if need_grad:
                        saved[m] = inp
                out = out.to(x.dtype)
                if s == pp - 1:
                    outs[m] = out
            # ship the activation to the next stage (no wraparound)
            act = spmd.shift(
                out if s < pp - 1 and out is not None else None, s + 1,
                xs[0] if self._valid(s - 1, t, s - 1) else None, s - 1,
                self.axis)
        y = torch.cat(outs) if s == pp - 1 else torch.empty_like(x)
        return spmd.broadcast(y, pp - 1, self.axis), saved

    def backward(self, g, params, rebuild, saved):
        s, pp, M = self.stage, self.pp, self.M
        gs = self.microbatches(g)
        ct, dxs = None, [None] * M
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        lag = pp - 1 - s
        for t in range(M + pp - 1):
            dx = None
            if self._valid(s, t, lag):
                # microbatch m's cotangent leaves the last stage at tick m
                # and reaches stage s (pp-1-s) ticks later
                m = t - lag
                c = gs[m] if s == pp - 1 else ct
                if self.keep_graphs:
                    xin, ps, y = saved[m]
                    dx, dps = _pull(y, xin, ps, c)
                else:
                    dx, dps = _vjp(self.stage_fn, rebuild, params, saved[m],
                                   c)
                saved[m] = None
                for a, d in zip(acc, dps):
                    if d is not None:
                        a.add_(d.float())
                if s == 0:
                    dxs[m] = dx
            ct = spmd.shift(
                dx if s > 0 and dx is not None else None, s - 1,
                gs[0] if self._valid(s + 1, t, lag - 1) else None, s + 1,
                self.axis)
        dx = torch.cat(dxs) if s == 0 else torch.empty_like(g)
        return spmd.broadcast(dx, 0, self.axis), acc


def _stacked_grads(stacked, stage, acc, axis):
    """Each stacked leaf's full gradient: this stage's slice from `acc`,
    the other stages' from their ranks (one all-reduce over pp). One
    stage: `acc` is the whole gradient."""
    if axis.size == 1:
        return [d[None].to(a.dtype) for d, a in zip(acc, stacked)]
    full = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            for a in stacked]
    for f, a in zip(full, acc):
        f[stage] = a
    flat = torch.cat([f.reshape(-1) for f in full])
    spmd.all_reduce(flat, axis)
    out, i = [], 0
    for f, a in zip(full, stacked):
        out.append(flat[i:i + f.numel()].view(f.shape).to(a.dtype))
        i += f.numel()
    return out


class _Trunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, rebuild, x, *stacked):
        params = [a[sched.stage] for a in stacked]
        need = any(ctx.needs_input_grad[2:])
        y, saved = sched.forward(x, params, rebuild, need)
        ctx.sched, ctx.rebuild, ctx.saved = sched, rebuild, saved
        if need:
            ctx.save_for_backward(*stacked)
        return y

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        stacked = ctx.saved_tensors
        params = [a[sched.stage] for a in stacked]
        dx, acc = sched.backward(g.contiguous(), params, ctx.rebuild,
                                 ctx.saved)
        ctx.saved = None
        grads = _stacked_grads(stacked, sched.stage, acc, sched.axis)
        return (None, None, dx, *grads)


def pipeline_trunk(stage_fn: Callable, mesh, num_microbatches: int,
                   schedule: str = "gpipe"):
    """Returns trunk(stacked_params, x) -> y running the chosen schedule.

    stacked_params: a tree (dicts, lists) of tensors, each leaf
    [P_stages, ...], whole on every stage; stage p computes with slice p.
    x: [B, ...] activations entering stage 0 (this rank's rows, the same on
    every stage); y: the same shape leaving the last stage, on every stage.
    ``mesh=None`` is one stage.

    schedule:
      "gpipe" — the forward keeps each microbatch's autograd graph (every
        activation of every microbatch, O(M) per stage) and the backward
        back-propagates through them in the reverse pipeline.
      "1f1b"  — the explicit schedule of the reference's custom vjp
        (Megatron-LM PipeDream-flush style): each stage stashes exactly its
        M microbatch INPUTS and recomputes the stage forward in the
        backward (remat). Forward and backward stay separate phases (the
        loss head lives outside the trunk); for the interleaved steady
        state use ``pipeline_train_1f1b``.
    Both give the same values and gradients.
    """
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule must be 'gpipe' or '1f1b', "
                         f"got {schedule!r}")
    axis = spmd.Axis.of(mesh, "pp")

    def trunk(stacked_params, x):
        leaves, rebuild = _flatten(stacked_params)
        for a in leaves:
            if a.shape[0] != axis.size:
                raise ValueError(f"stacked params lead with {a.shape[0]} "
                                 f"stages, the pp axis has {axis.size}")
        sched = _Schedule(stage_fn, axis, num_microbatches, schedule)
        return _Trunk.apply(sched, rebuild, x, *leaves)

    return trunk


def pipeline_train_1f1b(stage_fn: Callable, head_loss_fn: Callable, mesh,
                        num_microbatches: int):
    """TRUE interleaved 1F1B (Megatron-LM PipeDream-flush): one scheduled
    program computes loss AND grads, with the backward of microbatch f
    starting the tick after its forward leaves the last stage — steady
    state alternates one forward and one backward per stage.

    head_loss_fn runs ON the last stage at each forward tick and its
    cotangent enters the reverse pipeline the next tick. Peak stash is a
    min(pp, M)-deep ring of microbatch inputs.

    Schedule (0-indexed): stage p runs fwd of microbatch f at tick
    p + 2f and bwd of f at tick (2*pp - 1 - p) + 2f; fwd/bwd ticks have
    opposite parity per stage, so each tick is at most one unit of work.
    Total ticks 2M + 2pp - 2; bubble (pp-1)/M, as GPipe's.

    Args:
      stage_fn(stage_params, x) -> y               (trunk slice)
      head_loss_fn(head_params, y_mb, target_mb) -> scalar (per-mb loss)
    Returns:
      step(stacked_params, head_params, x, targets)
        -> (loss, d_stacked, d_head, dx)
      loss = mean over microbatches; d_stacked matches stacked_params
      ([pp, ...], every stage's slice, on every stage); dx is the
      cotangent w.r.t. x (for an embedding outside the pipeline). Every
      result is on every stage. No autograd graph is built around it.
    """
    axis = spmd.Axis.of(mesh, "pp")
    pp, M = axis.size, num_microbatches
    W = min(pp, M)                       # stash ring depth
    ticks = 2 * M + 2 * pp - 2

    def fwd_tick(stage, t):
        tf = t - stage
        ok = 0 <= stage < pp and tf >= 0 and tf % 2 == 0 and tf // 2 < M
        return ok, tf // 2

    def bwd_tick(stage, t):
        tb = t - (2 * pp - 1 - stage)
        ok = 0 <= stage < pp and tb >= 0 and tb % 2 == 0 and tb // 2 < M
        return ok, tb // 2

    @torch.no_grad()
    def step(stacked_params, head_params, x, targets):
        stacked, rebuild = _flatten(stacked_params)
        head, rebuild_head = _flatten(head_params)
        s = axis.index
        last = pp - 1
        params = [a[s] for a in stacked]
        sched = _Schedule(stage_fn, axis, M, "1f1b")
        xs, ts = sched.microbatches(x), sched.microbatches(targets)
        stash = [None] * W
        act_in = ct_in = dy_buf = None
        dxs = [None] * M
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        dhead = [torch.zeros_like(h, dtype=torch.float32) for h in head]
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(ticks):
            do_fwd, f = fwd_tick(s, t)
            do_bwd, fb = bwd_tick(s, t)
            y = dx = None
            if do_fwd:
                inp = xs[f] if s == 0 else act_in
                y = stage_fn(rebuild(params), inp).to(x.dtype)
                # stash this fwd's input for its backward (ring slot f mod W)
                stash[f % W] = inp
                if s == last:
                    with torch.enable_grad():
                        hp = _grad_leaves(head)
                        y_ = y.detach().requires_grad_(True)
                        loss_mb = head_loss_fn(rebuild_head(hp), y_, ts[f])
                        dy, dhs = _pull(loss_mb, y_, hp,
                                        torch.ones_like(loss_mb))
                    loss = loss + loss_mb.detach().float()
                    for a, d in zip(dhead, dhs):
                        if d is not None:
                            a.add_(d.float())
                    dy_buf = dy
            if do_bwd:
                c = dy_buf if s == last else ct_in
                dx, dps = _vjp(stage_fn, rebuild, params, stash[fb % W], c)
                for a, d in zip(acc, dps):
                    if d is not None:
                        a.add_(d.float())
                if s == 0:
                    dxs[fb] = dx
            # the exchange: activations forward, cotangents back
            sends = ([(y, s + 1)] if do_fwd and s < last else []) + \
                ([(dx, s - 1)] if do_bwd and s > 0 else [])
            get_act, get_ct = fwd_tick(s - 1, t)[0], bwd_tick(s + 1, t)[0]
            got = spmd.sendrecv(sends, ([(xs[0], s - 1)] if get_act else [])
                                + ([(xs[0], s + 1)] if get_ct else []), axis)
            if get_act:
                act_in = got[0]
            if get_ct:
                ct_in = got[-1]
        # owners: loss/dhead live on the last stage, dxs on stage 0
        loss = spmd.broadcast(loss, last, axis) / M
        dhead = [spmd.broadcast(d, last, axis) / M for d in dhead]
        dx = torch.cat(dxs) if s == 0 else torch.empty_like(x)
        dx = spmd.broadcast(dx, 0, axis) / M
        d_stacked = _stacked_grads(stacked, s, [a / M for a in acc], axis)
        return (loss, rebuild(d_stacked),
                rebuild_head([d.to(h.dtype) for d, h in zip(dhead, head)]),
                dx)

    return step


def stack_stages(layers_params, pp: int):
    """Reshape stacked per-layer params [L, ...] -> [pp, L//pp, ...]."""
    leaves, rebuild = _flatten(layers_params)
    out = []
    for a in leaves:
        L = a.shape[0]
        if L % pp:
            raise ValueError(f"n_layers {L} not divisible by pp={pp}")
        out.append(a.reshape((pp, L // pp) + tuple(a.shape[1:])))
    return rebuild(out)


def unstack_stages(stacked):
    leaves, rebuild = _flatten(stacked)
    return rebuild([a.reshape((-1,) + tuple(a.shape[2:])) for a in leaves])
