#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA;
2. build: the kernels from ray_tpu_torch/csrc, one nvcc each, in parallel;
3. k6 / k5 / k1: each kernel against its plain PyTorch version on the card,
   at the 7b serving shapes and at a GQA shape (the 1b preset; K1 also
   debug-125m's head dim 64 and ragged S, T > S), in bf16 and f32, held
   elementwise within the bound of the ops module's ``kernel_tolerance``;
   for K6 the pools after the write too (every byte equal to the plain
   version's, and only the new rows changed), for K5 the pools unchanged
   byte for byte and K5 over the pools K6 just wrote against K6's output;
   for K1 the profiler's kernel names (bf16 at head dims 64/128 runs the
   TMA/wgmma kernel and nothing else); times of the kernel (CUPTI device
   time, and CUDA events), the plain version and (K1) SDPA with the names
   of its kernels, beside the bound;
4. card_vs_cpu: the 7b width cut to 2 layers, f32, the same weights in the
   port's paged LLMEngine on the card (kernels) and on the CPU (plain
   versions): greedy tokens identical, first-step logits within a stated
   bound;
5. engine: the paged serving path, LLMEngine on the 7b preset, all 32
   layers, bf16, random seeded weights, paged KV (page 64, 16 slots, 2048
   tokens), flash prefill, 12 requests of 64-1000 prompt tokens (4 sharing
   a 512-token prefix), 64 new tokens each, driven by step_n(8); the launch
   counters are set to 0 just before it and read just after. Then, with 16
   slots still live at ~1000 tokens, the K5 path: ``paged_attention`` on
   all 32 layers of the engine's pools, each held against the plain
   version (its launch counter zeroed just before);
6. card_vs_cpu_contiguous: 2 layers at the 7b width, f32, greedy tokens
   identical card vs CPU in the contiguous layout, contiguous vs paged on
   the card, int8 card vs CPU, and ``sliding_window=64`` with flash card vs
   CPU (the serving run on which K2 launches); ``forward_with_cache`` at
   offset 0 (K1 over the whole cache row) card vs CPU;
7. engine_contiguous: the JAX engine's default configuration, the 7b preset
   at all 32 layers, bf16, contiguous KV, int8 weights, flash prefill, 16
   slots, max_seq 2048, the engine phase's 12 requests: int8 bytes at rest,
   the setup's peak memory against them (and the int8 init's alone),
   peak memory, decode tokens/s, TTFT and a decode block's profile;
8. k2 / k3k4: the sliding-window forward (K2, checked as K1 is) and the
   backward kernels (K3 dQ, K4 dK/dV) against their plain versions at the
   1b train shape and others, in bf16 and f32, within ``kernel_tolerance`` /
   ``grad_tolerance``; CUPTI device times and CUDA events beside the
   bound, the plain version and SDPA (with a band mask; its backward), and
   the kernels' names (bf16 K3 and K4 at head dim 64 or 128 must run the
   TMA/wgmma dQ and dK/dV kernels and nothing else);
9. train_card_vs_cpu: 2 layers at the 1b width, f32, 2 AdamW steps on the
   card and on the CPU from one init, without and with a sliding window
   (the run on which K2 launches): losses, grad norms and params within
   stated bounds;
10. train: the training main path, the 1b preset at full width and 16
   layers, bf16 compute, remat, flash, B 8 S 1024, 10 steps after a
   warm-up: falling finite losses, exact K1/K3/K4 launch counts, step time,
   tokens/s, MFU, peak memory and one step's device profile (whose forward
   attention kernels must all be the TMA/wgmma one, as in the engines'
   prefill profiles, and its dQ and dK/dV kernels the TMA/wgmma ones);
11. train_sharded: the train phase's recipe through the sharded entry
   points (make_train_state_init / make_train_step / loss_fn with mesh=
   a 1-rank NCCL mesh and rules=ShardingRules.fsdp_tp()): losses within
   TRAIN_SHARDED_LOSS_RTOL of the train phase's, its exact launch counts,
   only the three TMA/wgmma flash kernels in a step's profile, params and
   AdamW moments as DTensors; step time, tokens/s and peak memory;
12. engine_sharded: the engine phase's paged 7b engine with mesh= (1 rank)
   and rules=fsdp_tp over the engine phase's first wave: every greedy
   request's tokens equal to the engine phase's; decode tokens/s and peak
   memory. On one rank every placement is Replicate: these two prove the
   mesh plumbing and the kernels under it, not collectives;
13. kernels: one line with every kernel's numbers;
then the card's nvidia-smi line, and last ``{"ok": true, "device": ...}``.

Any failed phase stops the run with a non-zero exit and no ``ok`` line.
Without CUDA, or outside a checkout, it exits non-zero at once. Details go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): the least time for a kernel's
# work is the larger of bytes / HBM rate and operations / peak for the type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel-vs-plain outputs are held elementwise within each ops module's
# kernel_tolerance (its docstring derives the bound). The LSE is f32 in
# both, from f32 scores of the same inputs, in either dtype.
LSE_TOL = 1e-4
# card vs CPU, 2 layers at the 7b width in f32 (no TF32): first-step
# logits of magnitude ~1 after 4096- and 11008-long f32 sums
LOGITS_TOL = 1e-3
# training card vs CPU, 2 layers at the 1b width in f32 (no TF32): the loss
# (~10.4) and the grad norm are f32 sums in another order, ~1e-6 relative
# apart. An AdamW step moves a param by at most ~lr (m_hat / sqrt(v_hat)
# is at most ~1 in the first steps), so after 2 steps no param can differ
# by more than 4 lr, which a gradient of either sign near 0 may reach
# (its normalised step flips). Elements further apart than 1e-5 (far
# above f32 rounding of a 3e-4 step) must be that rare kind: at most 1e-4
# of them.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_MAX = 4 * 3e-4
TRAIN_PARAM_FAR = 1e-5
TRAIN_PARAM_FAR_SHARE = 1e-4
# an int8 init's peak over what it leaves at rest (int8 weights, and the
# engine's KV cache): one 2-D weight's f32 copy (0.52 GB for the 7b
# embedding), never the float tree
SETUP_PEAK_MARGIN_GB = 1.0

# the sharded train step on a 1-rank mesh against the train phase: every
# placement is Replicate, so the step runs the train phase's kernels in
# its order; only the loss is a sum over the global token count where the
# unsharded one is a mean (its last bit). The losses must agree within
# 1e-5 relative (f32 rounding of the ~10-to-2 losses, with headroom)
TRAIN_SHARDED_LOSS_RTOL = 1e-5

RESULTS: dict = {"phases": {}}


def emit(phase: str, **data) -> None:
    RESULTS["phases"][phase] = data
    print(json.dumps({"phase": phase, **data}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds of fn() over `iters` runs after a warm-up, on CUDA
    events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, names=None, per_call=None) -> float:
    """Mean device milliseconds of the kernels one fn() call launches
    (CUPTI, under torch.profiler), after a warm-up: the kernels' own time,
    which cuda_ms cannot give when launching a call takes the host longer
    than the card takes to run it (the paged kernels, ~0.08 ms). The
    kernels' names (from every trace taken) are added to the set `names`
    where one is given. CUPTI now and then drops kernels from a trace, and
    late in a long run it can drop every kernel of a few traces in a row:
    where `per_call` (the kernels one call launches) is given, a trace
    with another count is taken again, up to 10 times; otherwise a trace
    with none is, up to 3 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3 if per_call is None else 10):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = list(kernel_events(prof))
        if names is not None:
            names.update(name for name, _ in events)
        if (len(events) == per_call * iters if per_call is not None
                else events):
            break
    return sum(ms for _, ms in events) / iters


def kernel_events(prof):
    """(name, device ms) of every kernel a profile traced."""
    import torch

    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False):
            # a record_function range on the device timeline (such as
            # "Optimizer.step#AdamW.step"), not a kernel: it would count
            # its kernels twice
            continue
        yield ev.name, ev.time_range.elapsed_us() / 1e3   # one kernel


def ptxas_report(log: Path) -> dict:
    """{kernel entry: "registers, spills"} from nvcc's -Xptxas -v log, and
    under "notes" every warning or performance note (a setmaxnreg that
    ptxas ignored, wgmma serialised)."""
    import re

    out, name = {}, None
    for ln in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if re.search(r"warning|setmaxnreg|serialized|Performance Loss", ln,
                     re.IGNORECASE):
            out.setdefault("notes", []).append(ln.strip())
        if m:
            name = m.group(1)
        elif name and "spill stores" in ln:
            out[name] = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            out[name] = (out.get(name, "") + "; "
                         + ln.split(":", 1)[1].strip()).strip("; ")
    return out


def held(out, plain, tol, rows=None):
    """(max |out - plain|, max |out - plain| / tol) over the compared rows."""
    d = (out.float() - plain.float()).abs()
    if rows is not None:
        d, tol = d[rows], tol[rows]
    return float(d.max()), float((d / tol).max())


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# --- K6: fused paged decode write-and-attend --------------------------------


def paged_inputs(*, S, H, KV, HD, ps, maxP, dtype, seed):
    """Inputs of a K6 or K5 case on the card. Lengths cover the hard cases:
    a length-0 slot, tips that start a fresh page (length % ps == 1),
    slots ending on a page boundary (length % ps == 0), and two slots
    sharing prefix pages. Returns (q, k_new, v_new, k_pool, v_pool,
    page_table, lengths) and the lengths as numpy."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    max_len = maxP * ps
    lengths = rng.integers(64, min(max_len, 1064) + 1, size=S)
    special = [0, ps + 1, 2 * ps, 1, max_len, 5 * ps]
    lengths[:min(S, len(special))] = special[:min(S, len(special))]
    # distinct pages per slot (page 0 is the trash page), then slot S-1
    # shares slot S-2's first two full pages (a prefix-cache hit)
    NP = S * maxP + 1
    perm = rng.permutation(np.arange(1, NP))
    table = perm[:S * maxP].reshape(S, maxP).astype(np.int32)
    if S >= 2:
        lengths[S - 2] = max(lengths[S - 2], 3 * ps)
        lengths[S - 1] = max(lengths[S - 1], 3 * ps)
        table[S - 1, :2] = table[S - 2, :2]
    lengths = lengths.astype(np.int32)

    def t(x, d=dt):
        return torch.as_tensor(x).to(device="cuda", dtype=d)

    return (t(rng.standard_normal((S, H, HD))),
            t(rng.standard_normal((S, KV, HD))),
            t(rng.standard_normal((S, KV, HD))),
            t(rng.standard_normal((KV, NP, ps, HD))),
            t(rng.standard_normal((KV, NP, ps, HD))),
            t(table, torch.int32), t(lengths, torch.int32)), lengths


def k6_case(*, S, H, KV, HD, ps, maxP, dtype, seed):
    """One K6 comparison on paged_inputs."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    (q, kn, vn, kp0, vp0, pt, ln), lengths = paged_inputs(
        S=S, H=H, KV=KV, HD=HD, ps=ps, maxP=maxP, dtype=dtype, seed=seed)
    kp, vp = kp0.clone(), vp0.clone()
    before = pa.launches
    o, _, _ = pa.paged_decode_attention_inplace(q, kn, vn, kp, vp, pt, ln)
    kp_ref, vp_ref = kp0.clone(), vp0.clone()
    o_ref, _, _ = pa.paged_decode_attention_inplace_reference(
        q, kn, vn, kp_ref, vp_ref, pt, ln)
    torch.cuda.synchronize()
    if pa.launches != before + 1:
        raise AssertionError("K6 wrapper did not launch its kernel")
    live = torch.as_tensor(lengths > 0, device="cuda")
    err, over = held(o, o_ref, pa.kernel_tolerance(o_ref), live)
    if not bool(torch.isfinite(o.float()[live]).all()):
        raise AssertionError("K6 output is not finite")
    pools_equal = bool(torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref))
    # only the new rows changed: one row per live slot and kv head
    changed = int((kp != kp0).any(-1).sum() + (vp != vp0).any(-1).sum())
    expect_changed = 2 * KV * int((lengths > 0).sum())
    dead_zero = bool((o[~live] == 0).all()) if (~live).any() else True
    res = {"shape": f"S={S} H={H} KV={KV} HD={HD} ps={ps} maxP={maxP}",
           "dtype": dtype, "max_abs_err": err, "max_err_over_tol": over,
           "tol": "1e-4" if dtype == "float32" else "2^-7 |plain| + 1e-5",
           "pools_equal_plain": pools_equal, "rows_changed": changed,
           "rows_expected": expect_changed, "dead_slots_zero": dead_zero}
    ok = (over <= 1.0 and pools_equal and changed == expect_changed
          and dead_zero)
    def run():
        pa.paged_decode_attention_inplace(q, kn, vn, kp, vp, pt, ln)

    res["kernel_ms"] = device_ms(run)
    res["event_ms"] = cuda_ms(run, iters=50)   # bound by the host's launches
    pa.launches = before   # timing launches are not main-path launches
    res["plain_ms"] = cuda_ms(
        lambda: pa.paged_decode_attention_inplace_reference(
            q, kn, vn, kp_ref, vp_ref, pt, ln), iters=5)
    elt = torch.finfo(dt).bits // 8
    live_tok = int(lengths.sum())
    res["live_tokens"] = live_tok
    nbytes = (2 * live_tok * KV * HD * elt          # K and V read once
              + 2 * S * H * HD * elt                # q in, o out
              + 2 * S * KV * HD * elt               # k_new, v_new in
              + 2 * int((lengths > 0).sum()) * KV * HD * elt  # new rows
              + 4 * S * (maxP + 1))                 # table, lengths
    flops = 4 * live_tok * H * HD                   # q.k and p.v
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    res["library_ms"] = None   # no single PyTorch call computes K6
    res["ok"] = ok
    return res


def phase_k6():
    cases = []
    for name, (H, KV) in (("7b", (32, 32)), ("1b-gqa", (16, 8))):
        for dtype in ("bfloat16", "float32"):
            r = k6_case(S=16, H=H, KV=KV, HD=128, ps=64, maxP=32,
                        dtype=dtype, seed=1)
            r["config"] = name
            cases.append(r)
    return cases


# --- K5: read-only paged decode attention -------------------------------------


def k5_case(*, S, H, KV, HD, ps, maxP, dtype, seed):
    """One K5 comparison on paged_inputs: live rows within
    kernel_tolerance, the pools unchanged byte for byte, dead rows zero;
    then the K6 -> K5 cross-check: K5 over the pools K6 just wrote (same
    q and lengths) against K6's output."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    (q, kn, vn, kp, vp, pt, ln), lengths = paged_inputs(
        S=S, H=H, KV=KV, HD=HD, ps=ps, maxP=maxP, dtype=dtype, seed=seed)
    kp0, vp0 = kp.clone(), vp.clone()
    before, before6 = pa.launches_read, pa.launches
    o = pa.paged_attention(q, kp, vp, pt, ln)
    o_ref = pa.paged_attention_reference(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    if pa.launches_read != before + 1:
        raise AssertionError("K5 wrapper did not launch its kernel")
    live = torch.as_tensor(lengths > 0, device="cuda")
    err, over = held(o, o_ref, pa.kernel_tolerance(o_ref), live)
    finite = bool(torch.isfinite(o.float()[live]).all())
    pools_unchanged = bool(torch.equal(kp, kp0) and torch.equal(vp, vp0))
    dead_zero = bool((o[~live] == 0).all()) if (~live).any() else True
    # K6 writes k_new/v_new into copies of the pools; K5 reads them back
    k6p, v6p = kp0.clone(), vp0.clone()
    o6, _, _ = pa.paged_decode_attention_inplace(q, kn, vn, k6p, v6p, pt, ln)
    o5 = pa.paged_attention(q, k6p, v6p, pt, ln)
    torch.cuda.synchronize()
    cross_err, cross_over = held(o5, o6, pa.kernel_tolerance(o6), live)
    res = {"shape": f"S={S} H={H} KV={KV} HD={HD} ps={ps} maxP={maxP}",
           "dtype": dtype, "max_abs_err": err, "max_err_over_tol": over,
           "tol": "1e-4" if dtype == "float32" else "2^-7 |plain| + 1e-5",
           "pools_unchanged": pools_unchanged, "dead_slots_zero": dead_zero,
           "k6_to_k5_max_abs_err": cross_err,
           "k6_to_k5_max_err_over_tol": cross_over,
           "k6_to_k5_identical": bool(torch.equal(o5[live], o6[live]))}
    ok = (finite and over <= 1.0 and pools_unchanged and dead_zero
          and cross_over <= 1.0)
    def run():
        pa.paged_attention(q, kp, vp, pt, ln)

    res["kernel_ms"] = device_ms(run)
    res["event_ms"] = cuda_ms(run, iters=50)   # bound by the host's launches
    # comparison and timing launches are not main-path launches
    pa.launches_read, pa.launches = before, before6
    res["plain_ms"] = cuda_ms(
        lambda: pa.paged_attention_reference(q, kp, vp, pt, ln), iters=5)
    elt = torch.finfo(dt).bits // 8
    live_tok = int(lengths.sum())
    res["live_tokens"] = live_tok
    nbytes = (2 * live_tok * KV * HD * elt          # K and V read once
              + 2 * S * H * HD * elt                # q in, o out
              + 4 * S * (maxP + 1))                 # table, lengths
    flops = 4 * live_tok * H * HD                   # q.k and p.v
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    res["library_ms"] = None   # no single PyTorch call computes K5
    res["ok"] = ok
    return res


def phase_k5():
    cases = []
    for name, (H, KV) in (("7b", (32, 32)), ("1b-gqa", (16, 8))):
        for dtype in ("bfloat16", "float32"):
            r = k5_case(S=16, H=H, KV=KV, HD=128, ps=64, maxP=32,
                        dtype=dtype, seed=1)
            r["config"] = name
            cases.append(r)
    return cases


# --- K1 / K2: the flash forward ---------------------------------------------


# the symbols of the TMA/wgmma forward kernel (K1/K2), dQ kernel (K3) and
# dK/dV kernel (K4), which every bf16 launch with head dim 64 or 128 must
# run (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
WGMMA_FWD_SYMBOL = "flash_fwd_wgmma_kernel"
WGMMA_DQ_SYMBOL = "flash_bwd_dq_wgmma_kernel"
WGMMA_DKDV_SYMBOL = "flash_bwd_dkdv_wgmma_kernel"


def band_pairs(S: int, T: int, causal: bool, window=None) -> int:
    """(query, key) pairs a band keeps: the work of one (batch, head)."""
    if not causal:
        return S * T
    w = window or max(S, T)
    return sum(max(0, min(s + 1, T) - max(0, s - w + 1)) for s in range(S))


def fwd_case(*, B, S, H, KV, D, dtype, causal=True, window=None, T=None,
             seed, timed=True):
    """One forward case (K1, or K2 under a window) against the plain
    version on the same inputs: out within kernel_tolerance, the LSE within
    LSE_TOL; the profiler's kernel names (bf16 with head dim 64 or 128 must
    run WGMMA_FWD_SYMBOL and nothing else). Timed: the kernel by CUDA
    events (cuda_ms, through the wrapper) and by CUPTI device time
    (device_ms), the plain version, SDPA (with a band mask under a window)
    and the names of the kernels SDPA launched, beside the bound."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    T = T or S
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(x):
        return torch.as_tensor(x).to(device="cuda", dtype=dt)

    q = t(rng.standard_normal((B, S, H, D)))
    k = t(rng.standard_normal((B, T, KV, D)))
    v = t(rng.standard_normal((B, T, KV, D)))
    counter = "launches_window" if window else "launches"
    before = (fa.launches, fa.launches_window)

    def run():
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window)

    out, lse = run()
    # the bound assumes the plain version's bf16 products sum in f32
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal,
                                                    window=window)
    finally:
        mm.allow_bf16_reduced_precision_reduction = reduced
    torch.cuda.synchronize()
    if getattr(fa, counter) != before[counter == "launches_window"] + 1:
        raise AssertionError("forward wrapper did not launch its kernel")
    err, over = held(out, ref, fa.kernel_tolerance(q, k, v, ref,
                                                   causal=causal,
                                                   window=window))
    lse_err = float((lse - lse_ref).abs().max())
    finite = bool(torch.isfinite(out.float()).all())
    names: set = set()
    dev = device_ms(run, iters=10, names=names, per_call=1)
    wgmma = dtype == "bfloat16" and D in (64, 128)
    ran_new = ran_only(names, WGMMA_FWD_SYMBOL)
    shape = f"B={B} S={S} T={T} H={H} KV={KV} D={D}"
    res = {"shape": shape + (f" window={window}" if window else ""),
           "dtype": dtype, "causal": causal, "max_abs_err": err,
           "max_err_over_tol": over,
           "tol": "1e-4" if dtype == "float32"
           else "2^-7 (attention of |v| + |plain|) + 1e-5",
           "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
           "kernel_names": sorted(names),
           "expects_wgmma_kernel": wgmma, "ran_wgmma_kernel_only": ran_new}
    ok = (finite and over <= 1.0 and lse_err <= LSE_TOL
          and (ran_new or not wgmma))
    if timed:
        res["kernel_ms"] = dev
        res["event_ms"] = cuda_ms(run, iters=10)
        res["plain_ms"] = cuda_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal,
                                                 window=window), iters=3)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = (fa.band_mask(S, T, causal=True, window=window,
                             device="cuda") if window or (causal and T != S)
                else None)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib():
            return sdpa(qh, kh, vh, attn_mask=mask,
                        is_causal=causal and mask is None,
                        enable_gqa=KV != H)

        res["library_ms"] = cuda_ms(lib, iters=10)
        lib_names: set = set()
        res["library_device_ms"] = device_ms(lib, iters=10, names=lib_names)
        res["library_kernels"] = sorted(lib_names)
        elt = torch.finfo(dt).bits // 8
        flops = 4 * B * H * band_pairs(S, T, causal, window) * D
        nbytes = elt * (2 * B * S * H * D + 2 * B * T * KV * D) + 4 * B * H * S
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    # comparison and timing launches are not main-path launches
    fa.launches, fa.launches_window = before
    res["ok"] = ok
    return res


def phase_k1():
    """K1 timed at the 7b prefill shape (B 8, S = T = 1024, H = KV = 32, D
    128, causal), the 1b GQA shape (H 16, KV 8) and debug-125m's heads (H =
    KV = 12, D 64), in bf16 and f32; untimed: ragged S = T = 200 causal and
    full, S = T = 1000 (a ragged last 128-row tile), S = T = 130 (one row
    past a tile), T = 512 > S = 256 (forward_with_cache's cache row)."""
    cases = []
    timed = (("7b", dict(H=32, KV=32, D=128)),
             ("1b-gqa", dict(H=16, KV=8, D=128)),
             ("debug-125m", dict(H=12, KV=12, D=64)))
    for name, shape in timed:
        for dtype in ("bfloat16", "float32"):
            r = fwd_case(B=8, S=1024, **shape, dtype=dtype, seed=2)
            r["config"] = name
            cases.append(r)
    untimed = (("ragged", dict(S=200), True), ("ragged-full", dict(S=200),
                                                False),
               ("s1000", dict(S=1000), True), ("s130", dict(S=130), True),
               ("t512-s256", dict(S=256, T=512), True))
    for name, shape, causal in untimed:
        for dtype in ("bfloat16", "float32"):
            r = fwd_case(B=2, H=16, KV=8, D=128, **shape, causal=causal,
                         dtype=dtype, seed=3, timed=False)
            r["config"] = name
            cases.append(r)
    return cases


def phase_k2():
    """K2 timed at the 1b train shape (B 8, S 1024, H 16, KV 8, D 128) with
    windows 256 and 1024 (the whole causal band), and at debug-125m's heads
    (H = KV = 12, D 64) with window 256, in bf16 and f32; untimed: ragged
    S = T = 200 with window 64, S = T = 1000 with window 200."""
    cases = []
    timed = (("1b-w256", dict(H=16, KV=8, D=128, window=256)),
             ("1b-w1024", dict(H=16, KV=8, D=128, window=1024)),
             ("debug-125m-w256", dict(H=12, KV=12, D=64, window=256)))
    for name, shape in timed:
        for dtype in ("bfloat16", "float32"):
            r = fwd_case(B=8, S=1024, **shape, dtype=dtype, seed=20)
            r["config"] = name
            cases.append(r)
    for name, S, window in (("ragged-w64", 200, 64), ("s1000-w200", 1000,
                                                       200)):
        for dtype in ("bfloat16", "float32"):
            r = fwd_case(B=2, S=S, H=16, KV=8, D=128, window=window,
                         dtype=dtype, seed=21, timed=False)
            r["config"] = name
            cases.append(r)
    return cases


# --- K3 / K4: the flash backward ----------------------------------------------


def k3k4_case(*, B, S, H, KV, D, causal, window, dtype, seed, timed=True):
    """K3 and K4 against the plain backward on the same (q, k, v, out, lse,
    dO), dq/dk/dv elementwise within grad_tolerance, bit-identical on a
    second run. Timed: each kernel by CUPTI device time (device_ms) and by
    CUDA events, with the names of the kernels it ran (bf16 K3 and K4 at
    head dim 64 or 128 must run WGMMA_DQ_SYMBOL and WGMMA_DKDV_SYMBOL and
    nothing else), the plain backward and SDPA's backward (bf16 only),
    beside the bounds."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(x):
        return torch.as_tensor(x).to(device="cuda", dtype=dt)

    q = t(rng.standard_normal((B, S, H, D)))
    k = t(rng.standard_normal((B, S, KV, D)))
    v = t(rng.standard_normal((B, S, KV, D)))
    g = t(rng.standard_normal((B, S, H, D)))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = (fa.launches_dq, fa.launches_dkdv)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    if (fa.launches_dq, fa.launches_dkdv) != (before[0] + 2, before[1] + 2):
        raise AssertionError("K3/K4 wrappers did not launch their kernels")
    res = {"shape": f"B={B} S=T={S} H={H} KV={KV} D={D}", "dtype": dtype,
           "causal": causal, "window": window,
           "tol": "grad_tolerance (ops/flash_attention.py)",
           "deterministic": all(torch.equal(a, b)
                                for a, b in zip(got, again))}
    ok = res["deterministic"]
    for name, a, b, tol in zip(("dq", "dk", "dv"), got, plain, tols):
        err, over = held(a, b, tol)
        res[f"{name}_max_abs_err"] = err
        res[f"{name}_max_err_over_tol"] = over
        ok = ok and over <= 1.0 and bool(torch.isfinite(a.float()).all())
    del plain, tols
    if timed:
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                              causal=causal, window=window)

        def k3():
            fa.flash_attention_bwd_dq(q, k, v, out, lse, g, causal=causal,
                                      window=window)

        def k4():
            fa.flash_attention_bwd_dkdv(q, k, v, lse, g, delta,
                                        causal=causal, window=window)

        for pre, fn in (("k3_", k3), ("k4_", k4)):
            names: set = set()
            res[pre + "kernel_ms"] = device_ms(fn, iters=10, names=names,
                                               per_call=1)
            res[pre + "event_ms"] = cuda_ms(fn, iters=10)
            res[pre + "kernels"] = sorted(names)
        if dtype == "bfloat16" and D in (64, 128):
            res["ran_wgmma_dq_only"] = ran_only(res["k3_kernels"],
                                                WGMMA_DQ_SYMBOL)
            res["ran_wgmma_dkdv_only"] = ran_only(res["k4_kernels"],
                                                  WGMMA_DKDV_SYMBOL)
            ok = (ok and res["ran_wgmma_dq_only"]
                  and res["ran_wgmma_dkdv_only"])
        res["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal=causal, window=window), iters=3)
        res["library_ms"] = None
        if dtype == "bfloat16":
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            mask = (None if window is None else fa.band_mask(
                S, S, causal=True, window=window, device="cuda"))
            o = torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=KV != H)
            gh = g.transpose(1, 2).contiguous()

            def lib():
                torch.autograd.grad(o, (qh, kh, vh), gh, retain_graph=True)

            res["library_ms"] = cuda_ms(lib, iters=10)
            lib_names: set = set()
            res["library_device_ms"] = device_ms(lib, iters=10,
                                                 names=lib_names)
            res["library_kernels"] = sorted(lib_names)
        elt = torch.finfo(dt).bits // 8
        pairs = band_pairs(S, S, causal, window)
        bshd, btkd, bhs = B * S * H * D, B * S * KV * D, B * H * S
        # K3 reads q, o, dO, k, v, lse and writes dq, delta; 3 products
        res["k3_bound_ms"], res["k3_bound_by"] = bound(
            elt * (4 * bshd + 2 * btkd) + 8 * bhs, 6 * B * H * pairs * D,
            dtype)
        # K4 reads q, dO, k, v, lse, delta and writes dk, dv; 4 products
        res["k4_bound_ms"], res["k4_bound_by"] = bound(
            elt * (2 * bshd + 4 * btkd) + 8 * bhs, 8 * B * H * pairs * D,
            dtype)
    fa.launches_dq, fa.launches_dkdv = before
    res["ok"] = ok
    return res


def phase_k3k4():
    """At the 1b train shape (B 8, S = T = 1024, H 16, KV 8, D 128,
    causal), debug-125m's heads (H = KV = 12, D 64), ragged S = T = 200,
    non-causal (S = 512) and window 256, each in bf16 and f32."""
    cases = []
    shapes = (("1b", dict(B=8, S=1024, H=16, KV=8, D=128, causal=True,
                          window=None), True),
              ("debug-125m", dict(B=8, S=1024, H=12, KV=12, D=64,
                                  causal=True, window=None), True),
              ("ragged", dict(B=2, S=200, H=16, KV=8, D=128, causal=True,
                              window=None), False),
              ("non-causal", dict(B=2, S=512, H=16, KV=8, D=128,
                                  causal=False, window=None), False),
              ("1b-w256", dict(B=8, S=1024, H=16, KV=8, D=128, causal=True,
                               window=256), True))
    for name, shape, timed in shapes:
        for dtype in ("bfloat16", "float32"):
            r = k3k4_case(**shape, dtype=dtype, seed=22, timed=timed)
            r["config"] = name
            cases.append(r)
    return cases


# --- the port's training step ---------------------------------------------------


def _train_launches():
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_fwd_window": fa.launches_window,
            "flash_attention_bwd_dq": fa.launches_dq,
            "flash_attention_bwd_dkdv": fa.launches_dkdv}


def _reset_train_launches():
    from ray_tpu_torch.ops import flash_attention as fa

    fa.launches = fa.launches_window = fa.launches_dq = fa.launches_dkdv = 0


def phase_train_card_vs_cpu():
    """The 1b width (d_model 2048, H 16, KV 8, d_ff 5632, vocab 32000) cut
    to 2 layers, f32 without TF32, flash, remat "none", adamw(3e-4,
    weight_decay=0.01), B 2, S 256: 2 steps on the card (kernels) and on
    the CPU (plain versions) from one seeded init, without a window and
    with sliding_window 64 (the run on which K2 launches; the launch
    counters are set to 0 just before the card runs and read after)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    lr = 3e-4
    base = llama.PRESETS["1b"].replace(n_layers=2, dtype=torch.float32,
                                       attn_impl="flash", remat=True,
                                       remat_policy="none")
    params0 = llama.init_params(torch.Generator().manual_seed(0), base)
    tokens = np.random.default_rng(6).integers(
        0, base.vocab_size, size=(2, 257)).astype(np.int64)
    res = {"cfg": "1b width, 2 layers, f32, flash, remat none, B 2 S 256, "
                  "adamw(3e-4, weight_decay=0.01), 2 steps",
           "loss_rel_tol": TRAIN_LOSS_RTOL, "grad_norm_rel_tol":
           TRAIN_LOSS_RTOL, "param_max_tol": TRAIN_PARAM_MAX,
           "param_far_tol": TRAIN_PARAM_FAR, "param_far_share_max":
           TRAIN_PARAM_FAR_SHARE, "runs": {}}
    ok = True
    _reset_train_launches()
    for window in (None, 64):
        cfg = base.replace(sliding_window=window)
        out = {}
        for dev in ("cuda", "cpu"):
            init, _ = ts.make_train_state_init(
                lambda g: params0, ts.adamw(lr, weight_decay=0.01),
                device=dev)
            state = init(0)
            step = ts.make_train_step(
                lambda p, b, c=cfg: llama.loss_fn(p, b, c))
            batch = {"tokens": torch.as_tensor(tokens, device=dev)}
            ms = []
            for _ in range(2):
                state, m = step(state, batch)
                ms.append((float(m["loss"]), float(m["grad_norm"])))
            out[dev] = (ms, ts._leaves(state.params))
            if dev == "cuda":
                torch.cuda.synchronize()
        (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
        loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mc, mh))
        gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(mc, mh))
        dmax, far, n = 0.0, 0, 0
        for a, b in zip(pc, ph):
            d = (a.detach().cpu() - b.detach()).abs()
            dmax = max(dmax, float(d.max()))
            far += int((d > TRAIN_PARAM_FAR).sum())
            n += d.numel()
        r = {"losses_card": [m[0] for m in mc],
             "losses_cpu": [m[0] for m in mh],
             "grad_norms_card": [m[1] for m in mc],
             "grad_norms_cpu": [m[1] for m in mh],
             "loss_max_rel_err": loss_rel, "grad_norm_max_rel_err": gn_rel,
             "param_max_abs_err": dmax, "param_far_share": far / n}
        r["ok"] = (loss_rel <= TRAIN_LOSS_RTOL and gn_rel <= TRAIN_LOSS_RTOL
                   and dmax <= TRAIN_PARAM_MAX
                   and far / n <= TRAIN_PARAM_FAR_SHARE
                   and all(np.isfinite(m[0]) for m in mc))
        res["runs"][f"window={window}"] = r
        ok = ok and r["ok"]
    res["launches"] = _train_launches()
    # per card run: 2 steps x 2 layers x (forward + remat recompute) of K1
    # (no window) or K2 (window 64), and 2 x 2 of K3 and of K4 per run
    expect = {"flash_attention_fwd": 8, "flash_attention_fwd_window": 8,
              "flash_attention_bwd_dq": 8, "flash_attention_bwd_dkdv": 8}
    res["launches_expected"] = expect
    res["ok"] = ok and res["launches"] == expect
    return res


def phase_train():
    """The training main path: the 1b preset at full width and all 16
    layers (~886 M params), bf16 compute with f32 master weights, flash,
    remat, f32_logits False, adamw(3e-4, weight_decay=0.01), B 8, S 1024,
    tokens from a seed; one warm-up step, then 10 steps on the same batch
    with the launch counters set to 0 just before them and read after."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    B, S, steps = 8, 1024, 10
    cfg = llama.PRESETS["1b"].replace(attn_impl="flash", remat=True,
                                      f32_logits=False)
    t0 = time.perf_counter()
    init, _ = ts.make_train_state_init(
        lambda g: llama.init_params(g, cfg), ts.adamw(3e-4,
                                                      weight_decay=0.01),
        device="cuda")
    state = init(0)
    step = ts.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg))
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device="cuda")
    batch = {"tokens": tokens}
    state, m = step(state, batch)           # warm-up
    warm_loss = float(m["loss"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _reset_train_launches()
    losses, norms = [], []
    t_run = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = _train_launches()
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    step_s = run_s / steps
    n_params = llama.num_params(cfg)
    flops = 6 * n_params * B * S + 12 * cfg.n_layers * B * S * S * cfg.d_model
    L = cfg.n_layers
    expect = {"flash_attention_fwd": steps * L * 2,
              "flash_attention_fwd_window": 0,
              "flash_attention_bwd_dq": steps * L,
              "flash_attention_bwd_dkdv": steps * L}
    res = {"cfg": "1b, 16 layers, bf16 compute, f32 master weights, flash, "
                  "remat none, f32_logits False, adamw(3e-4, "
                  "weight_decay=0.01), B 8, S 1024",
           "n_params": n_params, "setup_s": setup_s,
           "warmup_loss": warm_loss, "losses": losses, "grad_norms": norms,
           "step_s": step_s, "tokens_per_s": B * S / step_s,
           "model_flops_per_step": flops,
           "mfu_vs_989_tflops": flops / step_s / 989e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_expected": expect}
    res["ok"] = (all(np.isfinite(losses)) and losses[-1] < losses[0]
                 and launches == expect)
    # one step's device time by kernel class, after the counted run
    res["profile_step"] = device_profile(lambda: step(state, batch),
                                         lambda: step(state, batch))
    res["step_ran_wgmma_fwd_only"] = ran_wgmma_fwd_only(res["profile_step"])
    res["step_ran_wgmma_dq_only"] = ran_only(
        [n for n in res["profile_step"]["flash_kernels"]
         if "flash_bwd_dq_" in n], WGMMA_DQ_SYMBOL)
    res["step_ran_wgmma_dkdv_only"] = ran_only(
        [n for n in res["profile_step"]["flash_kernels"]
         if "flash_bwd_dkdv_" in n], WGMMA_DKDV_SYMBOL)
    res["ok"] = (res["ok"] and res["step_ran_wgmma_fwd_only"]
                 and res["step_ran_wgmma_dq_only"]
                 and res["step_ran_wgmma_dkdv_only"])
    return res


def phase_train_sharded():
    """The train phase's recipe (1b, 16 layers, bf16 compute, f32 masters,
    flash, remat, f32_logits False, adamw(3e-4, weight_decay=0.01), B 8,
    S 1024, seed 0, the same batch) through the sharded entry points: a
    1-rank NCCL mesh (``local_mesh(MeshSpec(fsdp=-1))``) under
    ``ShardingRules.fsdp_tp()``, params and AdamW moments as DTensors,
    the init drawn leaf by leaf. One warm-up step, then 10 with the launch
    counters set to 0 just before them. On one rank every placement is
    Replicate: this proves the mesh plumbing and the kernels under it,
    not collectives."""
    import functools

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules

    base = RESULTS["phases"]["train"]
    B, S, steps = 8, 1024, 10
    cfg = llama.PRESETS["1b"].replace(attn_impl="flash", remat=True,
                                      f32_logits=False)
    t0 = time.perf_counter()
    mesh = local_mesh(MeshSpec(fsdp=-1))
    rules = ShardingRules.fsdp_tp()
    init, state_sh = ts.make_train_state_init(
        functools.partial(llama.init_params, cfg=cfg),
        ts.adamw(3e-4, weight_decay=0.01), mesh, rules,
        llama.param_specs(cfg), device="cuda")
    state = init(0)
    step = ts.make_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg, mesh=mesh, rules=rules),
        mesh=mesh, rules=rules, state_shardings=state_sh)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device="cuda")
    batch = {"tokens": tokens}
    state, m = step(state, batch)           # warm-up
    warm_loss = float(m["loss"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _reset_train_launches()
    losses, norms = [], []
    t_run = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = _train_launches()
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    step_s = run_s / steps
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base["losses"])]
    moments = [v for st in state.opt_state.state.values()
               for k, v in st.items() if k != "step"]
    res = {"cfg": "the train phase's, through make_train_state_init / "
                  "make_train_step with mesh (1 rank, NCCL, "
                  "MeshSpec(fsdp=-1)) and rules (fsdp_tp)",
           "mesh": str(mesh), "setup_s": setup_s,
           "warmup_loss": warm_loss, "losses": losses, "grad_norms": norms,
           "train_losses": base["losses"],
           "loss_max_rel_diff": max(rel), "loss_rel_tol":
           TRAIN_SHARDED_LOSS_RTOL,
           "losses_bit_identical": losses == base["losses"],
           "grad_norms_bit_identical": norms == base["grad_norms"],
           "step_s": step_s, "tokens_per_s": B * S / step_s,
           "train_step_s": base["step_s"],
           "train_tokens_per_s": base["tokens_per_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "train_peak_mem_gb": base["peak_mem_gb"],
           "params_are_dtensors": all(isinstance(p, DTensor) for p in
                                      ts._leaves(state.params)),
           "opt_state_dtensors": len(moments) > 0 and all(
               isinstance(v, DTensor) for v in moments),
           "launches": launches,
           "launches_expected": base["launches_expected"]}
    res["ok"] = (all(np.isfinite(losses)) and max(rel) <=
                 TRAIN_SHARDED_LOSS_RTOL
                 and launches == base["launches_expected"]
                 and res["params_are_dtensors"] and res["opt_state_dtensors"])
    res["profile_step"] = device_profile(lambda: step(state, batch),
                                         lambda: step(state, batch))
    flash = res["profile_step"]["flash_kernels"]
    res["step_ran_wgmma_fwd_only"] = ran_wgmma_fwd_only(res["profile_step"])
    res["step_ran_wgmma_dq_only"] = ran_only(
        [n for n in flash if "flash_bwd_dq_" in n], WGMMA_DQ_SYMBOL)
    res["step_ran_wgmma_dkdv_only"] = ran_only(
        [n for n in flash if "flash_bwd_dkdv_" in n], WGMMA_DKDV_SYMBOL)
    res["step_ran_only_three_flash_kernels"] = all(
        any(sym in n for sym in (WGMMA_FWD_SYMBOL, WGMMA_DQ_SYMBOL,
                                 WGMMA_DKDV_SYMBOL)) for n in flash)
    res["ok"] = (res["ok"] and res["step_ran_wgmma_fwd_only"]
                 and res["step_ran_wgmma_dq_only"]
                 and res["step_ran_wgmma_dkdv_only"]
                 and res["step_ran_only_three_flash_kernels"])
    return res


# --- the port's engine --------------------------------------------------------


def _cpu_copy(params):
    if isinstance(params, dict):
        return {k: _cpu_copy(v) for k, v in params.items()}
    return params.to("cpu")


def phase_card_vs_cpu():
    """2 layers at the 7b width, f32: the same weights through the port's
    engine on the card and on the CPU."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.PRESETS["7b"].replace(n_layers=2, dtype=torch.float32,
                                      attn_impl="flash", max_seq_len=512)
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(gen, cfg)
    params_cpu = _cpu_copy(params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (130, 167, 200)]

    # first-step logits: prefill of the three prompts (bucket 256, flash)
    P = 256
    toks = np.zeros((3, P), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    logits = {}
    for name, dev, prm in (("card", device, params), ("cpu", "cpu",
                                                      params_cpu)):
        lg, _, _ = llama.prefill(prm, torch.as_tensor(toks, device=dev),
                                 torch.as_tensor(lens, device=dev), cfg)
        logits[name] = lg.float().cpu()
    logit_err = float((logits["card"] - logits["cpu"]).abs().max())

    outs = {}
    for name, dev, prm in (("card", device, params), ("cpu", "cpu",
                                                      params_cpu)):
        eng = LLMEngine(cfg=cfg, params=prm, max_slots=4,
                        kv_layout="paged", page_size=64, device=dev)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        while eng.has_work():
            eng.step_n(8)
        outs[name] = [r.generated for r in reqs]
    same = outs["card"] == outs["cpu"]
    ok = same and logit_err <= LOGITS_TOL and all(
        len(g) == 8 for g in outs["card"])
    return {"cfg": "7b width, 2 layers, f32, flash, page 64",
            "prompt_lens": [len(p) for p in prompts],
            "tokens_card": outs["card"], "tokens_cpu": outs["cpu"],
            "tokens_identical": same, "logits_max_abs_err": logit_err,
            "logits_tol": LOGITS_TOL, "ok": ok}


def engine_requests(rng, V):
    """The engine phases' 12 prompts in two waves: 8 of 64-1000 tokens and
    4 sharing a 512-token prefix (the first of them in wave 1)."""
    prefix = rng.integers(0, V, size=512).tolist()
    unique = [rng.integers(0, V, size=int(n)).tolist()
              for n in rng.integers(64, 1001, size=8)]
    shared = [prefix + rng.integers(0, V, size=int(n)).tolist()
              for n in rng.integers(40, 400, size=4)]
    return unique[:7] + shared[:1], shared[1:] + unique[7:]


def drive_engine(eng, wave1, wave2):
    """Submit wave 1 (request 3 sampled at temperature 0.8), step once,
    submit wave 2, and step until done. Returns the requests."""
    reqs = [eng.submit(p, max_new_tokens=64,
                       temperature=0.8 if i == 3 else 0.0)
            for i, p in enumerate(wave1)]
    eng.step_n(8)   # prefills wave 1 (and registers the shared prefix pages)
    reqs += [eng.submit(p, max_new_tokens=64) for p in wave2]
    while eng.has_work():
        eng.step_n(8)
    return reqs


def engine_metrics(eng, reqs, m0, run_s):
    """The serving numbers of a counted run: tokens, TTFT, decode rate (the
    engine's counters less those before the run, m0)."""
    import numpy as np

    m = {k: v - m0.get(k, 0) for k, v in eng.metrics.items()}
    n_tok = sum(len(r.generated) for r in reqs)
    ttft = [r.first_token_time - r.submit_time for r in reqs]
    V = eng.cfg.vocab_size
    return {"requests": len(reqs), "run_s": run_s,
            "tokens_generated": n_tok,
            "ttft_mean_s": float(np.mean(ttft)),
            "ttft_max_s": float(np.max(ttft)),
            # every request's first token comes from its prefill
            "decode_tokens_per_s": (n_tok - len(reqs)) /
            max(m.get("decode_block_s", 0.0), 1e-9),
            "decode_block_s": m.get("decode_block_s", 0.0),
            "admit_s": m.get("admit_s", 0.0),
            "decode_blocks": m.get("decode_blocks", 0),
            "prefix_hits": m.get("prefix_hits", 0),
            "prefix_hit_tokens": m.get("prefix_hit_tokens", 0),
            "preemptions": m.get("preemptions", 0),
            "all_finished_64": all(
                len(r.generated) == 64 and r.error is None
                and all(0 <= t < V for t in r.generated) for r in reqs)}


def profile_windows(eng, rng):
    """Where the time goes, after a counted run. The profiler slows the
    host by far more than the work it traces, so each window runs twice on
    the same shapes: once on the host clock alone (wall), once under the
    profiler (device time by kernel class); idle = 1 - busy / wall.
    Windows: an admission of 8 prompts of 1000 tokens (prefill, bucket
    1024), then a decode block of 8 steps with all 16 slots live. Both
    passes admit 8, so 16 slots stay live with ~1000-token contexts."""
    V = eng.cfg.vocab_size
    full = [rng.integers(0, V, size=1000).tolist() for _ in range(16)]

    def admit(prompts):
        def run():
            for p in prompts:
                eng.submit(p, max_new_tokens=64)
            eng._admit()
        return run

    return {"profile_prefill": device_profile(admit(full[:8]),
                                              admit(full[8:])),
            "profile_decode_block": device_profile(lambda: eng.step_n(8),
                                                   lambda: eng.step_n(8))}


def phase_engine():
    """The paged serving path: 7b preset, 32 layers, bf16, paged, flash
    prefill; then the K5 path over its live pools."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMEngine

    t0 = time.perf_counter()
    cfg = llama.PRESETS["7b"].replace(attn_impl="flash")
    eng = LLMEngine(cfg=cfg, max_slots=16, max_seq_len=2048,
                    kv_layout="paged", page_size=64, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    V = cfg.vocab_size
    wave1, wave2 = engine_requests(rng, V)

    # warm-up (cuBLAS handles, kernel libraries, the profiler's CUPTI
    # start-up) so the counted run below measures steady state
    eng.generate(rng.integers(0, V, size=200).tolist(), max_new_tokens=2)
    device_profile(lambda: None, lambda: None)
    m0 = dict(eng.metrics)   # the engine's counters, less the warm-up's

    pa.launches = 0
    fa.launches = 0
    t_run = time.perf_counter()
    reqs = drive_engine(eng, wave1, wave2)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"paged_decode_attention_inplace": pa.launches,
                "flash_attention_fwd": fa.launches}
    res = {"cfg": "7b, 32 layers, bf16, flash, paged page 64, 16 slots, "
                  "max_seq 2048",
           "prompt_lens": [len(p) for p in wave1 + wave2],
           "setup_s": setup_s, **engine_metrics(eng, reqs, m0, run_s),
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tokens": [r.generated for r in reqs]}
    res["ok"] = (res["all_finished_64"] and res["prefix_hits"] >= 1
                 and all(v > 0 for v in launches.values()))
    res.update(profile_windows(eng, rng))
    res["prefill_ran_wgmma_fwd_only"] = ran_wgmma_fwd_only(
        res["profile_prefill"])
    res["k5_path"] = k5_path(eng)
    res["ok"] = (res["ok"] and res["k5_path"]["ok"]
                 and res["prefill_ran_wgmma_fwd_only"])
    return res


def phase_engine_sharded():
    """The engine phase's paged engine (7b, 32 layers, bf16, flash, page 64,
    16 slots, max_seq 2048, seed 0) built with ``mesh=`` (1 rank, NCCL)
    and ``rules=ShardingRules.fsdp_tp()``: the weights rest as DTensors
    and each is gathered at its use (on one rank, its local tensor). It
    serves the engine phase's first wave (8 requests, request 3 sampled
    at temperature 0.8), driven as that phase drives it, with the launch
    counters set to 0 just before; every greedy request's tokens must be
    the engine phase's."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.serve.llm import LLMEngine

    base = RESULTS["phases"]["engine"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = llama.PRESETS["7b"].replace(attn_impl="flash")
    eng = LLMEngine(cfg=cfg, max_slots=16, max_seq_len=2048,
                    kv_layout="paged", page_size=64, seed=0, device="cuda",
                    mesh=local_mesh(MeshSpec(fsdp=-1)),
                    rules=ShardingRules.fsdp_tp())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wave1, _ = engine_requests(np.random.default_rng(5), cfg.vocab_size)
    m0 = dict(eng.metrics)
    pa.launches = 0
    fa.launches = 0
    t_run = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=64,
                       temperature=0.8 if i == 3 else 0.0)
            for i, p in enumerate(wave1)]
    while eng.has_work():
        eng.step_n(8)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"paged_decode_attention_inplace": pa.launches,
                "flash_attention_fwd": fa.launches}
    greedy = [i for i in range(len(wave1)) if i != 3]
    same = [reqs[i].generated == base["tokens"][i] for i in greedy]
    res = {"cfg": "the engine phase's paged 7b engine with mesh (1 rank, "
                  "NCCL) and rules (fsdp_tp); its first wave",
           "prompt_lens": [len(p) for p in wave1], "setup_s": setup_s,
           **engine_metrics(eng, reqs, m0, run_s),
           "engine_decode_tokens_per_s": base["decode_tokens_per_s"],
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "engine_peak_mem_gb": base["peak_mem_gb"],
           "weights_are_dtensors": all(
               isinstance(v, DTensor) for v in
               [eng.params["embed"], eng.params["lm_head"],
                *eng.params["layers"].values()]),
           "greedy_requests": greedy, "greedy_tokens_equal": same}
    res["ok"] = (res["all_finished_64"] and all(same)
                 and res["weights_are_dtensors"]
                 and all(v > 0 for v in launches.values()))
    return res


def k5_path(eng):
    """The K5 path: ``paged_attention`` on every layer of the live engine's
    pools, page table and lengths (16 slots at ~1000 tokens), with a seeded
    q, each layer held against the plain version. The launch counter is
    set to 0 just before and read just after."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    cfg = eng.cfg
    pt = eng._tensor(eng.pool.table)
    ln = eng._tensor(eng._len_host)
    live = ln > 0
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((eng.max_slots, cfg.n_heads, cfg.head_dim), generator=g,
                    device="cuda").to(cfg.dtype)
    pa.launches_read = 0
    outs = [pa.paged_attention(q, eng.kp[i], eng.vp[i], pt, ln)
            for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.launches_read}
    err = over = 0.0
    dead_zero = finite = True
    for i, o in enumerate(outs):
        ref = pa.paged_attention_reference(q, eng.kp[i], eng.vp[i], pt, ln)
        e, ov = held(o, ref, pa.kernel_tolerance(ref), live)
        err, over = max(err, e), max(over, ov)
        finite &= bool(torch.isfinite(o.float()[live]).all())
        dead_zero &= bool((o[~live] == 0).all())
    res = {"live_slots": int(live.sum()), "live_tokens": int(ln.sum()),
           "layers": cfg.n_layers, "launches": launches,
           "max_abs_err": err, "max_err_over_tol": over,
           "dead_slots_zero": dead_zero}
    res["ok"] = (finite and over <= 1.0 and dead_zero
                 and launches["paged_attention"] == cfg.n_layers
                 and res["live_slots"] > 0)
    return res


def phase_card_vs_cpu_contiguous():
    """2 layers at the 7b width, f32 (no TF32), flash, max_seq 512, 4
    slots, the prompts of card_vs_cpu: greedy tokens identical (1) card vs
    CPU, contiguous layout; (2) contiguous vs paged on the card; (3) int8,
    card vs CPU (and the two int8 trees bit for bit); (4)
    ``sliding_window=64``, card vs CPU, the serving run on which K2
    launches. Also ``forward_with_cache`` of 256 tokens at offset 0 into a
    512-token cache row (K1 with T = 512 > S), logits card vs CPU. The
    launch counters are set to 0 just before the phase and read after."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.PRESETS["7b"].replace(n_layers=2, dtype=torch.float32,
                                      attn_impl="flash", max_seq_len=512)
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    params_cpu = _cpu_copy(params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (130, 167, 200)]
    fa.launches = fa.launches_window = pa.launches = 0

    def serve(dev, prm, c=cfg, **kw):
        eng = LLMEngine(cfg=c, params=prm, max_slots=4, device=dev, **kw)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        while eng.has_work():
            eng.step_n(8)
        return eng, [r.generated for r in reqs]

    runs, ok = {}, True
    _, card = serve("cuda", params)
    _, cpu = serve("cpu", params_cpu)
    runs["contiguous_card_vs_cpu"] = {"card": card, "cpu": cpu}
    _, paged = serve("cuda", params, kv_layout="paged", page_size=64)
    runs["contiguous_vs_paged_card"] = {"contiguous": card, "paged": paged}
    e_card, q_card = serve("cuda", params, quantize="int8")
    e_cpu, q_cpu = serve("cpu", params_cpu, quantize="int8")
    runs["int8_card_vs_cpu"] = {"card": q_card, "cpu": q_cpu}
    trees_equal = all(
        torch.equal(a.cpu(), b) for a, b in zip(
            _leaves(e_card.params), _leaves(e_cpu.params)))
    wcfg = cfg.replace(sliding_window=64)
    before_w = fa.launches_window
    _, w_card = serve("cuda", params, c=wcfg)
    k2_serving = fa.launches_window - before_w
    _, w_cpu = serve("cpu", params_cpu, c=wcfg)
    runs["window64_card_vs_cpu"] = {"card": w_card, "cpu": w_cpu}
    for r in runs.values():
        a, b = r.values()
        r["identical"] = a == b and all(len(t) == 8 for t in a)
        ok = ok and r["identical"]

    # forward_with_cache: 256 tokens at offset 0 into 512-token rows
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             size=(2, 256))
    logits = {}
    before = fa.launches
    for dev, prm in (("cuda", params), ("cpu", params_cpu)):
        cache = llama.init_cache(cfg, 2, max_seq=512, device=dev)
        lg, cache = llama.forward_with_cache(
            prm, torch.as_tensor(toks, device=dev), cache, cfg, 0)
        logits[dev] = lg.cpu()
    k1_fwc = fa.launches - before
    fwc_err = float((logits["cuda"] - logits["cpu"]).abs().max())
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_fwd_window": fa.launches_window,
                "paged_decode_attention_inplace": pa.launches}
    ok = (ok and trees_equal and k2_serving > 0 and k1_fwc == cfg.n_layers
          and fwc_err <= LOGITS_TOL)
    return {"cfg": "7b width, 2 layers, f32, flash, max_seq 512, 4 slots",
            "prompt_lens": [len(p) for p in prompts], "runs": runs,
            "int8_trees_identical": trees_equal,
            "k2_launches_serving_window64": k2_serving,
            "forward_with_cache_k1_launches": k1_fwc,
            "forward_with_cache_logits_max_abs_err": fwc_err,
            "logits_tol": LOGITS_TOL, "launches": launches, "ok": ok}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def phase_engine_contiguous():
    """The JAX engine's default configuration on the card: the 7b preset,
    all 32 layers, bf16, contiguous KV (16 slots x 2048 tokens), int8
    weights, flash prefill; the engine phase's 12 requests (seed 5), 64
    tokens each, with the K1 counter set to 0 just before them and read
    after; then the prefill and decode-block profiles. Memory gates: the
    engine's setup peak within its int8 weights, KV cache and
    SETUP_PEAK_MARGIN_GB, and the int8 init alone (4 layers) within its
    int8 tree and the margin."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.PRESETS["7b"].replace(attn_impl="flash")
    # the int8 init on its own, 4 layers of the 7b width: its peak stays
    # within its int8 tree and one 2-D weight's f32 copy (the float tree
    # whole would add 2.1 GB of bf16), which the engine's setup peak below
    # cannot show: its KV cache, allocated after the weights, is larger
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p4 = llama.init_params_int8(
        torch.Generator().manual_seed(0),
        cfg.replace(n_layers=4, param_dtype=cfg.dtype), device="cuda")
    init4 = {"int8_gb": sum(t.nbytes for t in _leaves(p4)) / 1e9,
             "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9}
    init4["ok"] = init4["peak_gb"] <= init4["int8_gb"] + SETUP_PEAK_MARGIN_GB
    del p4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg=cfg, max_slots=16, max_seq_len=2048, seed=0,
                    quantize="int8", device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    weight_bytes = sum(t.nbytes for t in _leaves(eng.params))
    q8_bytes = sum(t.nbytes for t in _leaves(eng.params)
                   if t.dtype == torch.int8)
    cache_bytes = eng.cache.k.nbytes + eng.cache.v.nbytes
    rng = np.random.default_rng(5)
    V = cfg.vocab_size
    wave1, wave2 = engine_requests(rng, V)
    eng.generate(rng.integers(0, V, size=200).tolist(), max_new_tokens=2)
    m0 = dict(eng.metrics)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t_run = time.perf_counter()
    reqs = drive_engine(eng, wave1, wave2)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"flash_attention_fwd": fa.launches}
    res = {"cfg": "7b, 32 layers, bf16, int8 weights, flash, contiguous KV, "
                  "16 slots, max_seq 2048",
           "prompt_lens": [len(p) for p in wave1 + wave2],
           "setup_s": setup_s, "setup_peak_mem_gb": setup_peak,
           "weight_bytes_at_rest": weight_bytes, "int8_bytes": q8_bytes,
           "kv_cache_bytes": cache_bytes,
           # the int8 engine never holds its float tree whole on the card
           "setup_peak_limit_gb": (weight_bytes + cache_bytes) / 1e9
           + SETUP_PEAK_MARGIN_GB,
           **engine_metrics(eng, reqs, m0, run_s), "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["setup_peak_ok"] = setup_peak <= res["setup_peak_limit_gb"]
    res["int8_init_4_layers"] = init4
    print(f"engine_contiguous: setup peak {setup_peak:.3f} GB <= int8 "
          f"weights + KV cache + {SETUP_PEAK_MARGIN_GB} = "
          f"{res['setup_peak_limit_gb']:.3f} GB: {res['setup_peak_ok']}; "
          f"int8 init of 4 layers: peak {init4['peak_gb']:.3f} GB <= "
          f"{init4['int8_gb']:.3f} + {SETUP_PEAK_MARGIN_GB}: {init4['ok']}",
          flush=True)
    res["ok"] = (res["all_finished_64"] and res["setup_peak_ok"]
                 and init4["ok"] and launches["flash_attention_fwd"] > 0)

    def dequantize_all():
        # what one decode step spends on int8: every matmul weight
        # dequantized to bf16 once (the embedding gathers rows only)
        for lp in llama._unstack_layers(eng.params["layers"]):
            for k, w in lp.items():
                if not k.endswith("norm"):
                    llama._dq(w, cfg.dtype)
        llama._dq(eng.params["lm_head"], cfg.dtype)

    res["dequant_ms_per_step"] = cuda_ms(dequantize_all, iters=3)
    res.update(profile_windows(eng, rng))
    res["prefill_ran_wgmma_fwd_only"] = ran_wgmma_fwd_only(
        res["profile_prefill"])
    res["ok"] = res["ok"] and res["prefill_ran_wgmma_fwd_only"]
    return res


_KERNEL_CLASSES = (("k6_paged_decode", ("paged_decode_",)),
                   ("k1_flash_fwd", ("flash_fwd_",)),
                   ("k3_flash_bwd_dq", ("flash_bwd_dq_",)),
                   ("k4_flash_bwd_dkdv", ("flash_bwd_dkdv_",)),
                   ("adamw", ("multi_tensor_apply",)),
                   ("casts_copies", ("copy_kernel",)),
                   ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))


def device_profile(timed, profiled):
    """Where a window's time goes. `timed` and `profiled` run the same work
    on the same shapes: the first on the host clock alone (wall_ms, up to
    the device's last kernel), the second under torch.profiler (CUPTI) for
    the device time of every kernel, by class and by name. The profiler
    costs the host far more than the window itself, so the idle share is
    1 - device busy / the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled()
        torch.cuda.synchronize()
    by = {name: 0.0 for name, _ in _KERNEL_CLASSES}
    by["other"] = 0.0
    by_name: dict = {}
    n_kernels = 0
    for name, ms in kernel_events(prof):
        n_kernels += 1
        cls = next((c for c, keys in _KERNEL_CLASSES
                    if any(k in name.lower() for k in keys)), "other")
        by[cls] += ms
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + ms
    busy = sum(by.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            "device_ms_by_class": by, "device_events": n_kernels,
            "top_kernels_ms": top,
            "flash_kernels": sorted(n for n in by_name if "flash_" in n)}


def ran_only(names, symbol) -> bool:
    """Kernel names, at least one, all of them the kernel `symbol`."""
    return bool(names) and all(symbol in n for n in names)


def ran_wgmma_fwd_only(profile) -> bool:
    """A bf16 window's forward attention launches (K1/K2) all ran the
    TMA/wgmma kernel, and there was at least one."""
    return ran_only([n for n in profile["flash_kernels"] if "flash_fwd_" in n],
                    WGMMA_FWD_SYMBOL)


# --- driver -----------------------------------------------------------------


PHASES = ("build", "k6", "k5", "k1", "card_vs_cpu", "engine",
          "card_vs_cpu_contiguous", "engine_contiguous", "k2", "k3k4",
          "train_card_vs_cpu", "train", "train_sharded", "engine_sharded")

# the TPU kernels of ray_tpu that the port has not reached yet (ROADMAP.md)
TO_PORT: dict = {}


KERNEL_PHASES = {"k6": phase_k6, "k5": phase_k5, "k1": phase_k1,
                 "k2": phase_k2, "k3k4": phase_k3k4}
PATH_PHASES = {"card_vs_cpu": phase_card_vs_cpu, "engine": phase_engine,
               "card_vs_cpu_contiguous": phase_card_vs_cpu_contiguous,
               "engine_contiguous": phase_engine_contiguous,
               "train_card_vs_cpu": phase_train_card_vs_cpu,
               "train": phase_train, "train_sharded": phase_train_sharded,
               "engine_sharded": phase_engine_sharded}


def _start() -> bool:
    """Checks and settings every run shares; False where the run cannot
    go on (outside a checkout, or no CUDA)."""
    if not (REPO / "ray_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(ray_tpu_torch/ not found beside it)", file=sys.stderr)
        return False
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script drives "
              "the port on an NVIDIA GPU", file=sys.stderr)
        return False
    sys.path.insert(0, str(REPO))
    # f32 stays f32 on the card (no TF32) for every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=nvidia_smi_line(),
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return True


def _run_phase(ph: str) -> bool:
    if ph == "build":
        from ray_tpu_torch.ops import _build

        t0 = time.perf_counter()
        took = _build.build()
        logs = {n: ptxas_report(_build.BUILD_DIR / f"{n}.log")
                for n in _build.KERNEL_SOURCES
                if (_build.BUILD_DIR / f"{n}.log").is_file()}
        emit("build", seconds=time.perf_counter() - t0, per_source_s=took,
             ptxas=logs)
        return True
    if ph in KERNEL_PHASES:
        cases = KERNEL_PHASES[ph]()
        emit(ph, cases=cases)
        return all(c["ok"] for c in cases)
    t0 = time.perf_counter()
    r = PATH_PHASES[ph]()
    emit(ph, **r, phase_s=time.perf_counter() - t0)
    return bool(r["ok"])


def _stop_group() -> None:
    """End the one-rank process group the sharded phases started."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def run_phases(names) -> int:
    """Run the named phases only (the build first where named), every one
    of them whatever the others give, for work on one kernel:
    ``python3 -c 'import chip_smoke; chip_smoke.run_phases(["build",
    "k1", "k2"])'``. Results go to chiprun_out/chip_smoke_phases.json. Not
    the full run: it prints no kernels line and no ok line, and returns 1
    where a phase failed."""
    if not _start():
        return 2
    ok = True
    for ph in names:
        try:
            good = _run_phase(ph)
        except Exception:
            traceback.print_exc()
            good = False
        if not good:
            print(f"chip_smoke.py: phase {ph} failed", file=sys.stderr)
        ok &= good
    _stop_group()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_phases.json").write_text(
        json.dumps(RESULTS, indent=1, default=str))
    return 0 if ok else 1


def main() -> int:
    if not _start():
        return 2
    import torch

    smi = RESULTS["phases"]["device"]["nvidia_smi"]
    ok = True
    try:
        for ph in PHASES:
            ok &= _run_phase(ph)
            if not ok:
                print(f"chip_smoke.py: phase {ph} failed", file=sys.stderr)
                break
    except Exception:
        traceback.print_exc()
        ok = False
    finally:
        _stop_group()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke.json").write_text(
            json.dumps(RESULTS, indent=1, default=str))
    if not ok:
        return 1

    kernels = []
    ph = RESULTS["phases"]

    def case(phase, config, dtype="bfloat16"):
        return next((c for c in ph.get(phase, {}).get("cases", [])
                     if c["config"] == config and c["dtype"] == dtype), {})

    # main-path launches: each path's run with the counters set to 0 just
    # before it (serving: engine, its K5 path, card_vs_cpu_contiguous (the
    # serving run on which K2 launches), engine_contiguous and
    # engine_sharded; training: train, train_card_vs_cpu (the run on which
    # K2 launches) and train_sharded)
    paths = {"engine": ph["engine"]["launches"],
             "engine_k5": ph["engine"]["k5_path"]["launches"],
             "card_vs_cpu_contiguous":
                 ph["card_vs_cpu_contiguous"]["launches"],
             "engine_contiguous": ph["engine_contiguous"]["launches"],
             "train": ph["train"]["launches"],
             "train_card_vs_cpu": ph["train_card_vs_cpu"]["launches"],
             "train_sharded": ph["train_sharded"]["launches"],
             "engine_sharded": ph["engine_sharded"]["launches"]}
    k1, k2, k34 = case("k1", "7b"), case("k2", "1b-w256"), case("k3k4", "1b")
    rows = [
        ("flash_attention_fwd", "ray_tpu_torch/csrc/flash_attention.cu",
         "ray_tpu/ops/flash_attention.py:37", k1, ""),
        ("flash_attention_fwd_window", "ray_tpu_torch/csrc/flash_attention.cu",
         "ray_tpu/ops/flash_attention.py:123", k2, ""),
        ("flash_attention_bwd_dq", "ray_tpu_torch/csrc/flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:251", k34, "k3_"),
        ("flash_attention_bwd_dkdv",
         "ray_tpu_torch/csrc/flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:297", k34, "k4_"),
        ("paged_decode_attention_inplace",
         "ray_tpu_torch/csrc/paged_attention.cu",
         "ray_tpu/ops/paged_attention.py:127", case("k6", "7b"), ""),
        ("paged_attention", "ray_tpu_torch/csrc/paged_attention.cu",
         "ray_tpu/ops/paged_attention.py:61", case("k5", "7b"), ""),
    ]
    emit("kernel_status", ported=[r[0] for r in rows], to_port=TO_PORT)
    for name, src, rep, c, pre in rows:
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        err = c.get("max_abs_err")
        if err is None:
            err = max(c.get(f"{x}_max_abs_err", 0.0) for x in
                      (("dq",) if pre == "k3_" else ("dk", "dv")))
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "max_abs_err": err,
                        "ms": c.get(pre + "kernel_ms"),
                        "plain_ms": c.get("plain_ms"),
                        "bound_ms": c.get(pre + "bound_ms"),
                        "bound_by": c.get(pre + "bound_by"),
                        "library_ms": c.get("library_ms")})
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        print(f"chip_smoke.py: kernels not launched on their main path: "
              f"{missing}", file=sys.stderr)
        return 1
    RESULTS["kernels"] = kernels
    (OUT_DIR / "chip_smoke.json").write_text(
        json.dumps(RESULTS, indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
