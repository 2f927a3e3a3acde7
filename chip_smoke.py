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
   for K1 the profiler's kernel names (bf16 at head dims 64/96/128/256
   runs the TMA/wgmma kernel and nothing else), for K5/K6 too (bf16 at a
   head dim that is a multiple of 8 runs the ring kernel and its merge
   pass and nothing else; two launches bit-identical), and each
   instance's ptxas registers and spills; times of the kernel (CUPTI
   device time, for K5/K6 the split and merge passes apart, and CUDA
   events), the plain version and (K1) SDPA with the names of its
   kernels, beside the bound;
4. card_vs_cpu: the 7b width cut to 2 layers, f32, the same weights in the
   port's paged LLMEngine on the card (kernels) and on the CPU (plain
   versions): greedy tokens identical, first-step logits within a stated
   bound;
5. engine: the paged serving path, LLMEngine on the 7b preset, all 32
   layers, bf16, random seeded weights, paged KV (page 64, 16 slots, 2048
   tokens), flash prefill, 12 requests of 64-1000 prompt tokens (4 sharing
   a 512-token prefix), 64 new tokens each, driven by step_n(8); the launch
   counters are set to 0 just before it and read just after; a profiled
   decode block's paged kernels all the ring kernel. Then, with 16
   slots still live at ~1000 tokens, the K5 path: ``paged_attention`` on
   all 32 layers of the engine's pools, each held against the plain
   version (its launch counter zeroed just before);
6. card_vs_cpu_contiguous: 2 layers at the 7b width, f32, greedy tokens
   identical card vs CPU in the contiguous layout, contiguous vs paged on
   the card, int8 card vs CPU, and ``sliding_window=64`` with flash card vs
   CPU (the serving run on which K2 launches); ``forward_with_cache`` at
   offset 0 (K1 over the whole cache row) card vs CPU;
7. engine_contiguous: the JAX engine's default configuration, the 7b preset
   at full width cut to ENGINE_CONTIGUOUS_LAYERS (2) of its 32 layers (the
   int8 init's host draws took 174-262 s at 32), bf16, contiguous KV, int8
   weights, flash prefill, 16
   slots, max_seq 2048, the engine phase's 12 requests: int8 bytes at rest,
   the setup's peak memory against them (and the int8 init's alone),
   peak memory, decode tokens/s, TTFT and a decode block's profile;
8. k2 / k3k4: the sliding-window forward (K2, checked as K1 is) and the
   backward kernels (K3 dQ, K4 dK/dV) against their plain versions at the
   1b train shape and others, in bf16 and f32, within ``kernel_tolerance`` /
   ``grad_tolerance``; CUPTI device times and CUDA events beside the
   bound, the plain version and SDPA (with a band mask; its backward), and
   the kernels' names (bf16 K3 and K4 at head dim 64, 80, 96, 128 or 256
   must run the TMA/wgmma dQ and dK/dV kernels and nothing else, at 16 and
   32 the small-head ones), with their ptxas registers and spills; every
   kernel phase also at the head dims and groups outside the presets (16
   in the backward, 48 zero-padded to 64, 80, 96, 256; G 3, 7, 16; HD 100
   in paged decode), bf16 timed at Phi-3-mini's and Gemma-2B's heads, and
   K1/K3/K4 at the tiny presets' heads (head dim 16, and 32 on the same
   heads) and H2O-Danube-1.8B's (80); the SFU's time for the
   exponentials (exp_ms) beside the bound; above head dim 256 every
   kernel phase holds the wide kernels (K1-K4: ``flash_fwd_wide_kernel``,
   ``flash_bwd_dq_wide_kernel``, ``flash_bwd_dkdv_wide_kernel``; K5/K6:
   the any-shape paged kernel) at head dim 512 (bf16 timed: flash at B 2
   S 1024 H 8 KV 2 causal, K2 under window 128; paged at 16 slots, H 8
   KV 2) and 320, in both dtypes, by name and against the plain versions;
9. shapes: public model shapes outside the presets (SHAPE_MODELS):
   Phi-3-mini (head dim 96), Llama-3.2-3B (G 3), Gemma-2B's attention
   (head dim 256, G 8), H2O-Danube-1.8B (head dim 80, sliding window) and
   DeepSeek-V4-Flash's attention (head dim 512, G 8: the wide kernels in
   every pass, and its 128-token window trained apart), each cut to 2
   layers in f32 card vs CPU (prefill logits, the engine's
   greedy tokens, loss_fn and its gradients, the attention's gradients
   within grad_tolerance), and loss_fn's gradients in bf16 compute on the
   card against the f32 card run's (SHAPES_BF16_GRAD_RTOL; the TMA/wgmma
   K3/K4 at head dims 80, 96 and 256 on that path); each served at full
   width in bf16 (flash prefill, paged but for the windowed Danube, whose
   traced decode steps run the ring kernel only, the any-shape one at
   head dim 512; Phi-3-mini at 8 of its 32 layers and DeepSeek-V4-Flash
   at 2, both with the K5 path over their pools, Danube at 2, the others
   at 4): 4 greedy prompts of 64-512 tokens, 32 new tokens each, TTFT,
   decode tokens/s, peak memory;
   the tiny presets (Llama and MoE, head dim 16) trained with flash, 3
   AdamW steps card vs CPU; its launches counted from 0;
10. train_card_vs_cpu: 2 layers at the 1b width, f32, 2 AdamW steps on the
   card and on the CPU from one init, without and with a sliding window
   (the run on which K2 launches): losses, grad norms and params within
   stated bounds;
11. train: the training main path, the 1b preset at full width and 16
   layers, bf16 compute, remat, flash, B 8 S 1024, 10 steps after a
   warm-up: falling finite losses, exact K1/K3/K4 launch counts, step time,
   tokens/s, MFU, peak memory and one step's device profile (whose forward
   attention kernels must all be the TMA/wgmma one, as in the engines'
   prefill profiles, and its dQ and dK/dV kernels the TMA/wgmma ones);
12. train_sharded: the train phase's recipe through the sharded entry
   points (make_train_state_init / make_train_step / loss_fn with mesh=
   a 1-rank NCCL mesh and rules=ShardingRules.fsdp_tp()): losses within
   TRAIN_SHARDED_LOSS_RTOL of the train phase's, its exact launch counts,
   only the three TMA/wgmma flash kernels in a step's profile, params and
   AdamW moments as DTensors; step time, tokens/s and peak memory;
13. sp_pp: sequence and pipeline parallelism through ``forward_sp`` (ring,
   then Ulysses) and ``forward_pp`` (gpipe, then 1f1b, M 2, flash) under
   ``make_train_step`` on a 1-rank NCCL mesh (``ShardingRules.full()``):
   the 1b preset at full width cut to SP_PP_LAYERS (4) of its 16 layers,
   bf16 compute over f32 masters, B 4 S 1024, two AdamW steps a route from
   one seeded init:
   each first loss within SP_PP_LOSS_RTOL of forward's on the same batch
   and weights, the pipeline's exact K1/K3/K4 launches, ms a step and
   peak memory; then the four routes at the 1b width cut to 2 layers in
   f32 without a mesh, card vs CPU (losses and grad norms within 1e-4,
   each route's logits within LOGITS_TOL of forward's). One rank: no
   collective runs;
14. moe: the MoE model's 8x1b preset (~4.8 B params, 8 experts, top-2),
   flash, bf16 compute: card vs CPU at 2 layers in f32 (the routing of
   every layer equal, then the loss and every gradient); ``loss_fn`` at
   all 16 layers, B 4 S 1024, timed with its peak memory; training at
   full width cut to 4 layers, 5 AdamW steps after a warm-up, falling
   finite losses, exact K1/K3/K4 launches, ms a step, tokens/s, peak
   memory and a step's device profile;
15. vit: ViT-B/16 (224 x 224, ~86 M params), bf16 over f32, B 64 seeded
   images, 5 AdamW steps after a warm-up: falling finite losses, images/s,
   peak memory and a step's profile; card vs CPU at 2 layers in f32. No
   kernel of ours;
16. trainer: the train layer through ``DataParallelTrainer`` (BASELINE
   target 1): GPT-2 card vs CPU (the 125m width cut to 2 layers, f32, 2
   AdamW steps, within the train_card_vs_cpu bounds); GPT-2 125M at full
   width and all 12 layers (bf16 compute, f32 params, remat, B 8 S 1024)
   in a train worker holding one GPU unit, 20 steps with a DCP checkpoint
   every 10, dying after the step-10 one and resuming from it under
   FailureConfig(max_failures=1): losses finite, falling and bit for bit
   those of an uninterrupted run (deterministic algorithms), the result's
   checkpoint loaded in the driver equal to the worker's last saved
   params, the worker's peak memory under the card's, no flash kernel
   launched; the 1b Llama recipe cut to 4 layers for 3 steps in a worker,
   its K1/K3/K4 launches exact and its losses within
   TRAIN_SHARDED_LOSS_RTOL of the same run in process; no process left
   after ``shutdown()``; step time, tokens/s, MFU, peak memory, DCP
   seconds and bytes and a GPT-2 step's device profile;
17. data: the data layer (``ray_tpu_torch.data``) in a session of the
   port's runtime: GPT-2 125M at full width trained from a Dataset
   (``from_numpy`` of 96 rows of 1025 seeded tokens in 8 blocks,
   ``map_batches``, ``random_shuffle``) through ``DataParallelTrainer``
   in a worker holding one GPU unit, fed by ``iter_device_batches``
   (pinned staging, a copy stream, events): 12 batches on the card equal
   bit for bit to the driver's ``iter_batches``, 12 losses equal bit for
   bit to the same loop run in process on host batches moved with a
   plain ``.to("cuda")``, finite and falling; then the 1b preset at full
   width and depth (bf16, flash) through ``BatchPredictor`` over 64 rows
   of 512 seeded tokens in 8 blocks in a one-GPU actor: greedy tokens
   and logits equal to the same predictor in process, K1 launched
   exactly 16 x 8 times in the actor; no process left after
   ``shutdown()``; step time, tokens/s, MFU, the host's wait in next(),
   the copies' streams and overlap in a profiled window, the actor's
   start, the checkpoint load and rows/s as information;
18. rl: the RL layer (``ray_tpu_torch.rl``, BASELINE target 5): PPO on
   PixelCatcher (84 x 84 RGB) through atari_connectors (grayscale, resize
   84, scale, 4 frames) into the Nature CNN + dense 512 (1.68 M params),
   4 CPU rollout actors of 1,250 steps (the card hidden from them), the
   learner on the card in f32, rllib's atari-ppo settings (minibatch 500,
   10 epochs, clip 0.1), 3 iterations: the learner on the card and the
   actors without CUDA; iteration 1's batch through one minibatch update
   (gradients) and one run_ppo_epochs card vs CPU (and f64 on the card)
   within derived bounds; 5,000 timesteps an iteration, finite losses;
   each iteration's sampling and learning time, env steps/s, ms per
   update, a profiled learn window's idle share, peak memory. No kernel of
   ours runs (the reference's RL reaches no Pallas kernel);
19. rl_offpolicy: the RL layer's off-policy and offline learners on the
   card at their configs' defaults, CPU rollout and replay actors: SAC on
   a numpy Pendulum-v1 and DQN on a numpy CartPole-v1 (``CartPole`` and
   ``Pendulum`` below: gymnasium is not installed beside the card), 10
   iterations each, CQL on SAC's 1,000 transitions, and one train() of
   TD3, DDPG, Ape-X DQN/DDPG, R2D2, SimpleQ, BC, CRR, MARWIL and DT:
   placement, one update and one iteration's updates card vs CPU (and
   f64), timesteps, finite losses and Q values, DQN's target syncs, the
   sweep's moved weights, no process left; ms an update against its
   bound, env steps/s, a SAC learn window's idle share, peak memory. No
   kernel of ours runs;
20. engine_sharded: the engine phase's paged 7b engine with mesh= (1 rank)
   and rules=fsdp_tp over the engine phase's first wave: every greedy
   request's tokens equal to the engine phase's; decode tokens/s and peak
   memory. On one rank every placement is Replicate: these two prove the
   mesh plumbing and the kernels under it, not collectives;
21. runtime: the port's runtime on this node (``ray_tpu_torch.init``, the
   GPU detected without an override): an actor with ``num_gpus=1`` builds
   the engine phase's paged 7b engine in a worker process and serves the
   engine_sharded phase's wave 1 through one method call (K1 and K6
   counted in that process): greedy tokens equal to the engine phase's,
   the engine's tokens counter read back from the cluster's metrics, its
   KV pool in the memory plane while requests are live; the device tier
   (the bf16 embedding put in the actor: same-process get is the tensor,
   the driver's get bit-exact); the no-op round trip and the staging
   rate; after ``shutdown()`` no process of the session alive;
22. serve: the monolithic app through the serve layer: ``serve.run`` of an
   ``LLMServer`` replica (``num_gpus=1``; the engine phase's paged 7b
   engine at SERVE_LAYERS (4) of its 32 layers, decode_block 8) behind an
   ``LLMRouter`` with an HTTP route;
   four greedy prompts one at a time through the router's streaming
   handle, then again as HTTP POSTs (two plain, two ``?stream=1``), equal
   token for token to an in-process engine run first on the same prompts
   in the same order; then the engine phase's 12 requests streamed at
   once; every stream's frames against its final frame, K1/K6 counted in
   the replica, its tokens counter read back from the GCS, the router's
   request count with no 429, no process left after shutdown;
23. serve_disagg: one prefill and one decode replica (0.5 GPU unit each,
   8 slots, page groups of 4 pages, SERVE_LAYERS deep) behind
   ``DisaggRouter``; seven greedy
   prompts one at a time, equal to the handoff replayed in process (engine
   A prefills and exports each full group, a fresh engine B imports them
   and generates); each group crossing the store once at its byte size,
   every handoff acked, K1 in the prefill and K6 in the decode replica;
24. rl_final: the RL layer's last five algorithms at their configs'
   defaults on their own numpy envs, learners on the card, CPU actors:
   QMIX (two-step game), MADDPG (line spread), MAML (point goals),
   AlphaZero (TicTacToe self-play with MCTS) and SlateQ (slate
   recommendation), 2-5 iterations each: placement, one update and one
   iteration's updates card vs CPU (and f64), finite losses, moved
   weights, QMIX's and SlateQ's target syncs, MADDPG's exact polyak step,
   no process left; a learn window's idle share and kernels per update
   each, MAML's second-order meta-update against its first-order cost. No
   kernel of ours runs;
25. tune: ``ray_tpu_torch.tune`` sweeping GPT-2 125M's lr over two values
   under ASHA (max_t 8, grace 2, halving), one trial at a time, each
   holding the card: the params on the card, trial 0's first loss against
   the same step run in the driver, ASHA's decisions replayed, the best
   result, the CSV/JSON logs, no process left; each trial's start, init
   and step time, the card's idle share between trials. No kernel of ours
   runs (GPT-2's attention is plain);
26. ops: the operator surface (``phase_ops``): a cluster brought up by
   ``launcher.up`` from a JSON config (no GPU unit on the head, an
   autoscaled ``gpu_node`` type holding the card), the port's dashboard
   head on it; (a) a ``num_gpus=1`` actor makes the monitor launch one
   ``gpu_node`` and serves 4 greedy prompts on the 1b preset's paged
   engine (16 layers, flash): tokens and K1/K6 launches in its process
   equal to the same engine here, the node scaled down after the actor's
   kill with no process or card memory left; (b) the 4-layer 1b training
   recipe as jobs through the head's REST routes: losses and K1/K3/K4
   launches against the same run here, a looping job stopped and gone
   from the card, ``/metrics`` as Prometheus text; (c) a durable
   workflow, train (a DCP checkpoint) then serve, failing once in serve
   and resumed: train run once, the tokens equal to an engine here loaded
   from the checkpoint; ``launcher.down`` leaves no process;
27. lint: raylint over the port's tree as a user runs it (``python -m
   ray_tpu_torch.cli lint --no-cache --json ray_tpu_torch``, pure ``ast``,
   in a subprocess): exit 0, no unsuppressed finding, no parse error,
   more than 100 files, under LINT_MAX_S; its files, findings and
   seconds. No kernel;
28. kernels: one line with every kernel's numbers;
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
# the flash kernels' exponentials, reported beside the bound and not in
# it: the SFU's ex2 at 16 an SM a clock on 132 SMs at the card's maximum
# SM clock (1,980 MHz: nvidia-smi's clocks.max.sm on an H100 SXM). Not a
# hard floor: exp2 can also be computed on the FMA pipes
SMS = 132
SM_CLOCK_MAX_HZ = 1.98e9
EXP_PER_S = SMS * 16 * SM_CLOCK_MAX_HZ

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

# sp_pp runs the 1b width at this depth, of its 16 layers (the script's
# time limit)
SP_PP_LAYERS = 4
# sp_pp: a route's first-step loss (bf16 compute, 4 layers, ~10.4 at the
# seeded init) against forward's (flash) on the same batch and weights.
# Ring and Ulysses round their attention once more to bf16 and sum in
# another order (2^-8 relative an element), the pipeline runs 2
# microbatches through other matmul shapes; the mean nll over 4096 tokens
# moves far less than one element: 2e-3 relative
SP_PP_LOSS_RTOL = 2e-3
# moe card vs CPU, 2 layers at the 8x1b width in f32 (no TF32), the routing
# equal first: every gradient leaf within 1e-4 of its own largest element
# (f32 sums of 2048- and 5632-long products in another order, ~1e-6)
MOE_GRAD_RTOL = 1e-4

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


def device_ms(fn, iters: int = 20, names=None, per_call=None,
              by_name=None) -> float:
    """Mean device milliseconds of the kernels one fn() call launches
    (CUPTI, under torch.profiler), after a warm-up: the kernels' own time,
    which cuda_ms cannot give when launching a call takes the host longer
    than the card takes to run it (the paged kernels, ~0.08 ms). The
    kernels' names (from every trace taken) are added to the set `names`
    where one is given. CUPTI now and then drops kernels from a trace, and
    late in a long run it can drop every kernel of a few traces in a row:
    where `per_call` (the kernels one call launches) is given, a trace
    with another count is taken again, up to 10 times; otherwise a trace
    with none is, up to 3 times. `by_name`, where given, gets each kernel
    name's device ms, one entry a launch, from the trace kept."""
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
    if by_name is not None:
        for name, ms in events:
            by_name.setdefault(name, []).append(ms)
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


# the paged decode kernels (csrc/paged_attention.cu): the ring kernel, which
# every bf16 launch at a head dim up to 256 that is a multiple of 8 must
# run, the f32 kernel of G 1, 2, 4, 8 at power-of-two rows, the any-shape
# kernel (other shapes, and every head dim above 256) and the merge pass
# after each
RING_SYMBOL = "paged_decode_ring_kernel"
FIXED_SYMBOL = "paged_decode_split_kernel"
ANY_SYMBOL = "paged_decode_split_any_kernel"
MERGE_SYMBOL = "paged_decode_merge_kernel"


def paged_symbol(dtype: str, head_dim: int, G: int) -> str:
    """The K5/K6 split kernel a dtype, head dim and group count must run."""
    if head_dim > 256:
        return ANY_SYMBOL
    if dtype == "bfloat16":
        return RING_SYMBOL if head_dim % 8 == 0 else ANY_SYMBOL
    fixed = (G in (1, 2, 4, 8) and head_dim % 4 == 0
             and 32 % (head_dim // 4) == 0)
    return FIXED_SYMBOL if fixed else ANY_SYMBOL


def ring_instance(head_dim: int) -> int:
    """The ring kernel's template instance (16-dim k-steps) at a head dim."""
    return 8 if head_dim <= 128 and head_dim % 16 == 0 else 16


def ran_paged_only(names, symbol) -> bool:
    """Paged decode kernel names: at least one split kernel, every split
    kernel `symbol` (the merge pass beside it)."""
    split = [n for n in names if "paged_decode" in n and MERGE_SYMBOL not in n]
    return ran_only(split, symbol)


def paged_times(res, run, dtype, HD, G, timed):
    """The profiler's view of a K5/K6 case: the kernels' names, the gate
    that a bf16 launch at a head dim that is a multiple of 8 ran the ring
    kernel (and others the any-shape one), and, timed, the device ms of
    the split and merge passes apart (their sum ``kernel_ms``). Each pass's
    time is the mean over the launches the trace holds: CUPTI can drop a
    kernel from a trace (often a short trace's first), which a trace of
    one call would miss and a sum would undercount."""
    import statistics

    import torch

    if timed:
        # the card's clocks up before the trace
        for _ in range(50):
            run()
        torch.cuda.synchronize()
    names, by_name = set(), {}
    # a split and a merge kernel a call: a trace that dropped one is taken
    # again, up to 10 times
    device_ms(run, iters=20 if timed else 3, names=names, per_call=2,
              by_name=by_name)
    res["kernels"] = sorted(names)
    res["ran_expected_kernel"] = ran_paged_only(
        names, paged_symbol(dtype, HD, G))
    if timed:
        merge = [x for n, v in by_name.items() if MERGE_SYMBOL in n for x in v]
        split = [x for n, v in by_name.items()
                 if "paged_decode" in n and MERGE_SYMBOL not in n for x in v]
        res["merge_ms"] = statistics.fmean(merge) if merge else None
        res["split_ms"] = statistics.fmean(split) if split else None
        res["launches_traced"] = [len(split), len(merge)]
        res["kernel_ms"] = (res["split_ms"] + res["merge_ms"]
                            if split and merge else None)
    if paged_symbol(dtype, HD, G) == RING_SYMBOL:
        res["ptxas"] = _ptxas_of("paged_attention", RING_SYMBOL,
                                 ring_instance(HD))
    elif HD > 256:
        res["ptxas"] = _ptxas_of("paged_attention", ANY_SYMBOL, HD, dtype)


def paged_counters(HD: int):
    """The launch counters of (K6, K5) at head dim HD (ops/paged_attention.
    py): the wide ones above 256."""
    return (("launches_wide", "launches_read_wide") if HD > 256
            else ("launches", "launches_read"))


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


def k6_case(*, S, H, KV, HD, ps, maxP, dtype, seed, timed=True):
    """One K6 comparison on paged_inputs; timed: its device time, the
    plain version's and the bound."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    (q, kn, vn, kp0, vp0, pt, ln), lengths = paged_inputs(
        S=S, H=H, KV=KV, HD=HD, ps=ps, maxP=maxP, dtype=dtype, seed=seed)
    kp, vp = kp0.clone(), vp0.clone()
    c6 = paged_counters(HD)[0]
    before = getattr(pa, c6)
    o, _, _ = pa.paged_decode_attention_inplace(q, kn, vn, kp, vp, pt, ln)
    kp_ref, vp_ref = kp0.clone(), vp0.clone()
    o_ref, _, _ = pa.paged_decode_attention_inplace_reference(
        q, kn, vn, kp_ref, vp_ref, pt, ln)
    torch.cuda.synchronize()
    if getattr(pa, c6) != before + 1:
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

    # two launches on the same inputs give the same bits
    o2, _, _ = pa.paged_decode_attention_inplace(q, kn, vn, kp, vp, pt, ln)
    res["repeat_identical"] = bool(torch.equal(o, o2))
    ok = ok and res["repeat_identical"]
    if timed or dtype == "bfloat16":
        paged_times(res, run, dtype, HD, H // KV, timed)
        ok = ok and (res["ran_expected_kernel"] or dtype != "bfloat16")
    res["ok"] = ok
    if not timed:
        setattr(pa, c6, before)
        return res

    res["event_ms"] = cuda_ms(run, iters=50)   # bound by the host's launches
    setattr(pa, c6, before)   # timing launches are not main-path launches
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
    return res


# (H, KV, HD) of the paged decode shapes outside the presets: the public
# models of the shapes phase (SHAPE_MODELS) and Qwen2-7B (G 7), timed in
# bf16, and more (16 query heads a kv head, two chunks of 8; HD 100, not a
# multiple of a 16-byte vector: the any-shape kernel); above 256, where the
# any-shape kernel runs in both dtypes, DeepSeek-V4-Flash's head dim 512
# at H 8 KV 2 (timed in bf16) and HD 320 at G 4
PAGED_SHAPES = (("phi3-mini", (32, 32, 96), True),
                ("gemma-2b", (8, 1, 256), True),
                ("llama3.2-3b", (24, 8, 128), True),
                ("qwen2-7b", (28, 4, 128), True),
                ("g16", (16, 1, 64), False),
                ("hd100", (4, 2, 100), False),
                ("hd512", (8, 2, 512), True),
                ("hd320", (4, 1, 320), False))


def _paged_phase(case_fn):
    cases = []
    for name, (H, KV) in (("7b", (32, 32)), ("1b-gqa", (16, 8))):
        for dtype in ("bfloat16", "float32"):
            r = case_fn(S=16, H=H, KV=KV, HD=128, ps=64, maxP=32,
                        dtype=dtype, seed=1)
            r["config"] = name
            cases.append(r)
    for name, (H, KV, HD), timed in PAGED_SHAPES:
        for dtype in ("bfloat16", "float32"):
            r = case_fn(S=16, H=H, KV=KV, HD=HD, ps=64, maxP=32,
                        dtype=dtype, seed=1,
                        timed=timed and dtype == "bfloat16")
            r["config"] = name
            cases.append(r)
    return cases


def phase_k6():
    """K6 timed at the 7b serving shape and the 1b GQA shape (HD 128, G 1
    and 2), bf16 and f32, and in bf16 at Phi-3-mini's HD 96, Gemma-2B's
    HD 256 (G 8), Llama-3.2-3B's G 3, Qwen2-7B's G 7 and HD 512 (G 4, the
    any-shape kernel); untimed there in f32 and at G 16, HD 100 and HD 320
    in both. Every bf16 case traces its
    kernels' names (``paged_times``); two launches give the same bits."""
    return _paged_phase(k6_case)


# --- K5: read-only paged decode attention -------------------------------------


def k5_case(*, S, H, KV, HD, ps, maxP, dtype, seed, timed=True):
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
    c6, c5 = paged_counters(HD)
    before, before6 = getattr(pa, c5), getattr(pa, c6)
    o = pa.paged_attention(q, kp, vp, pt, ln)
    o_ref = pa.paged_attention_reference(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    if getattr(pa, c5) != before + 1:
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

    # two launches on the same inputs give the same bits
    res["repeat_identical"] = bool(torch.equal(
        o, pa.paged_attention(q, kp, vp, pt, ln)))
    ok = ok and res["repeat_identical"]
    if timed or dtype == "bfloat16":
        paged_times(res, run, dtype, HD, H // KV, timed)
        ok = ok and (res["ran_expected_kernel"] or dtype != "bfloat16")
    res["ok"] = ok
    if not timed:
        setattr(pa, c5, before)
        setattr(pa, c6, before6)
        return res

    res["event_ms"] = cuda_ms(run, iters=50)   # bound by the host's launches
    # comparison and timing launches are not main-path launches
    setattr(pa, c5, before)
    setattr(pa, c6, before6)
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
    return res


def phase_k5():
    """K5 at K6's shapes (``_paged_phase``)."""
    return _paged_phase(k5_case)


# --- K1 / K2: the flash forward ---------------------------------------------


# the symbols of the forward kernels (K1/K2, csrc/flash_attention.cu): the
# TMA/wgmma kernel, which every bf16 launch with head dim 64, 80, 96, 128
# or 256 must run, and the small-head kernel (head dims 16 and 32); of the
# TMA/wgmma dQ kernel (K3) and dK/dV kernel (K4), which every bf16 launch
# with head dim 64, 80, 96, 128 or 256 must run, and of their small-head
# kernels (csrc/flash_attention_bwd.cu)
WGMMA_FWD_SYMBOL = "flash_fwd_wgmma_kernel"
SMALL_FWD_SYMBOL = "flash_fwd_small_kernel"
WGMMA_DQ_SYMBOL = "flash_bwd_dq_wgmma_kernel"
WGMMA_DKDV_SYMBOL = "flash_bwd_dkdv_wgmma_kernel"
SMALL_DQ_SYMBOL = "flash_bwd_dq_small_kernel"
SMALL_DKDV_SYMBOL = "flash_bwd_dkdv_small_kernel"
# above head dim 256, both dtypes: the wide kernels (D at run time)
WIDE_FWD_SYMBOL = "flash_fwd_wide_kernel"
WIDE_DQ_SYMBOL = "flash_bwd_dq_wide_kernel"
WIDE_DKDV_SYMBOL = "flash_bwd_dkdv_wide_kernel"


def fwd_symbol(dtype: str, head_dim: int) -> str:
    """The K1/K2 kernel a dtype and kernel head dim must run."""
    if head_dim > 256:
        return WIDE_FWD_SYMBOL
    if dtype != "bfloat16":
        return "flash_fwd_f32_kernel"
    return SMALL_FWD_SYMBOL if head_dim in (16, 32) else WGMMA_FWD_SYMBOL


def bwd_symbols(dtype: str, head_dim: int):
    """The (K3, K4) kernels a dtype and kernel head dim must run."""
    if head_dim > 256:
        return WIDE_DQ_SYMBOL, WIDE_DKDV_SYMBOL
    if dtype != "bfloat16":
        return "flash_bwd_dq_f32_kernel", "flash_bwd_dkdv_f32_kernel"
    if head_dim in (16, 32):
        return SMALL_DQ_SYMBOL, SMALL_DKDV_SYMBOL
    return WGMMA_DQ_SYMBOL, WGMMA_DKDV_SYMBOL


def band_pairs(S: int, T: int, causal: bool, window=None) -> int:
    """(query, key) pairs a band keeps: the work of one (batch, head)."""
    if not causal:
        return S * T
    w = window or max(S, T)
    return sum(max(0, min(s + 1, T) - max(0, s - w + 1)) for s in range(S))


def fwd_bound(*, B, S, T, H, KV, D, dtype, causal=True, window=None):
    """K1's (K2's) {"bound_ms", "bound_by", "exp_ms"}: q, k, v read and out,
    lse written once; the two products; beside them the SFU's time for an
    exponential a (query, key) pair of the band."""
    elt = 4 if dtype == "float32" else 2
    work = B * H * band_pairs(S, T, causal, window)
    nbytes = elt * (2 * B * S * H * D + 2 * B * T * KV * D) + 4 * B * H * S
    ms, by = bound(nbytes, 4 * work * D, dtype)
    return {"bound_ms": ms, "bound_by": by, "exp_ms": work / EXP_PER_S * 1e3}


def k3k4_bounds(*, B, S, H, KV, D, dtype, causal=True, window=None):
    """{"k3_bound_ms", "k3_bound_by", "k4_...": ..., "exp_ms"} at T = S: K3
    reads q, o, dO, k, v, lse and writes dq, delta, with 3 products; K4
    reads q, dO, k, v, lse, delta and writes dk, dv, with 4; beside them
    the SFU's time for the exponentials each recomputes (P, one a (query,
    key) pair of the band)."""
    elt = 4 if dtype == "float32" else 2
    work = B * H * band_pairs(S, S, causal, window)
    bshd, btkd, bhs = B * S * H * D, B * S * KV * D, B * H * S
    k3 = bound(elt * (4 * bshd + 2 * btkd) + 8 * bhs, 6 * work * D, dtype)
    k4 = bound(elt * (2 * bshd + 4 * btkd) + 8 * bhs, 8 * work * D, dtype)
    return {"k3_bound_ms": k3[0], "k3_bound_by": k3[1],
            "k4_bound_ms": k4[0], "k4_bound_by": k4[1],
            "exp_ms": work / EXP_PER_S * 1e3}


def fwd_case(*, B, S, H, KV, D, dtype, causal=True, window=None, T=None,
             seed, timed=True):
    """One forward case (K1, or K2 under a window) against the plain
    version on the same inputs: out within kernel_tolerance, the LSE within
    LSE_TOL; the profiler's kernel names (``fwd_symbol`` and nothing
    else) and the instance's
    ptxas registers and spills from the build phase. Timed: the kernel by
    CUDA events (cuda_ms, through the wrapper) and by CUPTI device time
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
    counter = fwd_counter(D, window)
    before = {c: getattr(fa, c) for c in FWD_COUNTERS}

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
    if getattr(fa, counter) != before[counter] + 1:
        raise AssertionError("forward wrapper did not launch its kernel")
    err, over = held(out, ref, fa.kernel_tolerance(q, k, v, ref,
                                                   causal=causal,
                                                   window=window))
    lse_err = float((lse - lse_ref).abs().max())
    finite = bool(torch.isfinite(out.float()).all())
    names: set = set()
    dev = device_ms(run, iters=10, names=names, per_call=1)
    # the kernel its head dim (zero-padded to the next compiled one where
    # the kernels are not compiled for it) and dtype must run
    dk = fa.kernel_head_dim(D)
    symbol = fwd_symbol(dtype, dk)
    ran_new = ran_only([n for n in names if "flash_" in n], symbol)
    shape = f"B={B} S={S} T={T} H={H} KV={KV} D={D}"
    res = {"shape": shape + (f" window={window}" if window else ""),
           "dtype": dtype, "causal": causal, "max_abs_err": err,
           "max_err_over_tol": over,
           "tol": "1e-4" if dtype == "float32"
           else "2^-7 (attention of |v| + |plain|) + 1e-5",
           "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
           "kernel_names": sorted(names), "kernel_head_dim": dk,
           "expects_kernel": symbol, "ran_expected_kernel_only": ran_new,
           "ptxas": _ptxas_of("flash_attention", symbol, dk, dtype)}
    ok = finite and over <= 1.0 and lse_err <= LSE_TOL and ran_new
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
        res.update(fwd_bound(B=B, S=S, T=T, H=H, KV=KV, D=D, dtype=dtype,
                             causal=causal, window=window))
    # comparison and timing launches are not main-path launches
    for c, n in before.items():
        setattr(fa, c, n)
    res["ok"] = ok
    return res


# the forward's launch counters (ops/flash_attention.py): K1 and K2, at
# head dims up to 256 and above (the wide kernel)
FWD_COUNTERS = ("launches", "launches_window", "launches_wide",
                "launches_wide_window")


def fwd_counter(D: int, window) -> str:
    """The counter a forward launch at head dim D (and `window`) moves."""
    from ray_tpu_torch.ops import flash_attention as fa

    return ("launches" + ("_wide" if fa._wide(fa.kernel_head_dim(D)) else "")
            + ("_window" if window else ""))


def phase_k1():
    """K1 timed at the 7b prefill shape (B 8, S = T = 1024, H = KV = 32, D
    128, causal), the 1b GQA shape (H 16, KV 8) and debug-125m's heads (H =
    KV = 12, D 64), in bf16 and f32; untimed: ragged S = T = 200 causal and
    full, S = T = 1000 (a ragged last 128-row tile), S = T = 130 (one row
    past a tile), T = 512 > S = 256 (forward_with_cache's cache row); then
    bf16 timed at FLASH_SMALL_TIMED's heads (head dims 16, 32, 80), the
    head dims outside the presets and, above 256, FLASH_WIDE's."""
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
    return (cases + _small_head_fwd_cases() + _head_dim_fwd_cases(window=None)
            + _wide_fwd_cases(window=None))


# bf16 rows timed at B 8 S 1024 causal, K1 and (but for the tiny heads,
# timed in phase_k3k4 with f32 beside them) K3/K4: the tiny presets' heads
# (head dim 16), the same heads at 32, and H2O-Danube-1.8B's attention
# (h2oai/h2o-danube-1.8b-base: hidden 2560 over 32 heads, 8 kv heads: head
# dim 80)
FLASH_SMALL_TIMED = (("tiny", dict(H=4, KV=2, D=16)),
                     ("tiny-d32", dict(H=4, KV=2, D=32)),
                     ("danube", dict(H=32, KV=8, D=80)))


def _small_head_fwd_cases():
    """K1 timed in bf16 at FLASH_SMALL_TIMED's heads, B 8 S 1024 causal."""
    cases = []
    for name, shape in FLASH_SMALL_TIMED:
        r = fwd_case(B=8, S=1024, **shape, dtype="bfloat16", seed=4)
        r["config"] = name
        cases.append(r)
    return cases


def _small_head_bwd_cases():
    """K3/K4 timed in bf16 at FLASH_SMALL_TIMED's heads but the tiny ones
    (timed in phase_k3k4 with f32 beside them), B 8 S 1024 causal."""
    cases = []
    for name, shape in FLASH_SMALL_TIMED[1:]:
        r = k3k4_case(B=8, S=1024, **shape, causal=True, window=None,
                      dtype="bfloat16", seed=22)
        r["config"] = name
        cases.append(r)
    return cases


# the flash shapes outside the presets: Phi-3-mini's head dim 96 and
# Gemma-2B's 256 (G 8) timed at the 7b prefill size; untimed at ragged S,
# causal (so windowed in k2 too) and full: head dim 16 (G 3), 32 (G 2), 48
# (zero-padded to 64), 80 (G 4, and full), 96 (G 7) and 256 (T 512 > S)
FLASH_TIMED = (("phi3-mini", dict(H=32, KV=32, D=96)),
               ("gemma-2b", dict(H=8, KV=1, D=256)))
FLASH_UNTIMED = (("d16-g3", dict(S=200, H=6, KV=2, D=16), True),
                 ("d32-g2", dict(S=200, H=4, KV=2, D=32), True),
                 ("d48", dict(S=200, H=8, KV=2, D=48), True),
                 ("d80", dict(S=200, H=8, KV=2, D=80), True),
                 ("d80-full", dict(S=200, H=4, KV=4, D=80), False),
                 ("d96-g7", dict(S=200, H=7, KV=1, D=96), True),
                 ("d256-t512", dict(S=256, T=512, H=8, KV=1, D=256), True))


def _head_dim_fwd_cases(window):
    """FLASH_TIMED (bf16 timed at B 8, f32 untimed at B 2; S 1024) and
    FLASH_UNTIMED (B 2, bf16) under `window` (the untimed full case skipped
    under one)."""
    cases = []
    tag = f"-w{window}" if window else ""
    for name, shape in FLASH_TIMED:
        for dtype, B in (("bfloat16", 8), ("float32", 2)):
            r = fwd_case(B=B, S=1024, **shape, window=window, dtype=dtype,
                         seed=4, timed=dtype == "bfloat16")
            r["config"] = name + tag
            cases.append(r)
    for name, shape, causal in FLASH_UNTIMED:
        if window and not causal:
            continue
        # bf16 only here: the f32 kernels at these head dims are held by
        # the cuda tests of tests/test_torch_flash_attention.py
        r = fwd_case(B=2, **shape, causal=causal, window=window,
                     dtype="bfloat16", seed=5, timed=False)
        r["config"] = name + tag
        cases.append(r)
    return cases


# above head dim 256 (the wide kernels, both dtypes): DeepSeek-V4-Flash's
# head dim 512 at H 8 KV 2 (G 4), bf16 timed and f32 untimed at B 2 S 1024
# causal (K2: its sliding window, 128), and head dim 320 at G 1, ragged S
# 200, untimed in both dtypes
FLASH_WIDE = (("d512", dict(B=2, S=1024, H=8, KV=2, D=512), True),
              ("d320", dict(B=2, S=200, H=4, KV=4, D=320), False))
WIDE_WINDOW = 128


def _wide_fwd_cases(window):
    """K1 (K2 under `window`) at FLASH_WIDE's shapes."""
    cases = []
    tag = f"-w{window}" if window else ""
    for name, shape, timed in FLASH_WIDE:
        for dtype in ("bfloat16", "float32"):
            r = fwd_case(**shape, window=window, dtype=dtype, seed=6,
                         timed=timed and dtype == "bfloat16")
            r["config"] = name + tag
            cases.append(r)
    return cases


def phase_k2():
    """K2 timed at the 1b train shape (B 8, S 1024, H 16, KV 8, D 128) with
    windows 256 and 1024 (the whole causal band), and at debug-125m's heads
    (H = KV = 12, D 64) with window 256, in bf16 and f32; untimed: ragged
    S = T = 200 with window 64, S = T = 1000 with window 200; then the head
    dims outside the presets under window 96 and FLASH_WIDE's under
    WIDE_WINDOW (128)."""
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
    return (cases + _head_dim_fwd_cases(window=96)
            + _wide_fwd_cases(window=WIDE_WINDOW))


# --- K3 / K4: the flash backward ----------------------------------------------


def k3k4_case(*, B, S, H, KV, D, causal, window, dtype, seed, timed=True):
    """K3 and K4 against the plain backward on the same (q, k, v, out, lse,
    dO), dq/dk/dv elementwise within grad_tolerance, bit-identical on a
    second run; the names of the kernels each pass ran (``bwd_symbols``:
    bf16 K3 and K4 at head dim 64, 80, 96, 128 or 256 must run
    WGMMA_DQ_SYMBOL and WGMMA_DKDV_SYMBOL, at 16 and 32 SMALL_DQ_SYMBOL and
    SMALL_DKDV_SYMBOL, with their cluster sizes; nothing else where timed,
    no other flash kernel in an untimed bf16 case) and their ptxas
    registers and spills from the build phase. Timed: each kernel by CUPTI
    device time (device_ms) and by CUDA events, the plain backward and
    SDPA's backward (bf16 only), beside the bounds (``k3k4_bounds``)."""
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
    wide = "_wide" if fa._wide(fa.kernel_head_dim(D)) else ""
    counters = ("launches_dq" + wide, "launches_dkdv" + wide)
    before = tuple(getattr(fa, c) for c in counters)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                             causal=causal, window=window)
    tols = fa.grad_tolerance(q, k, v, out, lse, g, plain, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    if tuple(getattr(fa, c) for c in counters) != (before[0] + 2,
                                                   before[1] + 2):
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
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, g,
                                          causal=causal, window=window)

    def k3():
        fa.flash_attention_bwd_dq(q, k, v, out, lse, g, causal=causal,
                                  window=window)

    def k4():
        fa.flash_attention_bwd_dkdv(q, k, v, lse, g, delta, causal=causal,
                                    window=window)

    # the kernels each pass ran: timed, from the timing runs, where every
    # kernel must be the expected one (the time is theirs); untimed, in
    # bf16, from traces of both passes, where each pass's flash kernels
    # must (beside any pad's). Late in a long run CUPTI drops kernels from
    # short traces, so a trace runs both three times and is taken again,
    # up to 5 times, until it holds a kernel of each pass
    if timed:
        for pre, fn in (("k3_", k3), ("k4_", k4)):
            names: set = set()
            res[pre + "kernel_ms"] = device_ms(fn, iters=10, names=names,
                                               per_call=1)
            res[pre + "event_ms"] = cuda_ms(fn, iters=10)
            res[pre + "kernels"] = sorted(names)
    elif dtype == "bfloat16":
        names = set()
        parts = (("k3_", "flash_bwd_dq_"), ("k4_", "flash_bwd_dkdv_"))
        for _ in range(5):
            device_ms(lambda: (k3(), k4()), iters=3, names=names)
            if all(any(part in n for n in names) for _, part in parts):
                break
        for pre, part in parts:
            res[pre + "kernels"] = sorted(n for n in names if part in n)
    dk = fa.kernel_head_dim(D)
    symbols = bwd_symbols(dtype, dk)
    if "k3_kernels" in res:
        def ran(pre, symbol, every):
            names = res[pre + "kernels"]
            return ran_only(names if every else
                            [n for n in names if "flash_" in n], symbol)

        if symbols == (WGMMA_DQ_SYMBOL, WGMMA_DKDV_SYMBOL):
            res["ran_wgmma_dq_only"] = ran("k3_", WGMMA_DQ_SYMBOL, timed)
            res["ran_wgmma_dkdv_only"] = ran("k4_", WGMMA_DKDV_SYMBOL, timed)
            ok = (ok and res["ran_wgmma_dq_only"]
                  and res["ran_wgmma_dkdv_only"])
        else:
            # the small-head (bf16) or FMA (f32) kernels, beside any pad's
            res["ran_expected_kernels_only"] = (
                ran("k3_", symbols[0], False)
                and ran("k4_", symbols[1], False))
            ok = ok and res["ran_expected_kernels_only"]
            # the cluster sizes the small-head kernels ran with
            if (symbols[0] == SMALL_DQ_SYMBOL
                    and res["ran_expected_kernels_only"]):
                res["cluster_sizes"] = fa.bwd_cluster_sizes(
                    B, S, S, H, KV, causal=causal, window=window)
    res["ptxas"] = {sym: _ptxas_of("flash_attention_bwd", sym, dk, dtype)
                    for sym in symbols}
    if timed:
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
        res.update(k3k4_bounds(B=B, S=S, H=H, KV=KV, D=D, dtype=dtype,
                               causal=causal, window=window))
    for c, n in zip(counters, before):
        setattr(fa, c, n)
    res["ok"] = ok
    return res


def phase_k3k4():
    """At the 1b train shape (B 8, S = T = 1024, H 16, KV 8, D 128,
    causal), debug-125m's heads (H = KV = 12, D 64), ragged S = T = 200,
    non-causal (S = 512) and window 256, each in bf16 and f32; then bf16
    timed at Phi-3-mini's (H = KV = 32, D 96), Gemma-2B's (H 8, KV 1, D
    256) and the tiny presets' heads (H 4, KV 2, D 16) at B 8 S 1024 (f32
    untimed at B 2), bf16 alone at the tiny heads with head dim 32 and at
    H2O-Danube-1.8B's (H 32, KV 8, D 80), and untimed at head dim 16 (G 3),
    48 (zero-padded to 64), 80 (non-causal), 96 (G 7, window 96) and 256,
    ragged S 200 (256 under the window); above 256, the wide kernels: head
    dim 512 (FLASH_WIDE, bf16 timed at B 2 S 1024, f32 untimed) and 320
    under window 128, untimed."""
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
                               window=256), True),
              ("phi3-mini", dict(B=8, S=1024, H=32, KV=32, D=96,
                                 causal=True, window=None), "bf16"),
              ("gemma-2b", dict(B=8, S=1024, H=8, KV=1, D=256, causal=True,
                                window=None), "bf16"),
              ("tiny", dict(B=8, S=1024, H=4, KV=2, D=16, causal=True,
                            window=None), "bf16"),
              ("d16-g3", dict(B=2, S=200, H=6, KV=2, D=16, causal=True,
                              window=None), False),
              ("d48", dict(B=2, S=200, H=8, KV=2, D=48, causal=True,
                           window=None), False),
              ("d80-full", dict(B=2, S=200, H=4, KV=4, D=80, causal=False,
                                window=None), False),
              ("d96-g7-w96", dict(B=2, S=256, H=7, KV=1, D=96, causal=True,
                                  window=96), False),
              ("d256-g8", dict(B=2, S=200, H=8, KV=1, D=256, causal=True,
                               window=None), False),
              ("d512", dict(FLASH_WIDE[0][1], causal=True, window=None),
               "bf16"),
              ("d320-w128", dict(FLASH_WIDE[1][1], causal=True,
                                 window=WIDE_WINDOW), False))
    for name, shape, timed in shapes:
        for dtype in ("bfloat16", "float32"):
            if timed == "bf16":
                # f32 checked untimed at B 2
                kw = dict(shape, B=2) if dtype == "float32" else shape
                r = k3k4_case(**kw, dtype=dtype, seed=22,
                              timed=dtype == "bfloat16")
            else:
                r = k3k4_case(**shape, dtype=dtype, seed=22, timed=timed)
            r["config"] = name
            cases.append(r)
    return cases + _small_head_bwd_cases()


# --- public model shapes outside the presets -------------------------------------


# Public models whose attention shapes LlamaConfig expresses and the presets
# do not have, with the fields of each model's config.json that LlamaConfig
# has (hidden_size, num_hidden_layers, num_attention_heads,
# num_key_value_heads, intermediate_size, vocab_size, rope_theta):
SHAPE_MODELS = {
    # microsoft/Phi-3-mini-4k-instruct: head dim 96, G 1
    "phi3-mini": dict(vocab_size=32064, d_model=3072, n_layers=32,
                      n_heads=32, n_kv_heads=32, d_ff=8192,
                      rope_theta=10000.0, max_seq_len=4096),
    # meta-llama/Llama-3.2-3B: head dim 128, G 3 (its rope scaling is not
    # LlamaConfig's)
    "llama3.2-3b": dict(vocab_size=128256, d_model=3072, n_layers=28,
                        n_heads=24, n_kv_heads=8, d_ff=8192,
                        rope_theta=500000.0, max_seq_len=4096),
    # google/gemma-2b's attention: head dim 256, G 8 (its GeGLU MLP, tied
    # embedding and embedding scale are not LlamaConfig's)
    "gemma-2b": dict(vocab_size=256000, d_model=2048, n_layers=18,
                     n_heads=8, n_kv_heads=1, d_ff=16384,
                     rope_theta=10000.0, max_seq_len=4096),
    # h2oai/h2o-danube-1.8b-base: head dim 80, G 4, and its sliding_window
    # (4096), which binds no key at these lengths but routes prefill
    # through K2 and the gradients through the windowed K3/K4
    "danube": dict(vocab_size=32000, d_model=2560, n_layers=24,
                   n_heads=32, n_kv_heads=8, d_ff=6912, rope_theta=10000.0,
                   max_seq_len=4096, sliding_window=4096),
    # deepseek-ai/DeepSeek-V4-Flash's attention: head dim 512 over one kv
    # head, at its hidden size 4096 (so 8 of its 64 query heads: LlamaConfig
    # ties d_model to heads x head dim), where the wide kernels run (its
    # learned sparse attention, q/o low-rank projections, MoE, mHC and
    # yarn rope are not LlamaConfig's; d_ff is its expert width); its
    # sliding window (128) is trained apart (``_shapes_wide_window``)
    "deepseek-v4-flash": dict(vocab_size=129280, d_model=4096, n_layers=43,
                              n_heads=8, n_kv_heads=1, d_ff=2048,
                              rope_theta=10000.0, max_seq_len=4096),
}
# served at full width, bf16: Phi-3-mini at 8 of its 32 layers, Danube and
# DeepSeek-V4-Flash at 2, the others at 4 (the script's time; their
# attention is the same at every layer)
SHAPE_SERVE_LAYERS = {"phi3-mini": 8, "llama3.2-3b": 4, "gemma-2b": 4,
                      "danube": 2, "deepseek-v4-flash": 2}
# served with the K5 path over their pools
SHAPE_K5 = ("phi3-mini", "deepseek-v4-flash")
SHAPE_PROMPT_LENS = (64, 192, 320, 512)
SHAPE_NEW_TOKENS = 32


def _kv_layout(cfg) -> str:
    """The engine's KV layout for `cfg`: paged, or contiguous for a model
    with a sliding window (which the paged engine refuses, as JAX's
    does)."""
    return "paged" if cfg.sliding_window is None else "contiguous"


# the counters of the kernels above head dim 256, by the kernels line's
# names: (module, counter)
WIDE_LAUNCHES = {"flash_attention_fwd_wide": ("fa", "launches_wide"),
                 "flash_attention_fwd_window_wide":
                     ("fa", "launches_wide_window"),
                 "flash_attention_bwd_dq_wide": ("fa", "launches_dq_wide"),
                 "flash_attention_bwd_dkdv_wide":
                     ("fa", "launches_dkdv_wide"),
                 "paged_decode_attention_inplace_wide":
                     ("pa", "launches_wide"),
                 "paged_attention_wide": ("pa", "launches_read_wide")}


def _wide_modules():
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    return {"fa": fa, "pa": pa}


def _all_kernel_launches():
    from ray_tpu_torch.ops import paged_attention as pa

    mods = _wide_modules()
    return {**_train_launches(),
            "paged_decode_attention_inplace": pa.launches,
            "paged_attention": pa.launches_read,
            **{n: getattr(mods[m], c) for n, (m, c) in WIDE_LAUNCHES.items()}}


def _set_all_kernel_launches(counts):
    from ray_tpu_torch.ops import paged_attention as pa

    _set_train_launches(counts)
    pa.launches = counts["paged_decode_attention_inplace"]
    pa.launches_read = counts["paged_attention"]
    mods = _wide_modules()
    for n, (m, c) in WIDE_LAUNCHES.items():
        setattr(mods[m], c, counts[n])


def _attention_grads_held(cfg, device, seed):
    """flash attention's forward and backward at `cfg`'s heads (B 1, S 128,
    causal, f32) against the plain versions, within kernel_tolerance and
    grad_tolerance. Comparison launches: the counters are put back."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    counts = _all_kernel_launches()
    rng = np.random.default_rng(seed)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, g = (torch.as_tensor(rng.standard_normal((1, 128, H, D)),
                            dtype=torch.float32, device=device)
            for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((1, 128, KV, D)),
                            dtype=torch.float32, device=device)
            for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
    ref, _ = fa.flash_attention_reference(q, k, v)
    plain = fa.flash_attention_bwd_reference(q, k, v, out, lse, g)
    _, over = held(out, ref, fa.kernel_tolerance(q, k, v, ref))
    worst = over
    for a, b, t in zip(grads, plain,
                       fa.grad_tolerance(q, k, v, out, lse, g, plain)):
        worst = max(worst, held(a, b, t)[1])
    _set_all_kernel_launches(counts)
    return worst


# loss_fn's gradients in bf16 compute (cfg.dtype bf16 over the same f32
# params) against the f32 run's on the card, each leaf's largest
# difference over its largest f32 element. bf16 keeps 8 significant bits
# (2^-9 relative rounding), and every activation, weight and attention
# operand on the ~20 operations between the loss and a weight is rounded
# to it, so a gradient element carries a few dozen such roundings: ~1e-2
# of its leaf's largest (1.8e-2 to 2.1e-2 at these three models' heads on
# an H100, where the TMA/wgmma K3/K4 run). A dropped tile, head or column
# of the attention's gradients moves a leaf by the order of the gradient
# itself
SHAPES_BF16_GRAD_RTOL = 6e-2


def _shapes_bf16_grads(cfg, params, batch, device, grads_f32):
    """loss_fn on `batch` in bf16 compute from the f32 `params` on
    `device`, its gradients against ``grads_f32`` (the same params' f32
    run, in leaf order) within SHAPES_BF16_GRAD_RTOL of each leaf's
    largest; on the card, the flash kernels by name: the forward's (K1 and
    the remat recompute) ``fwd_symbol`` only, the backward's
    ``bwd_symbols`` only, at the kernels' head dim for cfg's heads."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    on_card = device == "cuda"
    cfg16 = cfg.replace(dtype=torch.bfloat16)
    tokens = torch.as_tensor(batch, device=device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])

    def step():
        """(loss, the gradient leaves, the flash kernels' names), the step
        run under the profiler"""
        p = ts._map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
        with profile(activities=acts) as prof:
            loss = llama.loss_fn(p, {"tokens": tokens}, cfg16)
            loss.backward()
            if on_card:
                torch.cuda.synchronize()
        names = sorted({n for n, _ in kernel_events(prof) if "flash_" in n})
        return loss.detach(), [t.grad for t in ts._leaves(p)], names

    loss, got, names = step()
    # compared where the gradients are (the f32 run's moved there a leaf
    # at a time)
    res = {"loss": float(loss),
           "grad_max_rel_err": max(
               float((a.float() - b.to(a.device)).abs().max()
                     / b.abs().max())
               for a, b in zip(got, grads_f32)),
           "grad_rel_tol": SHAPES_BF16_GRAD_RTOL}
    del got
    res["ok"] = (res["grad_max_rel_err"] <= SHAPES_BF16_GRAD_RTOL
                 and bool(torch.isfinite(loss)))
    if on_card:
        from ray_tpu_torch.ops import flash_attention as fa

        # a trace CUPTI dropped the kernels from is taken again, up to 2
        # more times (those launches are the path's too)
        kinds = ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkdv_")
        for _ in range(2):
            if all(any(k in n for n in names) for k in kinds):
                break
            names = step()[2]
        dk = fa.kernel_head_dim(cfg.head_dim)
        res["kernels"] = names
        res["expects_kernels"] = [fwd_symbol("bfloat16", dk),
                                  *bwd_symbols("bfloat16", dk)]
        res["ran_expected_kernels_only"] = all(
            ran_only([n for n in names if k in n], sym)
            for k, sym in zip(kinds, res["expects_kernels"]))
        res["ok"] = res["ok"] and res["ran_expected_kernels_only"]
    return res


def _shapes_tiny_bf16(device):
    """The tiny Llama preset (head dim 16: the small-head forward, its
    remat recompute and the small-head backward), flash, B 2 S 128, from
    one seeded init on `device`: loss_fn's gradients in bf16 compute
    against its f32 ones (``_shapes_bf16_grads``)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32,
                                        attn_impl="flash")
    params = llama.init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    batch = np.random.default_rng(16).integers(0, cfg.vocab_size,
                                               size=(2, 129))
    p = ts._map(lambda t: t.detach().clone().requires_grad_(True), params)
    llama.loss_fn(p, {"tokens": torch.as_tensor(batch, device=device)},
                  cfg).backward()
    grads_f32 = [t.grad.float() for t in ts._leaves(p)]
    return _shapes_bf16_grads(cfg, params, batch, device, grads_f32)


def _shapes_wide_window(cfg, device):
    """DeepSeek-V4-Flash's attention (`cfg`, head dim 512) under its
    sliding window (WIDE_WINDOW, 128) cut to 2 layers, flash, B 1 S 384 (so
    the window binds), from one seeded init on `device`: loss_fn's
    gradients in f32, then in bf16 compute against them
    (``_shapes_bf16_grads``: on the card the wide K2 and K3/K4 by name)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    cfg = cfg.replace(n_layers=2, dtype=torch.float32, attn_impl="flash",
                      sliding_window=WIDE_WINDOW, max_seq_len=512)
    params = llama.init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    batch = np.random.default_rng(17).integers(0, cfg.vocab_size,
                                               size=(1, 385))
    p = ts._map(lambda t: t.detach().clone().requires_grad_(True), params)
    llama.loss_fn(p, {"tokens": torch.as_tensor(batch, device=device)},
                  cfg).backward()
    grads_f32 = [t.grad.float() for t in ts._leaves(p)]
    del p
    return _shapes_bf16_grads(cfg, params, batch, device, grads_f32)


def _shapes_card_vs_cpu(cfg, device):
    """`cfg` cut to 2 layers, f32 (no TF32), flash, from one seeded init on
    `device` and on the CPU: prefill logits of 2 prompts (bucket 256)
    within LOGITS_TOL, the engine's greedy tokens (8 each; ``_kv_layout``)
    equal, loss_fn at B 1 S 128 within TRAIN_LOSS_RTOL and every gradient
    within MOE_GRAD_RTOL of its leaf's largest; and the attention at these
    heads against the plain versions (``_attention_grads_held``); then
    loss_fn in bf16 compute on `device` from the same params
    (``_shapes_bf16_grads``)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = cfg.replace(n_layers=2, dtype=torch.float32, attn_impl="flash",
                      max_seq_len=512)
    params = {device: llama.init_params(
        torch.Generator(device=device).manual_seed(0), cfg)}
    params["cpu"] = _cpu_copy(params[device])
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (130, 200)]
    toks = np.zeros((2, 256), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, :len(pr)] = pr
    lens = np.array([len(pr) for pr in prompts], np.int32)
    batch = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                               size=(1, 129))
    out = {}
    for dev in (device, "cpu"):
        lg, _, _ = llama.prefill(params[dev], torch.as_tensor(toks,
                                                             device=dev),
                                 torch.as_tensor(lens, device=dev), cfg)
        eng = LLMEngine(cfg=cfg, params=params[dev], max_slots=4,
                        kv_layout=_kv_layout(cfg), page_size=64, device=dev)
        reqs = [eng.submit(pr, max_new_tokens=8) for pr in prompts]
        while eng.has_work():
            eng.step_n(8)
        del eng
        p = ts._map(lambda t: t.detach().clone().requires_grad_(True),
                    params[dev])
        loss = llama.loss_fn(p, {"tokens": torch.as_tensor(batch,
                                                           device=dev)},
                             cfg)
        loss.backward()
        out[dev] = (lg.float().cpu(), [r.generated for r in reqs],
                    float(loss.detach()),
                    [t.grad.float().cpu() for t in ts._leaves(p)])
        del p
    (lc, tc, loss_c, gc), (lh, th, loss_h, gh) = out[device], out["cpu"]
    r = {"logits_max_abs_err": float((lc - lh).abs().max()),
         "logits_tol": LOGITS_TOL, "tokens_card": tc, "tokens_cpu": th,
         "tokens_identical": tc == th, "loss_card": loss_c,
         "loss_cpu": loss_h, "loss_rel_err": abs(loss_c - loss_h) /
         abs(loss_h), "loss_rel_tol": TRAIN_LOSS_RTOL,
         "grad_max_rel_err": max(float((a - b).abs().max() / b.abs().max())
                                 for a, b in zip(gc, gh)),
         "grad_rel_tol": MOE_GRAD_RTOL,
         "attention_max_err_over_tol": _attention_grads_held(cfg, device,
                                                             13),
         "bf16": _shapes_bf16_grads(cfg, params[device], batch, device, gc)}
    r["ok"] = (r["tokens_identical"] and r["logits_max_abs_err"] <= LOGITS_TOL
               and r["loss_rel_err"] <= TRAIN_LOSS_RTOL
               and r["grad_max_rel_err"] <= MOE_GRAD_RTOL
               and r["attention_max_err_over_tol"] <= 1.0
               and r["bf16"]["ok"] and all(len(t) == 8 for t in tc))
    return r


def _shapes_serve(cfg, layers, device, k5=False):
    """The engine at `cfg`'s full width (and `layers`, or all), bf16 on
    the card, flash prefill, paged (page 64) or, for a windowed model,
    contiguous (``_kv_layout``), 4 slots: after a warm-up, the
    SHAPE_PROMPT_LENS prompts greedily, SHAPE_NEW_TOKENS each, submitted at
    once; TTFT, decode tokens/s, peak memory. Paged on the card: then,
    with those slots live again, two decode steps traced, whose split
    kernels must all be ``paged_symbol``'s (bf16: the ring kernel, the
    any-shape one above head dim 256), and (k5) the K5 path over the
    engine's pools (``k5_path``)."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.llm import LLMEngine

    on_card = device == "cuda"
    cfg = cfg.replace(attn_impl="flash")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if not on_card:
        cfg = cfg.replace(dtype=torch.float32)
    else:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    layout = _kv_layout(cfg)
    eng = LLMEngine(cfg=cfg, max_slots=4, max_seq_len=1024,
                    kv_layout=layout, page_size=64, seed=0, device=device)
    rng = np.random.default_rng(14)
    V = cfg.vocab_size
    eng.generate(rng.integers(0, V, size=64).tolist(), max_new_tokens=2)
    setup_s = time.perf_counter() - t0
    prompts = [rng.integers(0, V, size=n).tolist() for n in SHAPE_PROMPT_LENS]
    m0 = dict(eng.metrics)
    t1 = time.perf_counter()
    reqs = [eng.submit(pr, max_new_tokens=SHAPE_NEW_TOKENS)
            for pr in prompts]
    while eng.has_work():
        eng.step_n(8)
    if on_card:
        torch.cuda.synchronize()
    m = engine_metrics(eng, reqs, m0, time.perf_counter() - t1)
    del m["all_finished_64"]
    res = {"cfg": f"{cfg.d_model} wide, {cfg.n_layers} layers, H "
                  f"{cfg.n_heads}, KV {cfg.n_kv_heads}, head dim "
                  f"{cfg.head_dim}, {str(cfg.dtype)[6:]}, {layout}"
                  f"{' page 64' if layout == 'paged' else ''}, 4 slots, "
                  f"flash prefill",
           "setup_s": setup_s, **m,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if on_card else None),
           "tokens": [r.generated for r in reqs]}
    res["ok"] = all(len(r.generated) == SHAPE_NEW_TOKENS and r.error is None
                    and all(0 <= t < V for t in r.generated) for r in reqs)
    if on_card and layout == "paged":
        # the prompts again, live: decode steps traced for the paged
        # kernels' names (bf16: the ring kernel only), then (k5) the K5
        # path over the pools
        for pr in prompts:
            eng.submit(pr, max_new_tokens=64)
        eng.step_n(8)
        names = set()
        device_ms(lambda: eng.step_n(2), iters=1, names=names)
        res["decode_paged_kernels"] = sorted(n for n in names
                                             if "paged_decode" in n)
        res["decode_expects_kernel"] = paged_symbol(
            "bfloat16", cfg.head_dim, cfg.n_heads // cfg.n_kv_heads)
        res["decode_ran_expected_only"] = ran_paged_only(
            names, res["decode_expects_kernel"])
        res["ok"] = res["ok"] and res["decode_ran_expected_only"]
        if k5:
            res["k5_path"] = k5_path(eng)
            res["ok"] = res["ok"] and res["k5_path"]["ok"]
    return res


def _shapes_train(device):
    """The tiny preset and MoE's tiny (head dim 16), flash, f32, B 2 S 128
    (the flash route): 3 AdamW steps on `device` (K1, K3, K4) and on the
    CPU from one seeded init, within the train_card_vs_cpu bounds."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.parallel import train_step as ts

    res = {}
    for name, mod in (("tiny", llama), ("moe-tiny", moe)):
        cfg = mod.PRESETS["tiny"].replace(dtype=torch.float32,
                                          attn_impl="flash")
        params0 = mod.init_params(torch.Generator().manual_seed(0), cfg)
        tokens = np.random.default_rng(15).integers(
            0, cfg.vocab_size, size=(2, 129)).astype(np.int64)
        out = {}
        for dev in (device, "cpu"):
            init, _ = ts.make_train_state_init(
                lambda g: ts._map(lambda t: t.clone(), params0),
                ts.adamw(3e-4, weight_decay=0.01), device=dev)
            state = init(0)
            step = ts.make_train_step(
                lambda p, b, c=cfg, m=mod: m.loss_fn(p, b, c))
            batch = {"tokens": torch.as_tensor(tokens, device=dev)}
            ms = []
            for _ in range(3):
                state, mt = step(state, batch)
                ms.append((float(mt["loss"]), float(mt["grad_norm"])))
            out[dev] = (ms, ts._leaves(state.params))
        out = {"cuda": out[device], "cpu": out["cpu"]}
        res[name] = _card_vs_cpu_steps(out)
    return res


def phase_shapes(device="cuda", models=None, serve_layers=None):
    """The attention kernels at public model shapes outside the presets
    (SHAPE_MODELS): Phi-3-mini (head dim 96), Llama-3.2-3B (G 3),
    Gemma-2B's attention (head dim 256, G 8), H2O-Danube-1.8B (head dim
    80, G 4, sliding window) and DeepSeek-V4-Flash's attention (head dim
    512, G 8: the wide kernels). (a) each at full width cut to 2 layers,
    f32, card vs CPU (``_shapes_card_vs_cpu``); (b) each served at full
    width in bf16 (``_shapes_serve``): Phi-3-mini at 8 of its 32 layers,
    Danube and DeepSeek-V4-Flash at 2, the others at 4, Phi-3-mini and
    DeepSeek-V4-Flash with the K5 path over their pools (SHAPE_K5);
    (c) the tiny presets' training with flash (head dim 16;
    ``_shapes_train``); (d) the tiny Llama preset's bf16 gradients against
    its f32 ones, through the small-head kernels (``_shapes_tiny_bf16``);
    (e) DeepSeek-V4-Flash's sliding window, the wide K2
    (``_shapes_wide_window``).
    The launch counters are set to 0 just before and read just after;
    the attention comparisons of (a) are not counted."""
    import torch

    on_card = device == "cuda"
    models = models or SHAPE_MODELS
    serve_layers = serve_layers or SHAPE_SERVE_LAYERS
    from ray_tpu_torch.models import llama

    _set_all_kernel_launches({k: 0 for k in _all_kernel_launches()})
    res = {"card_vs_cpu": {}, "serve": {}, "seconds": {}}
    ok = True
    for name, kw in models.items():
        t0 = time.perf_counter()
        r = _shapes_card_vs_cpu(llama.LlamaConfig(**kw), device)
        res["card_vs_cpu"][name] = r
        res["seconds"][f"card_vs_cpu/{name}"] = time.perf_counter() - t0
        ok = ok and r["ok"]
        if on_card:
            torch.cuda.empty_cache()
    k5 = {"paged_attention": 0, "paged_attention_wide": 0}
    for name, kw in models.items():
        t0 = time.perf_counter()
        r = _shapes_serve(llama.LlamaConfig(**kw), serve_layers[name],
                          device, k5=name in SHAPE_K5)
        for n in k5:
            k5[n] += r.get("k5_path", {}).get("launches", {}).get(n, 0)
        res["serve"][name] = r
        res["seconds"][f"serve/{name}"] = time.perf_counter() - t0
        ok = ok and r["ok"]
        if on_card:
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["train"] = _shapes_train(device)
    res["seconds"]["train"] = time.perf_counter() - t0
    ok = ok and all(r["ok"] for r in res["train"].values())
    t0 = time.perf_counter()
    res["tiny_bf16"] = _shapes_tiny_bf16(device)
    res["seconds"]["tiny_bf16"] = time.perf_counter() - t0
    ok = ok and res["tiny_bf16"]["ok"]
    if "deepseek-v4-flash" in models:
        t0 = time.perf_counter()
        res["wide_window"] = _shapes_wide_window(
            llama.LlamaConfig(**models["deepseek-v4-flash"]), device)
        res["seconds"]["wide_window"] = time.perf_counter() - t0
        ok = ok and res["wide_window"]["ok"]
    launches = _all_kernel_launches()
    launches.update(k5)
    res["launches"] = launches
    if on_card:
        # every kernel ran (K2 in Danube's prefills; the wide ones in
        # DeepSeek-V4-Flash's runs)
        ok = ok and all(n > 0 for n in launches.values())
    res["ok"] = ok
    return res


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


def _card_vs_cpu_steps(out):
    """Training steps on the card against the CPU: `out` maps "cuda" and
    "cpu" to ([(loss, grad norm) per step], the params' leaves after the
    last step); the train_card_vs_cpu bounds decide "ok"."""
    import numpy as np

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
    return r


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
        r = _card_vs_cpu_steps(out)
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


# --- sequence and pipeline parallel, MoE, ViT ----------------------------------


def _route_loss(route: str, cfg, mesh, rules, M: int):
    """(loss(params, batch), logits(params, inputs)) through one route:
    "forward" (llama.forward), "ring"/"ulysses" (forward_sp) or
    "gpipe"/"1f1b" (forward_pp with M microbatches, flash). On a mesh the
    logits come back as a DTensor of one rank, whose local tensor is the
    whole; the loss is the mean next-token nll of them."""
    from ray_tpu_torch import is_dtensor
    from ray_tpu_torch.models import llama

    if route == "forward":
        def logits(p, x):
            return llama.forward(p, x, cfg, mesh=mesh, rules=rules)
    elif route in ("ring", "ulysses"):
        c = cfg.replace(attn_impl=route)

        def logits(p, x):
            return llama.forward_sp(p, x, c, mesh, rules=rules)
    else:
        c = cfg.replace(attn_impl="flash", pp_schedule=route)

        def logits(p, x):
            return llama.forward_pp(p, x, c, mesh, num_microbatches=M,
                                    rules=rules)

    def local(x):
        return x.to_local() if is_dtensor(x) else x

    def loss(p, b):
        return llama._nll(local(logits(p, b["inputs"])),
                          local(b["targets"])).mean()

    return loss, lambda p, x: local(logits(p, x))


SP_PP_ROUTES = ("ring", "ulysses", "gpipe", "1f1b")


def _sp_pp_card_vs_cpu(cfg, B: int, S: int, device: str):
    """The four routes (and forward) at `cfg` in f32 with no mesh (one
    rank, one stage), from one init, on the card and on the CPU: each
    route's loss and grad norm card vs CPU, and each route's logits
    against forward's on the card."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(B, S + 1)))
    out = {}
    for dev in (device, "cpu"):
        batch = {"inputs": tokens[:, :-1].to(dev),
                 "targets": tokens[:, 1:].to(dev)}
        for route in ("forward",) + SP_PP_ROUTES:
            p = ts._map(lambda t: t.to(dev, copy=True).requires_grad_(True),
                        params)
            loss_f, logits_f = _route_loss(route, cfg, None, None, 2)
            with torch.no_grad():
                lg = logits_f(p, batch["inputs"]).float().cpu()
            loss = loss_f(p, batch)
            loss.backward()
            gn = float(ts.optax_global_norm([t.grad for t in
                                             ts._leaves(p)]))
            out[(dev, route)] = (float(loss.detach()), gn, lg)
    runs = {}
    ok = True
    for route in SP_PP_ROUTES:
        (lc, gc, xc), (lh, gh, _) = out[(device, route)], out[("cpu", route)]
        fwd = out[(device, "forward")][2]
        r = {"loss_card": lc, "loss_cpu": lh,
             "loss_rel_err": abs(lc - lh) / abs(lh),
             "grad_norm_rel_err": abs(gc - gh) / abs(gh),
             "logits_vs_forward_max_abs_err": float((xc - fwd).abs().max())}
        r["ok"] = (r["loss_rel_err"] <= TRAIN_LOSS_RTOL
                   and r["grad_norm_rel_err"] <= TRAIN_LOSS_RTOL
                   and r["logits_vs_forward_max_abs_err"] <= LOGITS_TOL)
        runs[route] = r
        ok = ok and r["ok"]
    return {"cfg": f"{cfg.d_model} wide, {cfg.n_layers} layers, f32, no "
                   f"mesh, B {B} S {S}", "loss_rel_tol": TRAIN_LOSS_RTOL,
            "logits_tol": LOGITS_TOL, "routes": runs, "ok": ok}


def phase_sp_pp(device="cuda", preset="1b", batch=(4, 1024),
                check=("1b", 2, 2, 128), layers=SP_PP_LAYERS):
    """Sequence and pipeline parallelism through their entry points on a
    1-rank mesh (``local_mesh``; NCCL on the card): the `preset` at full
    width and `layers` of its depth (None: all), bf16 compute over f32
    masters, remat, B 4 S 1024,
    ``ShardingRules.full()``; per route a fresh seeded init (the same
    weights), the loss of forward (flash) on the batch, then two AdamW
    steps (adamw(3e-4, weight_decay=0.01)) through ``make_train_step``
    with the route's loss: ``forward_sp`` (ring, then Ulysses) and
    ``forward_pp`` (gpipe, then 1f1b, M 2, flash). The first step's loss is
    held against forward's within SP_PP_LOSS_RTOL; the second is timed.
    The launch counters are zeroed before the four routes and read after:
    the pipeline's K1 runs 2 M L times a gpipe step (the forward and remat's
    recompute) and 3 M L a 1f1b step (its backward recomputes the stage
    first), K3/K4 M L each; ring and Ulysses launch none. Then `check`
    (preset, layers, B, S): the four routes in f32 without a mesh, card
    against CPU (``_sp_pp_card_vs_cpu``). One rank: no collective runs.
    The same two steps through ``forward`` (loss_fn's route on one rank)
    come first, as the baseline of the routes' times; its launches, and
    those of each route's profiled step, are not counted."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshSpec, local_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules

    on_card = device == "cuda"
    B, S = batch
    M = 2
    cfg = llama.PRESETS[preset].replace(attn_impl="flash", remat=True,
                                        f32_logits=False)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    mesh = local_mesh(MeshSpec(fsdp=-1), device=device)
    rules = ShardingRules.full()
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device=device)
    batch_ = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    print("sp_pp: no collective ran: one rank", flush=True)
    res = {"cfg": f"{preset}, {cfg.n_layers} layers, bf16 compute, f32 "
                  f"master weights, remat, B {B} S {S}, full() on a 1-rank "
                  f"mesh, adamw(3e-4, weight_decay=0.01), 2 steps a route",
           "mesh": str(mesh), "collectives": "no collective ran: one rank",
           "loss_rel_tol": SP_PP_LOSS_RTOL, "routes": {}}
    ok = True
    _reset_train_launches()
    for route in ("forward",) + SP_PP_ROUTES:
        before = _train_launches()
        init, state_sh = ts.make_train_state_init(
            functools.partial(llama.init_params, cfg=cfg),
            ts.adamw(3e-4, weight_decay=0.01), mesh, rules,
            llama.param_specs(cfg), device=device)
        state = init(0)
        base_loss, _ = _route_loss("forward", cfg, mesh, rules, M)
        loss_f, _ = _route_loss(route, cfg, mesh, rules, M)
        step = ts.make_train_step(loss_f, mesh=mesh, rules=rules,
                                  state_shardings=state_sh)
        fwd_launches = _train_launches()
        with torch.no_grad():
            want = float(base_loss(state.params, ts._place_batch(
                batch_, ts.batch_sharding(mesh, rules, batch_))))
        _set_train_launches(fwd_launches)     # forward's are not the path's
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batch_)
        first = float(m["loss"])
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch_)
        second = float(m["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        r = {"forward_loss": want, "loss_step1": first, "loss_step2": second,
             "loss_rel_diff": abs(first - want) / abs(want),
             "step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
             "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                             if on_card else None)}
        r["ok"] = (bool(np.isfinite([first, second]).all())
                   and r["loss_rel_diff"] <= SP_PP_LOSS_RTOL)
        if route == "forward":
            # the baseline's launches are not the path's
            _set_train_launches(before)
        if on_card:
            counted = _train_launches()
            r["profile_step"] = device_profile(
                lambda: step(state, batch_), lambda: step(state, batch_))
            _set_train_launches(counted)
        res["routes"][route] = r
        ok = ok and r["ok"]
        del state, step
        if on_card:
            torch.cuda.empty_cache()
    L = cfg.n_layers
    launches = _train_launches()
    expect = {"flash_attention_fwd": 2 * (2 * M * L + 3 * M * L),
              "flash_attention_fwd_window": 0,
              "flash_attention_bwd_dq": 2 * 2 * M * L,
              "flash_attention_bwd_dkdv": 2 * 2 * M * L}
    res.update(launches=launches, launches_expected=expect)
    if check is not None:
        cp, layers, cb, cs = check
        ccfg = llama.PRESETS[cp].replace(n_layers=layers,
                                         dtype=torch.float32,
                                         attn_impl="flash", remat=True)
        res["card_vs_cpu"] = _sp_pp_card_vs_cpu(ccfg, cb, cs, device)
        ok = ok and res["card_vs_cpu"]["ok"]
    res["ok"] = ok and launches == expect
    return res


def _set_train_launches(counts):
    from ray_tpu_torch.ops import flash_attention as fa

    (fa.launches, fa.launches_window, fa.launches_dq,
     fa.launches_dkdv) = (counts["flash_attention_fwd"],
                          counts["flash_attention_fwd_window"],
                          counts["flash_attention_bwd_dq"],
                          counts["flash_attention_bwd_dkdv"])


def _moe_routes(run):
    """run() with every layer's top-k expert indices recorded (the MoE
    FFN's input routed again beside it): (run's result, [idx per layer])."""
    from ray_tpu_torch.models import moe

    seen = []
    real = moe._moe_ffn

    def record(x, lp, cfg):
        seen.append(moe._route(x.reshape(-1, x.shape[-1]), lp["router"],
                               cfg)[2].cpu())
        return real(x, lp, cfg)

    moe._moe_ffn = record
    try:
        return run(), seen
    finally:
        moe._moe_ffn = real


def _moe_card_vs_cpu(cfg, B: int, S: int, device: str):
    """`cfg` in f32 from one init on the card and on the CPU: the routing
    of every layer (equal, asserted before anything else is compared),
    then the loss and every gradient."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import train_step as ts

    params = moe.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, size=(B, S + 1)))
    out = {}
    for dev in (device, "cpu"):
        p = ts._map(lambda t: t.to(dev, copy=True).requires_grad_(True),
                    params)

        def run():
            loss = moe.loss_fn(p, {"tokens": tokens.to(dev)}, cfg)
            loss.backward()
            return float(loss.detach())

        loss, routes = _moe_routes(run)
        out[dev] = (loss, routes, ts._map(lambda t: t.grad.float().cpu(),
                                          p))
    (lc, rc, gc), (lh, rh, gh) = out[device], out["cpu"]
    same = len(rc) == len(rh) == cfg.n_layers and all(
        torch.equal(a, b) for a, b in zip(rc, rh))
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(ts._leaves(gc), ts._leaves(gh)))
    r = {"cfg": f"{cfg.d_model} wide, {cfg.n_experts} experts, "
                f"{cfg.n_layers} layers, f32, B {B} S {S}",
         "routing_equal": same, "loss_card": lc, "loss_cpu": lh,
         "loss_rel_err": abs(lc - lh) / abs(lh),
         "grad_max_rel_err": grad_err, "loss_rel_tol": TRAIN_LOSS_RTOL,
         "grad_rel_tol": MOE_GRAD_RTOL}
    r["ok"] = (same and r["loss_rel_err"] <= TRAIN_LOSS_RTOL
               and grad_err <= MOE_GRAD_RTOL)
    return r


def phase_moe(device="cuda", preset="8x1b", batch=(4, 1024),
              train_layers=4, check=(2, 1, 128)):
    """The MoE model at `preset` (8x1b: d_model 2048, 16 layers, H 16, KV 8,
    d_ff 5632, 8 experts, top-2, capacity 1.5; ~4.8 B params), flash, bf16
    compute over f32 params. First `check` (layers, B, S): the full width
    cut to 2 layers in f32, card vs CPU (``_moe_card_vs_cpu``). Then, with
    the launch counters zeroed: (a) ``loss_fn`` at all layers, B 4 S 1024,
    a warm-up and 3 timed runs without gradients (K1 16 a run); (b) the
    full width cut to `train_layers` layers (f32 masters + AdamW at ~16 B
    a param: 16 layers would take ~77 GB before activations), adamw(3e-4,
    weight_decay=0.01), a warm-up and 5 steps on one seeded batch: the
    loss finite and falling (K1, K3, K4 once a layer a step: the model
    has no remat, as in the reference)."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import train_step as ts

    on_card = device == "cuda"
    B, S = batch
    cfg = moe.PRESETS[preset].replace(attn_impl="flash")
    res = {"cfg": f"{preset} ({moe.num_params(cfg) / 1e9:.3f} B params), "
                  f"flash, bf16 compute, f32 params, B {B} S {S}",
           "n_params": moe.num_params(cfg),
           "capacity": moe.capacity(cfg, B * S),
           "dispatch_shape": [B * S * cfg.top_k, cfg.n_experts,
                              moe.capacity(cfg, B * S)]}
    ok = True
    if check is not None:
        layers, cb, cs = check
        res["card_vs_cpu"] = _moe_card_vs_cpu(
            cfg.replace(n_layers=layers, dtype=torch.float32), cb, cs,
            device)
        ok = res["card_vs_cpu"]["ok"]

    tokens = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device=device)
    batch_ = {"tokens": tokens}
    _reset_train_launches()
    # (a) the forward and loss at all layers
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
    with torch.no_grad():
        warm = float(moe.loss_fn(params, batch_, cfg))
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd_losses = [float(moe.loss_fn(params, batch_, cfg))
                      for _ in range(3)]
        fwd_ms = (time.perf_counter() - t0) * 1e3 / 3
    res["forward"] = {
        "layers": cfg.n_layers, "setup_s": setup_s, "warmup_loss": warm,
        "losses": fwd_losses, "ms": fwd_ms,
        "tokens_per_s": B * S / fwd_ms * 1e3,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}
    ok = ok and bool(np.isfinite([warm] + fwd_losses).all())
    del params
    if on_card:
        torch.cuda.empty_cache()

    # (b) training at train_layers layers
    tcfg = cfg.replace(n_layers=train_layers)
    init, _ = ts.make_train_state_init(
        functools.partial(moe.init_params, cfg=tcfg),
        ts.adamw(3e-4, weight_decay=0.01), device=device)
    state = init(0)
    step = ts.make_train_step(lambda p, b: moe.loss_fn(p, b, tcfg))
    state, m = step(state, batch_)              # warm-up
    warm = float(m["loss"])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        state, m = step(state, batch_)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    launches = _train_launches()
    L = train_layers
    expect = {"flash_attention_fwd": 4 * cfg.n_layers + 6 * L,
              "flash_attention_fwd_window": 0,
              "flash_attention_bwd_dq": 6 * L,
              "flash_attention_bwd_dkdv": 6 * L}
    res["train"] = {
        "layers": L, "n_params": moe.num_params(tcfg), "warmup_loss": warm,
        "losses": losses, "step_ms": step_ms,
        "tokens_per_s": B * S / step_ms * 1e3,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}
    res.update(launches=launches, launches_expected=expect)
    ok = (ok and bool(np.isfinite([warm] + losses).all())
          and losses[-1] < warm and launches == expect)
    if on_card:
        res["train"]["profile_step"] = device_profile(
            lambda: step(state, batch_), lambda: step(state, batch_))
    res["ok"] = ok
    return res


def phase_vit(device="cuda", preset="base", batch=64, steps=5,
              check=(2, 2)):
    """ViT at `preset` (base: ViT-B/16, 224 x 224 x 3 images, patch 16,
    d_model 768, 12 layers, 1000 classes; ~86 M params), bf16 compute over
    f32 params, remat, adamw(3e-4, weight_decay=0.01): a warm-up and
    `steps` steps on one batch of seeded images and labels, the loss
    finite and falling; images/s, peak memory and a step's device
    profile. Then `check` (layers, B): the full width cut to 2 layers in
    f32, card vs CPU, the loss and grad norm within TRAIN_LOSS_RTOL. No
    kernel of ours runs (the reference's ViT reaches no Pallas kernel)."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel import train_step as ts

    on_card = device == "cuda"
    cfg = vit.PRESETS[preset]
    rng = np.random.default_rng(12)

    def make_batch(n, c):
        return {"images": torch.as_tensor(rng.standard_normal(
            (n, c.image_size, c.image_size, c.channels)).astype(np.float32)),
            "labels": torch.as_tensor(rng.integers(0, c.num_classes, n))}

    b = {k: v.to(device) for k, v in make_batch(batch, cfg).items()}
    init, _ = ts.make_train_state_init(
        functools.partial(vit.init_params, cfg=cfg),
        ts.adamw(3e-4, weight_decay=0.01), device=device)
    state = init(0)
    step = ts.make_train_step(lambda p, bb: vit.loss_fn(p, bb, cfg))
    state, m = step(state, b)                   # warm-up
    warm = float(m["loss"])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    res = {"cfg": f"vit {preset} ({vit.num_params(cfg) / 1e6:.1f} M params)"
                  f", bf16 compute, f32 params, remat, B {batch}, "
                  f"adamw(3e-4, weight_decay=0.01)",
           "n_params": vit.num_params(cfg), "warmup_loss": warm,
           "losses": losses, "step_ms": step_ms,
           "images_per_s": batch / step_ms * 1e3,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if on_card else None)}
    ok = bool(np.isfinite([warm] + losses).all()) and losses[-1] < warm
    if on_card:
        res["profile_step"] = device_profile(lambda: step(state, b),
                                             lambda: step(state, b))
    del state, step
    if check is not None:
        layers, cb = check
        ccfg = cfg.replace(n_layers=layers, dtype=torch.float32)
        params = vit.init_params(torch.Generator().manual_seed(0), ccfg)
        cbatch = make_batch(cb, ccfg)
        out = {}
        for dev in (device, "cpu"):
            p = ts._map(lambda t: t.to(dev, copy=True).requires_grad_(True),
                        params)
            loss = vit.loss_fn(p, {k: v.to(dev) for k, v in cbatch.items()},
                               ccfg)
            loss.backward()
            out[dev] = (float(loss.detach()), float(ts.optax_global_norm(
                [t.grad for t in ts._leaves(p)])))
        (lc, gc), (lh, gh) = out[device], out["cpu"]
        res["card_vs_cpu"] = {
            "cfg": f"{ccfg.d_model} wide, {layers} layers, f32, B {cb}",
            "loss_card": lc, "loss_cpu": lh,
            "loss_rel_err": abs(lc - lh) / abs(lh),
            "grad_norm_rel_err": abs(gc - gh) / abs(gh),
            "tol": TRAIN_LOSS_RTOL}
        ok = (ok and res["card_vs_cpu"]["loss_rel_err"] <= TRAIN_LOSS_RTOL
              and res["card_vs_cpu"]["grad_norm_rel_err"] <= TRAIN_LOSS_RTOL)
    res["ok"] = ok
    return res


# --- the train layer ------------------------------------------------------------

# the trainer phase's GPT-2 run: TRAINER_STEPS steps on one batch, a
# checkpoint (session.report with state=) every TRAINER_EVERY, and on the
# first attempt a death (os._exit) right after the TRAINER_DIE_AFTER one
TRAINER_STEPS, TRAINER_EVERY, TRAINER_DIE_AFTER = 20, 10, 10
# its Llama run: the train phase's recipe cut to this many layers and steps
TRAINER_LLAMA_LAYERS, TRAINER_LLAMA_STEPS = 4, 3


def _params_digest(params) -> str:
    """sha256 of a param tree's leaves (in ``_leaves`` order) as the bytes
    of their f32 host copies: the worker's last saved params and the
    checkpoint the driver loads are compared through it."""
    import hashlib

    import torch

    from ray_tpu_torch.parallel import train_step as ts

    h = hashlib.sha256()
    for t in ts._leaves(params):
        h.update(t.detach().to("cpu", torch.float32).contiguous()
                 .numpy().tobytes())
    return h.hexdigest()


def _trainer_gpt2_loop(config):
    """The GPT-2 loop of the trainer phase, run in a train worker: the
    `preset` (bf16 compute, f32 params, remat as the preset has it) from
    seed 0 on the worker's device (CUDA unless `device` is "cpu"), the
    port's make_train_step with adamw(3e-4, weight_decay=0.01) on one
    batch of seeded tokens [B, S + 1]; every step reported, every
    `every`-th with its state (a DCP checkpoint). Deterministic
    algorithms (the embedding gather's backward sorts where it would add
    with atomics), so a resumed attempt can equal an uninterrupted one bit
    for bit. On a first attempt (no checkpoint) it dies at `die_after`,
    right after that step's checkpoint. The last report carries the DCP
    save and restore seconds and bytes, the peak memory and the flash
    kernels' launch counts of this process."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import session

    torch.use_deterministic_algorithms(True)
    dev = session.get_device(config.get("device"))
    cuda = dev.type == "cuda"
    cfg = gpt2.PRESETS[config["preset"]]
    init, _ = ts.make_train_state_init(
        lambda g: gpt2.init_params(g, cfg),
        ts.adamw(3e-4, weight_decay=0.01), device=dev)
    state = init(0)
    ck = session.get_checkpoint()
    restore_s = None
    if ck is not None:
        t0 = time.perf_counter()
        state = ts.load_state_dict(state, ck.load_state())
        if cuda:
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    B, S = config["batch"]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(
        config["seed"]).integers(0, cfg.vocab_size, size=(B, S + 1)),
        device=dev)}
    step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg))
    _reset_train_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    saves, nbytes = [], 0
    for _ in range(state.step, config["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])               # waits for the step
        metrics = {"step": state.step, "loss": loss,
                   "grad_norm": float(m["grad_norm"]),
                   "step_s": time.perf_counter() - t0,
                   "resumed": ck is not None, "pid": os.getpid()}
        if state.step % config["every"]:
            session.report(metrics)
            continue
        if state.step == config["steps"]:
            metrics["params_sha256"] = _params_digest(state.params)
        tree = ts.state_dict(state)
        nbytes = sum(t.numel() * t.element_size()
                     for t in pytree.tree_leaves(tree)
                     if isinstance(t, torch.Tensor))
        t0 = time.perf_counter()
        session.report(metrics, state=tree)
        saves.append(time.perf_counter() - t0)
        if ck is None and state.step == config.get("die_after"):
            os._exit(1)
    session.report({
        "final": True, "pid": os.getpid(), "dcp_save_s": saves,
        "dcp_restore_s": restore_s, "dcp_bytes": nbytes,
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                           else None),
        "card_mem_bytes": (torch.cuda.get_device_properties(dev)
                           .total_memory if cuda else None),
        "launches": _train_launches()})


def _trainer_llama_run(device, preset, layers, batch, steps):
    """The train phase's Llama recipe (flash, remat, f32_logits False,
    adamw(3e-4, weight_decay=0.01), seed 0, tokens from seed 7) cut to
    `layers` and `steps`: its losses, and the flash kernels' launches in
    this process over those steps."""
    losses, launches, _ = _llama_train(device, preset, layers, batch, steps)
    return losses, launches


def _llama_train(device, preset, layers, batch, steps):
    """``_trainer_llama_run``'s recipe: its losses, launches and the
    trained state."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    cfg = llama.PRESETS[preset].replace(n_layers=layers, attn_impl="flash",
                                        remat=True, f32_logits=False)
    init, _ = ts.make_train_state_init(
        lambda g: llama.init_params(g, cfg),
        ts.adamw(3e-4, weight_decay=0.01), device=device)
    state = init(0)
    B, S = batch
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device=device)
    step = ts.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg))
    _reset_train_launches()
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return losses, _train_launches(), state


def _trainer_llama_loop(config):
    """``_trainer_llama_run`` in a train worker, on its device."""
    import os

    from ray_tpu_torch.train import session

    losses, launches = _trainer_llama_run(
        session.get_device(config.get("device")), config["preset"],
        config["layers"], config["batch"], config["steps"])
    session.report({"losses": losses, "launches": launches,
                    "pid": os.getpid()})


def _gpt2_card_vs_cpu():
    """The 125m width (d_model 768, 12 heads, d_ff 3072, vocab 50257) cut
    to 2 layers, f32 without TF32, adamw(3e-4, weight_decay=0.01), B 2,
    S 256: 2 steps on the card and on the CPU from one seeded init, held
    to the train_card_vs_cpu bounds. (The key bias's exact gradient is 0,
    so both step on rounding noise there, at most 2 lr a step apart: its
    1,536 elements stay within TRAIN_PARAM_MAX and are 2.9e-5 of the
    params, under TRAIN_PARAM_FAR_SHARE.)"""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt2.PRESETS["125m"].replace(n_layers=2, dtype=torch.float32)
    params0 = gpt2.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, 257)).astype(np.int64)
    out = {}
    for dev in ("cuda", "cpu"):
        init, _ = ts.make_train_state_init(
            lambda g: params0, ts.adamw(3e-4, weight_decay=0.01),
            device=dev)
        state = init(0)
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg))
        batch = {"tokens": torch.as_tensor(tokens, device=dev)}
        ms = []
        for _ in range(2):
            state, m = step(state, batch)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out[dev] = (ms, ts._leaves(state.params))
    return {"cfg": "125m width, 2 layers, f32, adamw(3e-4, "
                   "weight_decay=0.01), B 2 S 256, 2 steps",
            "loss_rel_tol": TRAIN_LOSS_RTOL, "param_max_tol": TRAIN_PARAM_MAX,
            "param_far_tol": TRAIN_PARAM_FAR,
            "param_far_share_max": TRAIN_PARAM_FAR_SHARE,
            **_card_vs_cpu_steps(out)}


def _gpt2_step_profile(preset, batch):
    """Where one GPT-2 step's time goes (``device_profile``), in this
    process, as the trainer's worker runs it: the `preset` from seed 0,
    its batch, deterministic algorithms (switched off again after)."""
    import os

    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        cfg = gpt2.PRESETS[preset]
        init, _ = ts.make_train_state_init(
            lambda g: gpt2.init_params(g, cfg),
            ts.adamw(3e-4, weight_decay=0.01), device="cuda")
        state = init(0)
        B, S = batch
        b = {"tokens": torch.as_tensor(np.random.default_rng(7).integers(
            0, cfg.vocab_size, size=(B, S + 1)), device="cuda")}
        step = ts.make_train_step(lambda p, x: gpt2.loss_fn(p, x, cfg))
        step(state, b)                      # warm-up
        return device_profile(lambda: step(state, b), lambda: step(state, b))
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _history(result, **match):
    return [m for m in result.metrics_history
            if all(m.get(k) == v for k, v in match.items())]


def phase_trainer(device="cuda", gpt2_preset="125m", llama_preset="1b",
                  batch=(8, 1024)):
    """The train layer (BASELINE target 1, the GPT-2 125M single-host
    trainer) through ``DataParallelTrainer``. On the card: (1) GPT-2 card
    against CPU (``_gpt2_card_vs_cpu``); then, in a session of
    ``ray_tpu_torch.init`` (the GPU detected, no override), each run in
    one train worker holding one GPU unit: (2) the `gpt2_preset` at full
    width and depth through ``_trainer_gpt2_loop`` with
    FailureConfig(max_failures=1), dying once after its step-10
    checkpoint and resuming from it, against the same loop run again
    without the death: losses bit for bit (deterministic algorithms),
    falling and finite; ``result.checkpoint`` loaded in the driver equals
    the worker's last saved params; the worker's peak memory under the
    card's; no flash kernel launched (GPT-2 reaches none); (3) the train
    phase's Llama recipe cut to 4 layers and 3 steps in a worker: its
    flash launches exact, its losses within TRAIN_SHARDED_LOSS_RTOL of
    the same run in this process (run after the session, its launches
    not counted). After ``shutdown()`` no process of the session alive.
    Step time, tokens/s, MFU (6 N tokens + 12 L B S^2 d_model over 989
    TFLOP/s), peak memory, the DCP seconds and bytes and one GPT-2 step's
    device profile (run in this process) as information.
    `device` "cpu" with small presets rehearses it on the CPU (every gate
    passes but the flash launch counts: the plain versions launch
    nothing)."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import (CheckpointConfig, DataParallelTrainer,
                                     FailureConfig, RunConfig, ScalingConfig)

    _free_device()
    _checkout_on_pythonpath()
    cuda = device == "cuda"
    res = {"cfg": f"gpt2 {gpt2_preset} (bf16 compute, f32 params, remat), "
                  f"B {batch[0]} S {batch[1]}, {TRAINER_STEPS} steps, a "
                  f"checkpoint every {TRAINER_EVERY}, death after step "
                  f"{TRAINER_DIE_AFTER}; llama {llama_preset} cut to "
                  f"{TRAINER_LLAMA_LAYERS} layers, {TRAINER_LLAMA_STEPS} "
                  "steps; one train worker, one GPU unit"}
    if cuda:
        res["card_vs_cpu"] = _gpt2_card_vs_cpu()
        _free_device()
    scaling = (ScalingConfig(num_workers=1, use_gpu=True, gpus_per_worker=1)
               if cuda else ScalingConfig(num_workers=1, use_gpu=False))
    loop_cfg = {"preset": gpt2_preset, "batch": list(batch),
                "steps": TRAINER_STEPS, "every": TRAINER_EVERY, "seed": 7,
                "device": None if cuda else "cpu"}
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=4)
    res["init_s"] = time.perf_counter() - t0
    pids = {p.pid: "daemon" for p in info["procs"]}
    try:
        res["cluster_resources"] = ray_tpu_torch.cluster_resources()

        def fit(loop, name, config, failures=0):
            t = time.perf_counter()
            out = DataParallelTrainer(
                loop, train_loop_config=config, scaling_config=scaling,
                run_config=RunConfig(
                    name=name, storage_path=root,
                    failure_config=FailureConfig(max_failures=failures),
                    checkpoint_config=CheckpointConfig(num_to_keep=2))).fit()
            res[f"{name}_fit_s"] = time.perf_counter() - t
            pids.update({m["pid"]: "worker" for m in out.metrics_history
                         if "pid" in m})
            return out

        died = fit(_trainer_gpt2_loop, "gpt2_died",
                   {**loop_cfg, "die_after": TRAINER_DIE_AFTER}, failures=1)
        whole = fit(_trainer_gpt2_loop, "gpt2_whole", loop_cfg)
        t = time.perf_counter()
        saved = died.checkpoint.load_state() if died.checkpoint else None
        res["driver_restore_s"] = time.perf_counter() - t
        llama_cfg = {"preset": llama_preset, "layers": TRAINER_LLAMA_LAYERS,
                     "batch": list(batch), "steps": TRAINER_LLAMA_STEPS,
                     "device": None if cuda else "cpu"}
        lw = fit(_trainer_llama_loop, "llama", llama_cfg)
        pids.update(session_pids(pids))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    res["session_pids"] = {str(p): m for p, m in pids.items()}
    res["errors"] = [r.error for r in (died, whole, lw) if r.error]

    # (2) GPT-2: the attempts, their losses, the checkpoint
    steps = [m for m in whole.metrics_history if "loss" in m]
    first = [m for m in _history(died, resumed=False) if "loss" in m]
    second = [m for m in _history(died, resumed=True) if "loss" in m]
    final = _history(whole, final=True)[-1] if _history(
        whole, final=True) else {}
    resumed_final = _history(died, final=True)[-1] if _history(
        died, final=True) else {}
    losses = [m["loss"] for m in steps]
    by_step = {m["step"]: m["loss"] for m in steps}
    res.update({
        "gpt2_losses": losses,
        "gpt2_grad_norms": [m["grad_norm"] for m in steps],
        "attempt1_steps": [m["step"] for m in first],
        "attempt2_steps": [m["step"] for m in second],
        "resumed_losses": [m["loss"] for m in second],
        "uninterrupted_losses_same_steps": [by_step.get(m["step"])
                                            for m in second],
        "resumed_bit_equal": bool(second) and all(
            m["loss"] == by_step.get(m["step"]) for m in first + second),
        "resumed_max_rel_diff": max(
            (abs(m["loss"] - by_step[m["step"]]) / abs(by_step[m["step"]])
             for m in first + second if m["step"] in by_step),
            default=None),
        "deterministic": final.get("deterministic"),
        "gpt2_launches": final.get("launches"),
        "gpt2_resumed_launches": resumed_final.get("launches")})
    last_saved = [m for m in second if "params_sha256" in m]
    res["checkpoint_params_equal"] = bool(
        saved is not None and last_saved
        and saved["step"] == TRAINER_STEPS
        and _params_digest(saved["params"])
        == last_saved[-1]["params_sha256"])
    step_s = [m["step_s"] for m in steps[1:]]
    if step_s:
        cfg = gpt2.PRESETS[gpt2_preset]
        B, S = batch
        med = statistics.median(step_s)
        flops = (6 * gpt2.num_params(cfg) * B * S
                 + 12 * cfg.n_layers * B * S * S * cfg.d_model)
        res.update({"n_params": gpt2.num_params(cfg),
                    "step_s_median": med, "step_s_all": step_s,
                    "tokens_per_s": B * S / med,
                    "model_flops_per_step": flops,
                    "mfu_vs_989_tflops": flops / med / 989e12})
    res.update({
        "peak_mem_gb": (final.get("peak_mem_bytes") or 0) / 1e9,
        "card_mem_gb": (final.get("card_mem_bytes") or 0) / 1e9,
        "dcp_save_s": final.get("dcp_save_s"),
        "dcp_restore_s": resumed_final.get("dcp_restore_s"),
        "dcp_bytes": final.get("dcp_bytes")})

    if cuda:
        _free_device()
        res["gpt2_profile_step"] = _gpt2_step_profile(gpt2_preset, batch)

    # (3) Llama in a worker against the same run in this process
    lrep = _history(lw)[-1] if lw.metrics_history else {}
    _free_device()
    ref_losses, _ = _trainer_llama_run(
        device, llama_preset, TRAINER_LLAMA_LAYERS, batch,
        TRAINER_LLAMA_STEPS)
    worker_losses = lrep.get("losses") or []
    L = TRAINER_LLAMA_LAYERS * TRAINER_LLAMA_STEPS
    expect = {"flash_attention_fwd": 2 * L, "flash_attention_fwd_window": 0,
              "flash_attention_bwd_dq": L, "flash_attention_bwd_dkdv": L}
    rel = [abs(a - b) / abs(b) for a, b in zip(worker_losses, ref_losses)]
    res.update({"llama_losses_worker": worker_losses,
                "llama_losses_in_process": ref_losses,
                "llama_loss_max_rel_diff": max(rel) if rel else None,
                "llama_loss_rel_tol": TRAIN_SHARDED_LOSS_RTOL,
                "llama_launches": lrep.get("launches"),
                "llama_launches_expected": expect})
    zero = {k: 0 for k in expect}
    res["launches"] = {k: lrep.get("launches", {}).get(k, 0)
                       + (final.get("launches") or {}).get(k, 0)
                       + (resumed_final.get("launches") or {}).get(k, 0)
                       for k in expect}
    res["gates"] = {
        "gpu_detected": (not cuda) or res["cluster_resources"].get("GPU")
        == 1.0,
        "card_vs_cpu": (not cuda) or res["card_vs_cpu"]["ok"],
        "fits_ok": not res["errors"],
        # every report up to the checkpoint resumed from reaches the
        # history, those the trainer had not polled before the death from
        # that checkpoint's record: attempt 1's steps are exactly
        # 1 .. 10, attempt 2's 11 .. 20
        "died_once_and_resumed": (
            res["attempt1_steps"] == list(range(1, TRAINER_DIE_AFTER + 1))
            and res["attempt2_steps"] == list(range(
                TRAINER_DIE_AFTER + 1, TRAINER_STEPS + 1))),
        "losses_finite_and_falling": (
            len(losses) == TRAINER_STEPS and all(np.isfinite(losses))
            and losses[-1] < losses[0]),
        "resumed_bit_equal": res["resumed_bit_equal"],
        "checkpoint_params_equal": res["checkpoint_params_equal"],
        "peak_mem_under_card": (not cuda) or 0 < res["peak_mem_gb"]
        < res["card_mem_gb"],
        "gpt2_launches_zero": (final.get("launches") == zero
                               and resumed_final.get("launches") == zero),
        "llama_launches_exact": lrep.get("launches") == expect,
        "llama_losses_match": (len(rel) == TRAINER_LLAMA_STEPS
                               and all(np.isfinite(worker_losses))
                               and max(rel) <= TRAIN_SHARDED_LOSS_RTOL),
        "no_process_left": not res["pids_alive_after_shutdown"]}
    res["ok"] = all(res["gates"].values())
    return res


# --- the data layer -------------------------------------------------------------

# part 1: GPT-2 125M ingest: rows of DATA_SEQ + 1 seeded tokens in
# DATA_BLOCKS blocks, DATA_STEPS steps of DATA_BATCH rows (all the rows)
DATA_ROWS, DATA_BLOCKS, DATA_BATCH, DATA_STEPS = 96, 8, 8, 12
DATA_SEQ, DATA_SEED, DATA_SHUFFLE_SEED = 1024, 11, 3
DATA_PROFILE_STEPS = 3
# part 2: Llama batch inference: rows of INFER_SEQ seeded tokens
INFER_ROWS, INFER_BLOCKS, INFER_SEQ, INFER_SEED = 64, 8, 512, 12


def _split_tokens(batch):
    """The data phase's map_batches UDF: [B, S + 1] tokens into inputs
    and next-token labels."""
    t = batch["tokens"]
    return {"input_ids": t[:, :-1], "labels": t[:, 1:]}


def _batch_sha(batch) -> str:
    """sha256 over a batch's columns (sorted by name), each as the bytes
    of its C-contiguous host array: equal iff every value is."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(batch):
        v = batch[k]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        a = np.ascontiguousarray(v)
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _data_gpt2_run(batches, device, preset, steps):
    """The trainer phase's GPT-2 recipe (bf16 compute over f32 params,
    remat as the preset has it, adamw(3e-4, weight_decay=0.01), seed 0)
    over `steps` batches drawn from the iterator `batches` of
    {"input_ids", "labels"} on `device`. Per step: the loss, the batch's
    sha256 (after the step), whether every column was on `device`, the
    step's seconds and the host's wait inside next(). Run under
    deterministic algorithms by the caller."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt2.PRESETS[preset]
    init, _ = ts.make_train_state_init(
        lambda g: gpt2.init_params(g, cfg),
        ts.adamw(3e-4, weight_decay=0.01), device=device)
    state = init(0)
    step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg))
    out = {"losses": [], "sha": [], "on_device": [], "step_s": [],
           "next_wait_s": []}
    it = iter(batches)
    for _ in range(steps):
        t0 = time.perf_counter()
        b = next(it)
        t1 = time.perf_counter()
        state, m = step(state, {"inputs": b["input_ids"].long(),
                                "targets": b["labels"].long()})
        loss = float(m["loss"])               # waits for the step
        out["step_s"].append(time.perf_counter() - t1)
        out["next_wait_s"].append(t1 - t0)
        out["losses"].append(loss)
        out["on_device"].append(all(t.device.type == device.type
                                    for t in b.values()))
        out["sha"].append(_batch_sha(b))
    return out


def _data_gpt2_loop(config):
    """Part 1's train loop in a train worker: the dataset shard
    "train" fed through ``iter_device_batches`` into ``_data_gpt2_run``
    under deterministic algorithms, on the worker's device."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from ray_tpu_torch.train import session

    torch.use_deterministic_algorithms(True)
    dev = session.get_device(config.get("device"))
    shard = session.get_dataset_shard("train")
    batches = shard.iter_device_batches(batch_size=config["batch"],
                                        device=config.get("device"))
    out = _data_gpt2_run(batches, dev, config["preset"], config["steps"])
    session.report({**out, "pid": os.getpid(),
                    "deterministic":
                        torch.are_deterministic_algorithms_enabled()})


def _data_copy_profile(it, preset, steps):
    """``steps`` GPT-2 steps in this process fed by the device iterator
    `it`, under torch.profiler (after one unprofiled step): each HtoD
    copy's stream (from the chrome trace) and whether it overlaps a kernel
    on another stream (the step before it), and the window's idle share
    (1 - the union of kernel and copy intervals over the span from the
    first to the last device event of the trace)."""
    import json as _json
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt2.PRESETS[preset]
    init, _ = ts.make_train_state_init(
        lambda g: gpt2.init_params(g, cfg),
        ts.adamw(3e-4, weight_decay=0.01), device="cuda")
    state = init(0)
    step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg))

    def one():
        nonlocal state
        b = next(it)
        state, m = step(state, {"inputs": b["input_ids"].long(),
                                "targets": b["labels"].long()})
        float(m["loss"])

    one()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = _json.load(f)
    finally:
        os.remove(path)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in ("kernel",
                                                          "gpu_memcpy")]
    kernels = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
               for e in events if e["cat"] == "kernel"]
    copies = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"),
               e["name"]) for e in events if e["cat"] == "gpu_memcpy"
              and "HtoD" in e["name"]]
    spans = sorted([(a, b) for a, b, _ in kernels]
                   + [(a, b) for a, b, _, _ in copies])
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {
        "htod_copies": [{"stream": s, "us": b - a, "name": n,
                         "overlaps_kernels": any(
                             ka < b and a < kb for ka, kb, ks in kernels
                             if ks != s)}
                        for a, b, s, n in copies],
        "copy_streams": sorted({s for _, _, s, _ in copies}),
        "kernel_streams": sorted({s for _, _, s in kernels}),
        "window_us": window, "device_busy_us": busy,
        "idle_share": (1.0 - busy / window) if window else None}


def _counting_predictor():
    """``FunctionPredictor`` counting K1 in its own process: the counters
    are set to 0 when it is made from the checkpoint (just before its
    blocks run) and each predicted block carries the launch count after
    it, its pid, the checkpoint's load seconds and when the load began
    (the host clock). Made in a function, so it pickles by value."""
    from ray_tpu_torch.train import FunctionPredictor

    class CountingPredictor(FunctionPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            t_wall, t0 = time.time(), time.perf_counter()
            pred = super().from_checkpoint(checkpoint, **kwargs)
            pred.load_s, pred.load_t = time.perf_counter() - t0, t_wall
            _reset_train_launches()
            return pred

        def predict(self, batch):
            import os

            import numpy as np

            out = super().predict(batch)
            n = len(out[self.output_column])
            out["k1_launches"] = np.full(
                n, _train_launches()["flash_attention_fwd"])
            out["pid"] = np.full(n, os.getpid())
            out["load_s"] = np.full(n, self.load_s)
            out["load_t"] = np.full(n, self.load_t)
            return out

    return CountingPredictor


def _llama_greedy(params, tokens, cfg):
    """apply_fn of part 2 (with `cfg` bound): each row's greedy next token
    and its logit (f32), as [B, 2] f32 (token ids < 2^24 are exact)."""
    import torch

    from ray_tpu_torch.models import llama

    last = llama.forward(params, tokens.long(), cfg)[:, -1].float()
    tok = last.argmax(-1)
    return torch.stack([tok.float(), last.gather(1, tok[:, None])[:, 0]],
                       dim=-1)


def phase_data(device="cuda", gpt2_preset="125m", llama_preset="1b"):
    """The data layer (``ray_tpu_torch.data``) on the card, in a session
    of ``ray_tpu_torch.init(num_cpus=4)`` (the GPU detected, no override).
    (1) Train ingest, GPT-2 at the `gpt2_preset` (BASELINE target 1):
    ``from_numpy`` of DATA_ROWS rows of DATA_SEQ + 1 seeded int32 tokens
    in DATA_BLOCKS blocks, ``map_batches`` into input_ids/labels,
    ``random_shuffle(seed)``, through ``DataParallelTrainer(datasets=
    {"train": ds})`` to one train worker holding one GPU unit, whose loop
    takes ``session.get_dataset_shard("train").iter_device_batches(
    batch_size=DATA_BATCH)`` for DATA_STEPS steps of the trainer phase's
    recipe under deterministic algorithms. Gates: every batch on the
    device and bit-equal (sha256) to the driver's own ``iter_batches`` of
    the same Dataset in the same order; the losses bit-equal to the same
    loop run in this process on those host batches moved with a plain
    ``.to("cuda")``; finite and falling. Information: step ms, tokens/s,
    MFU (the trainer phase's formula), the host's wait inside next(),
    and DATA_PROFILE_STEPS steps in this process under torch.profiler
    (each HtoD copy's stream, its overlap with the step before it, the
    window's idle share). (2) Batch inference with K1: the `llama_preset`
    at full width and depth, bf16, attn_impl="flash", seeded params saved
    as a Checkpoint; INFER_ROWS rows of INFER_SEQ seeded tokens in
    INFER_BLOCKS blocks through ``BatchPredictor(ckpt, FunctionPredictor,
    apply_fn=greedy).predict(ds, num_replicas=1, resources_per_replica=
    {"GPU": 1})`` (a ``FunctionPredictor`` subclass that counts K1 in the
    actor). Gates: the tokens equal and the logits bit-equal to the same
    predictor run in this process over the same blocks; K1 launched
    exactly n_layers x INFER_BLOCKS times in the actor. Information: the
    actor's start, the checkpoint load, rows/s and tokens/s. After
    ``shutdown()`` no process of the session alive. `device` "cpu" with
    small presets rehearses it on the CPU (every gate passes but the K1
    count: the plain versions launch nothing)."""
    import functools
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.train import (BatchPredictor, Checkpoint,
                                     DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    _free_device()
    _checkout_on_pythonpath()
    cuda = device == "cuda"
    gcfg = gpt2.PRESETS[gpt2_preset]
    S = min(DATA_SEQ, gcfg.max_seq_len)
    lcfg = llama.PRESETS[llama_preset].replace(
        attn_impl="flash", remat=False, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, f32_logits=False)
    if not cuda:
        lcfg = lcfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    SI = min(INFER_SEQ, lcfg.max_seq_len)
    res = {"cfg": f"part 1: gpt2 {gpt2_preset}, {DATA_ROWS} rows of "
                  f"{S + 1} tokens in {DATA_BLOCKS} blocks, map_batches, "
                  f"random_shuffle, {DATA_STEPS} steps of {DATA_BATCH} "
                  f"rows; part 2: llama {llama_preset} "
                  f"({lcfg.n_layers} layers, d_model {lcfg.d_model}, "
                  f"{'bf16' if cuda else 'f32'}, flash), {INFER_ROWS} rows "
                  f"of {SI} tokens in {INFER_BLOCKS} blocks, one replica "
                  "holding one GPU unit"}
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    tokens = np.random.default_rng(DATA_SEED).integers(
        0, gcfg.vocab_size, size=(DATA_ROWS, S + 1), dtype=np.int32)
    prompts = np.random.default_rng(INFER_SEED).integers(
        0, lcfg.vocab_size, size=(INFER_ROWS, SI), dtype=np.int32)
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=4)
    res["init_s"] = time.perf_counter() - t0
    pids = {p.pid: "daemon" for p in info["procs"]}
    try:
        res["cluster_resources"] = ray_tpu_torch.cluster_resources()
        # (1) train ingest
        t = time.perf_counter()
        ds = (rd.from_numpy({"tokens": tokens}, num_blocks=DATA_BLOCKS)
              .map_batches(_split_tokens)
              .random_shuffle(seed=DATA_SHUFFLE_SEED))
        res["dataset_s"] = time.perf_counter() - t
        res["dataset_blocks"] = ds.num_blocks()
        host = list(ds.iter_batches(batch_size=DATA_BATCH, drop_last=True))
        res["host_batches"] = len(host)
        scaling = (ScalingConfig(num_workers=1, use_gpu=True,
                                 gpus_per_worker=1) if cuda
                   else ScalingConfig(num_workers=1, use_gpu=False))
        t = time.perf_counter()
        fit = DataParallelTrainer(
            _data_gpt2_loop, scaling_config=scaling,
            train_loop_config={"preset": gpt2_preset, "batch": DATA_BATCH,
                               "steps": DATA_STEPS,
                               "device": None if cuda else "cpu"},
            run_config=RunConfig(name="data_ingest", storage_path=root),
            datasets={"train": ds}).fit()
        res["fit_s"] = time.perf_counter() - t
        res["fit_error"] = fit.error
        wrep = fit.metrics_history[-1] if fit.metrics_history else {}
        if "pid" in wrep:
            pids[wrep["pid"]] = "worker"
        if cuda:
            _free_device()
            shard = ds.streaming_split(1)[0]
            res["copy_profile"] = _data_copy_profile(
                iter(shard.iter_device_batches(batch_size=DATA_BATCH)),
                gpt2_preset, DATA_PROFILE_STEPS)

        # (2) batch inference
        gen = torch.Generator(device=device).manual_seed(0)
        t = time.perf_counter()
        params = llama.init_params(gen, lcfg)
        ckpt = Checkpoint.from_state({"params": params},
                                     os.path.join(root, "llama_ckpt"))
        res["ckpt_save_s"] = time.perf_counter() - t
        del params
        _free_device()
        ids = rd.from_numpy({"features": prompts}, num_blocks=INFER_BLOCKS)
        res["infer_blocks"] = ids.num_blocks()
        apply_fn = functools.partial(_llama_greedy, cfg=lcfg)
        t_call, t = time.time(), time.perf_counter()
        pred = BatchPredictor(
            ckpt, _counting_predictor(), apply_fn=apply_fn,
            device=None if cuda else "cpu").predict(
            ids, num_replicas=1,
            resources_per_replica={"GPU": 1} if cuda else None)
        res["predict_s"] = time.perf_counter() - t
        out_blocks = [ray_tpu_torch.get(r) for r in pred._block_refs]
        in_blocks = [ray_tpu_torch.get(r) for r in ids._block_refs]
        pids.update(session_pids(pids))
    finally:
        ray_tpu_torch.shutdown()
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    res["session_pids"] = {str(p): m for p, m in pids.items()}

    # (1) the worker's batches and losses against this process's
    ref_dev = torch.device(device)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        _free_device()
        ref = _data_gpt2_run(
            ({k: torch.from_numpy(np.array(v)).to(ref_dev)
              for k, v in b.items()} for b in host),
            ref_dev, gpt2_preset, DATA_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    host_sha = [_batch_sha(b) for b in host]
    losses = wrep.get("losses") or []
    res.update({
        "worker_losses": losses, "in_process_losses": ref["losses"],
        "batch_sha_equal": wrep.get("sha") == host_sha[:DATA_STEPS],
        "in_process_sha_equal": ref["sha"] == host_sha[:DATA_STEPS],
        "worker_batches_on_device": wrep.get("on_device"),
        "deterministic": wrep.get("deterministic"),
        "next_wait_ms_mean": (1e3 * statistics.mean(wrep["next_wait_s"])
                              if wrep.get("next_wait_s") else None),
        "next_wait_ms_max": (1e3 * max(wrep["next_wait_s"])
                             if wrep.get("next_wait_s") else None),
        "next_wait_ms_all": [1e3 * w for w in wrep.get("next_wait_s", [])]})
    step_s = (wrep.get("step_s") or [])[1:]
    if step_s:
        B = DATA_BATCH
        med = statistics.median(step_s)
        flops = (6 * gpt2.num_params(gcfg) * B * S
                 + 12 * gcfg.n_layers * B * S * S * gcfg.d_model)
        res.update({"step_ms_median": 1e3 * med,
                    "step_ms_all": [1e3 * s for s in step_s],
                    "tokens_per_s": B * S / med,
                    "mfu_vs_989_tflops": flops / med / 989e12,
                    "in_process_step_ms_median":
                        1e3 * statistics.median(ref["step_s"][1:])})

    # (2) the actor's predictions against the same predictor in process
    got = np.concatenate([b["predictions"] for b in out_blocks]) \
        if out_blocks else np.zeros((0, 2), np.float32)
    _free_device()
    try:
        local = _counting_predictor().from_checkpoint(
            ckpt, apply_fn=apply_fn, device=None if cuda else "cpu")
        want = np.concatenate([local.predict(b)["predictions"]
                               for b in in_blocks])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del local
    _free_device()
    actor_launches = int(out_blocks[-1]["k1_launches"][0]) \
        if out_blocks else None
    expect = lcfg.n_layers * INFER_BLOCKS
    res.update({
        "tokens_equal": bool(got.shape == want.shape
                             and np.array_equal(got[:, 0], want[:, 0])),
        "logits_bit_equal": bool(got.shape == want.shape
                                 and np.array_equal(got[:, 1], want[:, 1])),
        "greedy_tokens_head": got[:8, 0].astype(int).tolist(),
        "actor_k1_launches": actor_launches,
        "actor_k1_launches_expected": expect,
        "actor_pids": sorted({int(b["pid"][0]) for b in out_blocks}),
        "actor_start_s": (float(out_blocks[0]["load_t"][0]) - t_call
                          if out_blocks else None),
        "ckpt_load_s": float(out_blocks[0]["load_s"][0])
        if out_blocks else None,
        "predict_rows_per_s": INFER_ROWS / res["predict_s"],
        "predict_tokens_per_s": INFER_ROWS * SI / res["predict_s"]})
    res["launches"] = {"flash_attention_fwd": actor_launches or 0}
    res["gates"] = {
        "gpu_detected": (not cuda) or res["cluster_resources"].get("GPU")
        == 1.0,
        "fit_ok": not fit.error,
        "batches_on_device": bool(wrep.get("on_device")) and all(
            wrep["on_device"]) and len(wrep["on_device"]) == DATA_STEPS,
        "batches_bit_equal": res["batch_sha_equal"]
        and res["in_process_sha_equal"],
        "losses_bit_equal": len(losses) == DATA_STEPS
        and losses == ref["losses"],
        "losses_finite_and_falling": len(losses) == DATA_STEPS
        and all(np.isfinite(losses)) and losses[-1] < losses[0],
        "tokens_equal": res["tokens_equal"],
        "logits_bit_equal": res["logits_bit_equal"],
        "k1_launches_exact": actor_launches == expect,
        "no_process_left": not res["pids_alive_after_shutdown"]}
    res["ok"] = all(res["gates"].values())
    return res


# --- the RL layer -------------------------------------------------------------

# rl: BASELINE.json target 5, PPO on pixels at the published widths. The
# settings of rllib's tuned_examples/ppo/atari-ppo.yaml: a 5,000-step train
# batch (here 4 rollout actors x 1,250 steps, cut from the yaml's 10
# workers x 5 envs), minibatch 500, 10 epochs, clip 0.1, lambda 0.95,
# entropy 0.01; the JAX PPOConfig's defaults otherwise (lr 3e-4, gamma
# 0.99, vf_coeff 0.5); 3 train() iterations
RL_WORKERS, RL_FRAGMENT, RL_MINIBATCH, RL_EPOCHS, RL_ITERS = 4, 1250, 500, 10, 3
# card vs CPU, f32 with TF32 off (set for every phase in _start), from the
# same params and iteration 1's batch. The first minibatch's gradient:
# f32 sums of up to 3136 products in another order, each leaf within
# RL_GRAD_RTOL of its largest element, the loss terms within RL_LOSS_RTOL.
# A whole run_ppo_epochs (100 Adam steps): the clipped ratio and Adam's
# per-element normalisation carry rounding-level differences on, and f32
# rounding alone moves this run's param update by ~7e-2 of its norm
# against the same run in f64 (the phase measures it: the card's f64 run
# is held against both f32 runs), so two faithful f32 learners may differ
# by twice that; a learner computing anything else makes an update
# uncorrelated with the right one (~1.4 of its norm apart). The three runs
# (card f32, CPU f32, card f64) must lie pairwise within RL_UPDATE_RTOL of
# the update's norm, and the last minibatch's loss terms within RL_AUX_ATOL
# (they move ~2e-5 under the same rounding)
RL_GRAD_RTOL = 1e-4
RL_LOSS_RTOL = 1e-5
RL_UPDATE_RTOL = 0.25
RL_AUX_ATOL = 1e-3


def _all_launches():
    """Every kernel's launch counter (K1-K4 and K5/K6)."""
    from ray_tpu_torch.ops import paged_attention as pa

    return {**_train_launches(),
            "paged_decode_attention_inplace": pa.launches,
            "paged_attention": pa.launches_read}


def _reset_all_launches():
    from ray_tpu_torch.ops import paged_attention as pa

    _reset_train_launches()
    pa.launches = pa.launches_read = 0


def _nature_cnn_flop(batch: int, hw: int, stack: int, hidden: int = 512,
                     n_actions: int = 3) -> float:
    """Operations of one PPO update of the Nature CNN for `batch`
    observations of hw x hw x stack, 2 per multiply-add: the forward, the
    weight gradient and the input gradient (3 x the forward) of every layer
    but the first conv, whose input (the observations) needs no gradient
    (2 x its forward)."""
    from ray_tpu_torch.rl.vision import NATURE_FILTERS

    macs, h, c = 0, hw, stack
    for n, (cout, (k, _), s) in enumerate(NATURE_FILTERS):
        h = (h - k) // s + 1
        macs += (2 if n == 0 else 3) * h * h * cout * k * k * c
        c = cout
    macs += 3 * (h * h * c * hidden + hidden * (n_actions + 1))
    return 2 * macs * batch


def _update_distance(a, b, p0) -> float:
    """|| (a - p0) - (b - p0) || / || b - p0 || over every leaf, in f64."""
    import torch

    from ray_tpu_torch.rl.core import tree_leaves

    def flat(t):
        return torch.cat([x.detach().to("cpu", torch.float64).flatten()
                          for x in tree_leaves(t)])
    da, db = flat(a) - flat(p0), flat(b) - flat(p0)
    return float((da - db).norm() / db.norm())


def phase_rl(device="cuda", out_size=84, fragment=RL_FRAGMENT,
             iters=RL_ITERS):
    """PPO on pixels through the RL layer (``ray_tpu_torch.rl``, BASELINE
    target 5) in a session of ``ray_tpu_torch.init(num_cpus=8)``:
    ``PPOTrainer`` on ``PixelCatcher`` (84 x 84 RGB) through
    ``atari_connectors(stack=4, out_size)`` (grayscale, resize, [0, 1],
    4 frames stacked) into the Nature CNN with a dense layer of 512
    (1.68 M params at 84), RL_WORKERS rollout actors of `fragment` steps
    each on the CPU (``CPU_WORKER_ENV``: the card hidden), the learner's
    params and Adam state on `device`, f32 (TF32 off), `iters` train()
    iterations of RL_EPOCHS epochs of RL_MINIBATCH-row minibatches, the
    launch counters zeroed just before and read just after (the path
    runs none of K1-K6). Gates: (a) every param on the learner's device,
    every rollout actor without CUDA; (b) iteration 1's batch, saved,
    through one minibatch update and one run_ppo_epochs from iteration
    1's starting params on the card and on the CPU (and in f64 on the
    card), within the RL_* bounds above; (c) each iteration RL_WORKERS x
    `fragment` timesteps, finite losses and entropy; no process of the
    session left after ``shutdown()``. Information: each iteration's
    wall, sampling and learning time, env steps/s, ms per minibatch
    update against its operations bound, a profiled learn window (one
    run_ppo_epochs) with its idle share and top kernels, peak memory. `device`
    "cpu" with out_size=42 rehearses it on the CPU (gate (b) compares the
    CPU with itself there)."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.rl import core as rcore
    from ray_tpu_torch.rl import ppo as rppo
    from ray_tpu_torch.rl.pixel_env import atari_connectors

    _free_device()
    _checkout_on_pythonpath()
    on_card = device == "cuda"
    cfg = rppo.PPOConfig(
        env="ray_tpu_torch.rl.pixel_env:PixelCatcher",
        obs_connectors=atari_connectors(stack=4, out_size=out_size),
        num_rollout_workers=RL_WORKERS, rollout_fragment_length=fragment,
        num_epochs=RL_EPOCHS, minibatch_size=RL_MINIBATCH, clip=0.1,
        lam=0.95, entropy_coeff=0.01, seed=0, device=device)
    n_rows = RL_WORKERS * fragment
    n_updates = RL_EPOCHS * (n_rows // RL_MINIBATCH)

    class Saving(rppo.PPOTrainer):
        """PPOTrainer keeping iteration 1's batch (gate (b))."""

        def _sample_batch(self):
            batch = super()._sample_batch()
            if self.iteration == 0:
                self.first_batch = batch
            return batch

    res = {"cfg": f"PPO on PixelCatcher 84x84 RGB -> atari_connectors("
                  f"stack=4, out_size={out_size}) -> Nature CNN + dense 512"
                  f", {RL_WORKERS} CPU rollout actors x {fragment} steps, "
                  f"minibatch {RL_MINIBATCH}, {RL_EPOCHS} epochs, clip 0.1, "
                  f"lambda 0.95, entropy 0.01, lr 3e-4, f32 learner on "
                  f"{device} (TF32 off), {iters} iterations",
           "update_gflop": _nature_cnn_flop(RL_MINIBATCH, out_size, 4) / 1e9}
    res["update_bound_ms"] = bound(0, res["update_gflop"] * 1e9,
                                   "float32")[0]
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=8)
    res["init_s"] = time.perf_counter() - t0
    pids = {p.pid: "daemon" for p in info["procs"]}
    gates = {}
    try:
        t0 = time.perf_counter()
        tr = Saving(cfg)
        res["trainer_start_s"] = time.perf_counter() - t0
        res["n_params"] = sum(t.numel() for t in rcore.tree_leaves(tr.params))
        p0 = rcore.to_host(tr.params)
        where = ray_tpu_torch.get([w.placement.remote() for w in tr.workers])
        res["rollout_actors"] = where
        gates["a_learner_on_device"] = all(
            t.device.type == torch.device(device).type
            for t in rcore.tree_leaves(tr.params))
        gates["a_actors_without_cuda"] = all(
            not w["cuda_available"] for w in where)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        its = [tr.train() for _ in range(iters)]
        res["launches"] = _all_launches()
        res["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None)
        res["iterations"] = [{
            k: r[k] for k in ("timesteps_this_iter", "time_this_iter_s",
                              "sample_time_s", "learn_time_s",
                              "episode_return_mean", "episodes_total",
                              "pg_loss", "vf_loss", "entropy", "total_loss")}
            for r in its]
        for r in res["iterations"]:
            r["env_steps_per_s"] = r["timesteps_this_iter"] / r[
                "sample_time_s"]
            r["ms_per_update"] = r["learn_time_s"] * 1e3 / n_updates
        gates["c_timesteps"] = all(r["timesteps_this_iter"] == n_rows
                                   for r in its)
        gates["c_finite"] = all(np.isfinite([r[k] for k in (
            "pg_loss", "vf_loss", "entropy", "total_loss")]).all()
            for r in its)
        batch = tr.first_batch
        pids.update(session_pids(pids))
        tr.stop()
    finally:
        ray_tpu_torch.shutdown()
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    gates["c_no_process_left"] = not res["pids_alive_after_shutdown"]

    def learner(dev, dtype=torch.float32, epochs=RL_EPOCHS):
        """One run_ppo_epochs of `batch` from p0 on `dev` in `dtype`."""
        b = {k: (v.astype(np.float64) if dtype == torch.float64
                 and v.dtype == np.float32 else v) for k, v in batch.items()}
        params = rcore.tree_map(lambda t: t.to(dev, dtype, copy=True), p0)
        update = rppo.make_ppo_update(cfg, rcore.Adam(cfg.lr))
        params, _, aux = rppo.run_ppo_epochs(
            update, params, None, **b, num_epochs=epochs,
            minibatch_size=RL_MINIBATCH, seed=0)
        return params, rppo.read_aux(aux)

    # the profiled learn window: one run_ppo_epochs of iteration 1's batch
    # (its copy to the card and n_updates minibatch updates)
    if on_card:
        prof = device_profile(lambda: learner(device), lambda: learner(device))
        prof["ms_per_update"] = prof["wall_ms"] / n_updates
        res["profile_learn"] = prof

    # (b) the first minibatch's gradient, card vs CPU
    adv = (batch["adv"] - batch["adv"].mean()) / (batch["adv"].std() + 1e-8)
    idx = np.random.default_rng(0).permutation(n_rows)[:RL_MINIBATCH]
    mb = {"obs": batch["obs"][idx], "actions": batch["actions"][idx],
          "logp": batch["logp"][idx], "adv": adv[idx],
          "returns": batch["returns"][idx]}
    loss_fn = rppo.make_ppo_loss(cfg.clip, cfg.vf_coeff, cfg.entropy_coeff)
    first = {}
    for dev in (device, "cpu"):
        (total, aux), grads = rcore.value_and_grad(
            loss_fn, rcore.to_device(p0, dev), rppo.batch_to_device(mb, dev))
        first[dev] = (rppo.read_aux({"total_loss": total, **aux}),
                      [g.cpu() for g in grads])
    (la, ga), (lc, gc) = first[device], first["cpu"]
    grad_err = max(float((a - c).abs().max() / c.abs().max())
                   for a, c in zip(ga, gc))
    loss_err = max(abs(la[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc)
    # (b) one run_ppo_epochs, card f32 / CPU f32 / card f64
    t0 = time.perf_counter()
    card32, aux_card = learner(device)
    cpu32, aux_cpu = learner("cpu")
    cpu_s = time.perf_counter() - t0
    card64, aux_64 = learner(device, torch.float64)
    dist = {"card_f32_vs_cpu_f32": _update_distance(card32, cpu32, p0),
            "card_f32_vs_card_f64": _update_distance(card32, card64, p0),
            "cpu_f32_vs_card_f64": _update_distance(cpu32, card64, p0)}
    aux_err = max(abs(aux_card[k] - aux_cpu[k]) for k in aux_cpu)
    res["card_vs_cpu"] = {
        "first_update": {"loss_terms_card": la, "loss_terms_cpu": lc,
                         "loss_max_rel_err": loss_err,
                         "grad_max_rel_err": grad_err,
                         "tol": {"loss": RL_LOSS_RTOL,
                                 "grad": RL_GRAD_RTOL}},
        "run_ppo_epochs": {"updates": n_updates,
                           "update_rel_distance": dist,
                           "aux_card": aux_card, "aux_cpu": aux_cpu,
                           "aux_f64": aux_64, "aux_max_abs_err": aux_err,
                           "card_and_cpu_s": cpu_s,
                           "tol": {"update": RL_UPDATE_RTOL,
                                   "aux": RL_AUX_ATOL}}}
    gates["b_first_update"] = (grad_err <= RL_GRAD_RTOL
                               and loss_err <= RL_LOSS_RTOL)
    gates["b_run_ppo_epochs"] = (max(dist.values()) <= RL_UPDATE_RTOL
                                 and aux_err <= RL_AUX_ATOL)
    gates["no_kernel_launched"] = not any(res["launches"].values())
    res["gates"] = gates
    res["ok"] = all(gates.values())
    return res


# --- the RL layer's off-policy and offline learners -----------------------------


class CartPole:
    """gymnasium's CartPole-v1 in numpy (classic_control/cartpole.py under
    ``gym.make``'s TimeLimit of 500 steps): the same Euler dynamics, the
    reset state uniform in [-0.05, 0.05]^4 from the generator
    ``reset(seed=)`` builds (``np.random.default_rng(seed)``, what
    ``seeding.np_random`` makes), reward 1 a step, termination past 2.4 in
    x or 12 degrees in theta, truncation at 500 steps; the spaces are
    ``ray_tpu_torch.rl.pixel_env.Box``/``Discrete``. A fixture of the
    ``rl_offpolicy`` phase (gymnasium is not installed beside the card),
    held against gymnasium's env by tests/test_torch_rl_chip_envs.py.
    ``action_seed`` seeds the action space at construction: tests use it
    to make epsilon and warm-up draws repeatable."""

    max_episode_steps = 500

    def __init__(self, action_seed=None):
        import math

        import numpy as np

        from ray_tpu_torch.rl.pixel_env import Box, Discrete

        self.gravity, self.masscart, self.masspole = 9.8, 1.0, 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag, self.tau = 10.0, 0.02
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, (4,), np.float32)
        if action_seed is not None:
            self.action_space.seed(action_seed)
        self._np_random = None
        self.state = None
        self.steps_beyond_terminated = None
        self._elapsed = 0

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None or self._np_random is None:
            self._np_random = np.random.default_rng(seed)
        self.state = self._np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps_beyond_terminated = None
        self._elapsed = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        import numpy as np

        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = 0.0
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                truncated, {})

    def close(self):
        pass


class Pendulum:
    """gymnasium's Pendulum-v1 in numpy (classic_control/pendulum.py under
    ``gym.make``'s TimeLimit of 200 steps): the same dynamics (g 10,
    torque clipped to 2, speed to 8, dt 0.05), the reset state uniform in
    [-pi, pi] x [-1, 1] from ``np.random.default_rng(seed)``, the cost
    theta^2 + 0.1 thetadot^2 + 0.001 u^2 negated, never terminated,
    truncated at 200 steps; spaces and ``action_seed`` as ``CartPole``'s."""

    max_episode_steps = 200

    def __init__(self, action_seed=None):
        import numpy as np

        from ray_tpu_torch.rl.pixel_env import Box

        self.max_speed, self.max_torque, self.dt = 8, 2.0, 0.05
        self.g, self.m, self.l = 10.0, 1.0, 1.0
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,),
                                np.float32)
        self.observation_space = Box(-high, high, (3,), np.float32)
        if action_seed is not None:
            self.action_space.seed(action_seed)
        self._np_random = None
        self.state = None
        self._elapsed = 0

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None or self._np_random is None:
            self._np_random = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._np_random.uniform(low=-high, high=high)
        self._elapsed = 0
        return self._obs(), {}

    def _obs(self):
        import numpy as np

        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)

    def step(self, u):
        import numpy as np

        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = (((th + np.pi) % (2 * np.pi)) - np.pi) ** 2 \
            + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return self._obs(), -costs, False, truncated, {}

    def close(self):
        pass


# rl_offpolicy: the replay-based off-policy and offline learners on the
# card, each trainer at its reference config's defaults (SACConfig,
# DQNConfig, CQLConfig) on the numpy CartPole/Pendulum above. Cuts: the
# iteration counts; CQL's act_high is Pendulum's 2 (the data's bound); the
# sweep's trainers start learning after one fragment
RLO_SAC_ITERS, RLO_DQN_ITERS, RLO_CQL_ITERS = 10, 10, 3
RLO_SWEEP = ("TD3", "DDPG", "ApexDQN", "ApexDDPG", "R2D2", "SimpleQ", "BC",
             "CRR", "MARWIL", "DT")
# card vs CPU, f32 with TF32 off. One update from the same state,
# minibatch and noise: each loss term within RLO_LOSS_RTOL of the CPU's
# (relative), each gradient leaf within RLO_GRAD_RTOL of its largest
# element (sums of up to 128 products in another order). One iteration's
# updates (SAC and DQN 32, CQL's whole run of 96) on the card in f32, the
# CPU in f32 and the card in f64 from the same state, minibatches and
# noise: the three runs' updates pairwise within RLO_UPDATE_RTOL of the
# update's norm, set from the f64 run's readings (each f32 run against
# it; two faithful f32 runs may lie twice that apart) with a margin for
# other data. f32 against f64 on an NVIDIA H100 80GB HBM3 at 700 W: SAC
# 4.1e-6, DQN 2.8e-6, CQL 1.4e-5 on this phase's seeded data; 3.9e-6 /
# 2.7e-6 / 1.85e-4 with unseeded warm-up actions; card f32 against CPU f32
# 3.5e-7 to 9.4e-7. No clipping or argmax flip carries rounding far in
# these updates; a learner computing anything else lands ~1 of the norm
# away
RLO_GRAD_RTOL = 1e-4
RLO_LOSS_RTOL = 1e-5
RLO_UPDATE_RTOL = {"sac": 1e-4, "dqn": 1e-4, "cql": 1e-3}
# the fixtures' action spaces seeded, so that the warm-up and epsilon
# draws, and with them every transition, are the same in every run
RLO_ENV_CONFIG = {"action_seed": 0}


def _mlp_flop(rows: int, sizes) -> float:
    """Operations of one dense stack's forward over `rows` rows (2 per
    multiply-add)."""
    return 2.0 * rows * sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))


def _rlo_update_flop(kind: str, cfg, obs_dim: int, act: int) -> float:
    """Operations of one update at `cfg`'s widths: a forward counts once, a
    forward whose gradient is taken three times (the forward, the weight
    and the input gradients), a forward that only passes a gradient
    through to its input (the critics under the actor's loss) twice."""
    h = cfg.hidden
    if kind == "dqn":                # act: the number of actions
        f = _mlp_flop(cfg.train_batch_size, [obs_dim, h, h]) + _mlp_flop(
            cfg.train_batch_size, [h, act + 1])
        return 3 * f + 2 * f         # online (with grad), target, online s'
    B = cfg.train_batch_size
    actor = _mlp_flop(B, [obs_dim, h, h, 2 * act])
    q = _mlp_flop(B, [obs_dim + act, h, h, 1])
    flop = 4 * actor + 12 * q        # SAC: critics 1a + 2q + 6q, actor 3a + 4q
    if kind == "cql":                # + the policy's N actions, 2 x 2N sets
        n = cfg.cql_n_actions
        flop += n * actor + 2 * 3 * 2 * n * q
    return flop


def _tree_to(tree, dev, dtype=None):
    """A copy of a tree of tensors (dicts, lists, tuples; other leaves as
    they are) on `dev`, floating tensors in `dtype` where one is given."""
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if dtype is not None and t.is_floating_point():
            return t.to(dev, dtype, copy=True)
        return t.to(dev, copy=True)
    return tree


class _UpdateTape:
    """Wraps a trainer's update method (`attr`): in the iterations `at`
    keeps the state its first call starts from (the first `n_state`
    arguments) and every call's other arguments (minibatch, noise), CPU
    copies, then calls through."""

    def __init__(self, trainer, n_state: int, at, attr: str = "_update"):
        self.trainer, self.n_state, self.at = trainer, n_state, at
        self.inner = getattr(trainer, attr)
        self.state0, self.calls = None, []
        setattr(trainer, attr, self)

    def __call__(self, *args, **kwargs):
        if self.trainer.iteration in self.at:
            if self.state0 is None:
                self.state0 = _tree_to(list(args[:self.n_state]), "cpu")
            self.calls.append(_tree_to(list(args[self.n_state:]), "cpu"))
        return self.inner(*args, **kwargs)


class _GradTape:
    """``core.Adam`` that keeps every gradient it is given (f64 CPU
    copies) before its step."""

    def __init__(self, lr):
        from ray_tpu_torch.rl.core import Adam

        self.adam, self.grads = Adam(lr), []

    def init(self, params):
        return self.adam.init(params)

    def step(self, params, grads, state):
        import torch

        self.grads.append([g.detach().to("cpu", torch.float64)
                           for g in grads])
        self.adam.step(params, grads, state)


def _rlo_stepper(name: str, tr, opt_cls):
    """(step(state, call) -> (state, aux), the optimizers, the trainable
    part of a state) for trainer `tr` of algorithm `name`, with fresh
    optimizers of `opt_cls` at the config's rates."""
    from ray_tpu_torch.rl import dqn, offline, sac

    cfg = tr.config
    if name == "sac":
        opts = [opt_cls(cfg.actor_lr), opt_cls(cfg.critic_lr),
                opt_cls(cfg.alpha_lr)]
        upd = sac.make_sac_update(cfg, tr.act_high, tr.target_entropy, *opts)

        def step(st, call):
            out = upd(*st, *call)
            return list(out[:6]), out[6]
        return step, opts, lambda st: {"nets": st[0], "log_alpha": st[2]}
    if name == "dqn":
        opts = [opt_cls(cfg.lr)]
        upd = dqn.make_q_update(dqn.make_dqn_loss(cfg.gamma, cfg.double_q),
                                opts[0])

        def step(st, call):
            net, os_, loss, _ = upd(st[0], st[1], st[2], *call)
            return [net, st[1], os_], {"loss": loss}
        return step, opts, lambda st: st[0]
    opts = [opt_cls(cfg.lr), opt_cls(cfg.lr)]
    upd = offline.make_cql_update(cfg, *opts)

    def step(st, call):
        out = upd(*st, *call)
        return list(out[:4]), out[4]
    return step, opts, lambda st: st[0]


def _rlo_replay(step, state0, calls, dev, dtype=None):
    """The recorded updates from `state0` on `dev` (in `dtype`): the final
    state and the last update's loss terms as floats."""
    from ray_tpu_torch.rl.ppo import read_aux

    st = _tree_to(state0, dev, dtype)
    aux = {}
    for call in calls:
        st, aux = step(st, _tree_to(call, dev, dtype))
    return st, read_aux(aux)


def _rlo_card_vs_cpu(name, tr, tape, device, res, gates,
                     stepper=_rlo_stepper, loss_rtol=RLO_LOSS_RTOL,
                     grad_rtol=RLO_GRAD_RTOL, update_rtol=None):
    """Gate (b) for one learner: the first recorded update card vs CPU
    (loss terms, every optimizer's gradients), then every recorded update
    on the card in f32, the CPU in f32 and the card in f64. `stepper`
    builds the learner's update (``_rlo_stepper``'s contract); the bounds
    default to RLO_*'s."""
    import torch

    from ray_tpu_torch.rl.core import Adam

    if update_rtol is None:
        update_rtol = RLO_UPDATE_RTOL[name]
    first = {}
    for dev in (device, "cpu"):
        step, opts, _ = stepper(name, tr, _GradTape)
        _, aux = _rlo_replay(step, tape.state0, tape.calls[:1], dev)
        first[dev] = (aux, [g for o in opts for g in o.grads])
    (la, ga), (lc, gc) = first[device], first["cpu"]
    loss_err = max(abs(la[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc)
    grad_err = max(float((a - c).abs().max() / max(float(c.abs().max()),
                                                    1e-30))
                   for gs_a, gs_c in zip(ga, gc)
                   for a, c in zip(gs_a, gs_c))
    runs = {}
    for key, dev, dtype in (("card_f32", device, torch.float32),
                            ("cpu_f32", "cpu", torch.float32),
                            ("card_f64", device, torch.float64)):
        step, _, trainable = stepper(name, tr, Adam)
        st, aux = _rlo_replay(step, tape.state0, tape.calls, dev, dtype)
        runs[key] = (trainable(st), aux)
    p0 = stepper(name, tr, Adam)[2](tape.state0)
    dist = {"card_f32_vs_cpu_f32": _update_distance(
                runs["card_f32"][0], runs["cpu_f32"][0], p0),
            "card_f32_vs_card_f64": _update_distance(
                runs["card_f32"][0], runs["card_f64"][0], p0),
            "cpu_f32_vs_card_f64": _update_distance(
                runs["cpu_f32"][0], runs["card_f64"][0], p0)}
    res["card_vs_cpu"] = {
        "first_update": {"loss_terms_card": la, "loss_terms_cpu": lc,
                         "loss_max_rel_err": loss_err,
                         "grad_max_rel_err": grad_err,
                         "grad_sets": len(ga),
                         "tol": {"loss": loss_rtol, "grad": grad_rtol}},
        "iteration": {"updates": len(tape.calls),
                      "update_rel_distance": dist,
                      "aux": {k: v[1] for k, v in runs.items()},
                      "tol": update_rtol}}
    gates[f"b_{name}_first_update"] = (loss_err <= loss_rtol
                                       and grad_err <= grad_rtol)
    gates[f"b_{name}_iteration"] = max(dist.values()) <= update_rtol


def _leaves_on(tree, device) -> bool:
    import torch

    from ray_tpu_torch.rl.core import tree_leaves

    return all(t.device.type == torch.device(device).type
               for t in tree_leaves(tree))


def _tree_changed(a, b) -> bool:
    import torch

    from ray_tpu_torch.rl.core import tree_leaves

    return any(not torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _iteration_rows(results, updates, steps_per_iter):
    """Each iteration's wall split into sampling and learning (an offline
    trainer's whole iteration is learning), env steps/s and ms an update
    (learning time over the iteration's `updates`)."""
    rows = []
    for r, ups in zip(results, updates):
        row = {"wall_s": r["time_this_iter_s"],
               "sample_s": r.get("sample_time_s"),
               "learn_s": r.get("learn_time_s", r["time_this_iter_s"]),
               "timesteps_total": r.get("timesteps_total"),
               "updates": ups}
        if row["sample_s"]:
            row["env_steps_per_s"] = steps_per_iter / row["sample_s"]
        if row["updates"]:
            row["ms_per_update"] = row["learn_s"] * 1e3 / row["updates"]
        rows.append(row)
    return rows


def _transitions(buffer, workers: int, fragment: int):
    """A replay buffer's rows in time order per worker (the buffer holds
    each iteration's fragments worker after worker): the offline
    trainers' dataset."""
    import numpy as np

    n = len(buffer)
    order = np.arange(n).reshape(-1, workers, fragment)
    order = np.concatenate([order[:, w].ravel() for w in range(workers)])
    return {k: v[:n][order].copy() for k, v in buffer._storage.items()}


def _sweep_one(name, device, dqn_data):
    """One train() on `device` of algorithm `name` at its config's defaults
    but learning_starts (one fragment) and the env (the fixtures above);
    Ape-X trains again (at most 5 times) until its replay lands and an
    update runs, as the reference's own test does."""
    import numpy as np

    from ray_tpu_torch import rl
    from ray_tpu_torch.rl.core import to_host, tree_leaves

    import ray_tpu_torch

    cfg_cls, tr_cls = rl.get_algorithm(name)
    kw = {"device": device, "seed": 0}
    if name in ("TD3", "DDPG", "ApexDDPG"):
        kw["env"] = "chip_smoke:Pendulum"
    elif name in ("ApexDQN", "SimpleQ", "R2D2"):
        kw["env"] = "chip_smoke:CartPole"
    if "env" in kw:
        kw["env_config"] = RLO_ENV_CONFIG
    if name == "R2D2":
        kw["learning_starts"] = cfg_cls.seqs_per_worker
    elif "env" in kw:
        kw["learning_starts"] = cfg_cls.rollout_fragment_length
    elif name == "BC":
        kw["dataset"] = {k: dqn_data[k] for k in ("obs", "actions")}
    elif name == "MARWIL":
        kw["dataset"] = {k: dqn_data[k] for k in ("obs", "actions",
                                                  "rewards", "dones")}
    else:
        kw["dataset"] = dqn_data
    t0 = time.perf_counter()
    tr = tr_cls(cfg_cls(**kw))
    out = {"start_s": time.perf_counter() - t0}
    try:
        actors = list(getattr(tr, "workers", [])) + list(
            getattr(tr, "shards", []))
        where = ray_tpu_torch.get([a.placement.remote() for a in actors])
        w0 = to_host(tr.get_weights())
        out["learner_on_device"] = _leaves_on(tr.get_weights(), device)
        out["actors_without_cuda"] = all(not w["cuda_available"]
                                         for w in where)
        out["actors"] = len(actors)
        t0 = time.perf_counter()
        for out["train_calls"] in range(1, 6):
            r = tr.train()
            if not name.startswith("Apex") or r["updates_this_iter"]:
                break
        out["train_s"] = time.perf_counter() - t0
        out["result"] = r
        nums = [v for v in r.values() if isinstance(v, float)]
        out["finite"] = bool(np.isfinite(nums).all())
        out["weights_moved"] = _tree_changed(w0, tr.get_weights())
        out["n_params"] = sum(t.numel() for t in tree_leaves(w0))
    finally:
        tr.stop()
    out["ok"] = all(out[k] for k in ("learner_on_device",
                                     "actors_without_cuda", "finite",
                                     "weights_moved"))
    return out


def phase_rl_offpolicy(device="cuda"):
    """The RL layer's off-policy and offline learners (``ray_tpu_torch.rl``
    DQN, SAC, CQL and the sweep) in a session of
    ``ray_tpu_torch.init(num_cpus=8)``, the learners on `device` in f32
    (TF32 off), the rollout and replay actors on the CPU
    (``CPU_WORKER_ENV``), the fixtures' action spaces seeded
    (RLO_ENV_CONFIG), every trainer at its reference config's defaults:
    1. SAC on ``chip_smoke:Pendulum``, 1 actor x 100 steps, learning
       after 500, batch 128, 32 updates an iteration, hidden 128, lr 3e-4
       x3, tau 0.005, RLO_SAC_ITERS iterations (5 of random actions, then
       the actor's; updates from the 5th iteration on, once the buffer
       holds 500);
    2. DQN on ``chip_smoke:CartPole``, 2 actors x 50 steps, learning after
       500, batch 64, 32 updates, hidden 64, double and dueling, the
       target synced every 500 steps, RLO_DQN_ITERS iterations;
    3. CQL on the SAC run's 1,000 transitions, RLO_CQL_ITERS iterations
       (act_high 2, Pendulum's);
    4. one train() (that updates) of each of RLO_SWEEP on the card: the
       online ones on the fixtures learning after one fragment, BC, CRR,
       MARWIL and DT on the DQN run's transitions.
    The launch counters are zeroed just before 1 and read after 4. Gates:
    (a) every learner leaf on `device`, every rollout and replay actor
    without CUDA; (b) ``_rlo_card_vs_cpu`` for SAC, DQN and CQL (the first
    updating iteration's updates, recorded); (c) each iteration's
    timesteps, finite losses, alpha and Q values once updates run, DQN's
    target changed at its syncs and only there, each sweep trainer's
    finite metrics and moved weights, no process left after
    ``shutdown()``; (d) no kernel launched. Information: each iteration's
    wall, sampling and learning time, env steps/s, ms an update against
    its operations bound, a profiled SAC learn window (one iteration's
    recorded updates) with its idle share and top kernels, peak memory.
    `device` "cpu" rehearses it on the CPU (gate (b) compares the CPU with
    itself there)."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.rl import dqn, offline, sac
    from ray_tpu_torch.rl.core import Adam, to_host

    _free_device()
    _checkout_on_pythonpath()
    on_card = device == "cuda"
    res = {"cfg": f"SAC on chip_smoke:Pendulum ({RLO_SAC_ITERS} "
                  f"iterations), DQN on chip_smoke:CartPole ("
                  f"{RLO_DQN_ITERS}), CQL on SAC's transitions ("
                  f"{RLO_CQL_ITERS}), one train() each of "
                  f"{', '.join(RLO_SWEEP)}; the configs' defaults, f32 "
                  f"learners on {device} (TF32 off)"}
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=8)
    res["init_s"] = time.perf_counter() - t0
    pids = {p.pid: "daemon" for p in info["procs"]}
    gates = {}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        sac_cfg = sac.SACConfig(env="chip_smoke:Pendulum",
                                env_config=RLO_ENV_CONFIG, device=device)
        dqn_cfg = dqn.DQNConfig(env="chip_smoke:CartPole",
                                env_config=RLO_ENV_CONFIG, device=device)
        t0 = time.perf_counter()
        s_tr, d_tr = sac.SACTrainer(sac_cfg), dqn.DQNTrainer(dqn_cfg)
        res["trainers_start_s"] = time.perf_counter() - t0
        first_sac = sac_cfg.learning_starts // (
            sac_cfg.num_rollout_workers * sac_cfg.rollout_fragment_length) - 1
        first_dqn = dqn_cfg.learning_starts // (
            dqn_cfg.num_rollout_workers * dqn_cfg.rollout_fragment_length) - 1
        s_tape = _UpdateTape(s_tr, 6, {first_sac})
        d_tape = _UpdateTape(d_tr, 3, {first_dqn})
        where = ray_tpu_torch.get([w.placement.remote()
                                   for w in s_tr.workers + d_tr.workers])
        res["rollout_actors"] = where
        gates["a_sac_dqn_learners_on_device"] = _leaves_on(
            [s_tr.nets, s_tr.target_q, s_tr.log_alpha, d_tr.net,
             d_tr.target], device)
        gates["a_actors_without_cuda"] = all(not w["cuda_available"]
                                             for w in where)
        _reset_all_launches()
        t_path = time.perf_counter()

        # 1. SAC
        s_res = [s_tr.train() for _ in range(RLO_SAC_ITERS)]
        # 2. DQN, the target net watched at every iteration
        d_res, changed, equal = [], [], []
        for _ in range(RLO_DQN_ITERS):
            before = to_host(d_tr.target)
            d_res.append(d_tr.train())
            changed.append(_tree_changed(before, d_tr.target))
            equal.append(not _tree_changed(d_tr.target, d_tr.net))
        # 3. CQL on SAC's transitions
        sac_data = _transitions(s_tr.buffer, sac_cfg.num_rollout_workers,
                                sac_cfg.rollout_fragment_length)
        dqn_data = _transitions(d_tr.buffer, dqn_cfg.num_rollout_workers,
                                dqn_cfg.rollout_fragment_length)
        cql_cfg = offline.CQLConfig(dataset=sac_data, act_high=2.0,
                                    device=device)
        c_tr = offline.CQLTrainer(cql_cfg)
        gates["a_cql_learner_on_device"] = _leaves_on(
            [c_tr.nets, c_tr.target_q], device)
        c_tape = _UpdateTape(c_tr, 4, set(range(RLO_CQL_ITERS)))
        c_res = [c_tr.train() for _ in range(RLO_CQL_ITERS)]
        # 4. the sweep
        sweep = {}
        for name in RLO_SWEEP:
            sweep[name] = _sweep_one(name, device, dqn_data)
        res["path_s"] = time.perf_counter() - t_path
        res["launches"] = _all_launches()
        t_down = time.perf_counter()
        res["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None)
        pids.update(session_pids(pids))
        s_tr.stop()
        d_tr.stop()
    finally:
        ray_tpu_torch.shutdown()
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    gates["c_no_process_left"] = not res["pids_alive_after_shutdown"]
    res["shutdown_s"] = time.perf_counter() - t_down

    # (c) progress
    steps = {"sac": sac_cfg.num_rollout_workers
             * sac_cfg.rollout_fragment_length,
             "dqn": dqn_cfg.num_rollout_workers
             * dqn_cfg.rollout_fragment_length}
    gates["c_timesteps"] = all(
        r["timesteps_total"] == (i + 1) * steps[k]
        for k, rs in (("sac", s_res), ("dqn", d_res))
        for i, r in enumerate(rs))
    upd_sac = [r for r in s_res if "critic_loss" in r]
    upd_dqn = [r for r in d_res if r["num_updates"]]
    gates["c_updates_ran"] = (
        len(upd_sac) == RLO_SAC_ITERS - first_sac
        and len(upd_dqn) == RLO_DQN_ITERS - first_dqn)
    last_mb = s_tape.calls[-1][0]
    with torch.no_grad():
        q_sac = float(sac.q_value(s_tr.nets["q1"], *(
            last_mb[k].to(device) for k in ("obs", "actions"))).mean())
        q_dqn = float(dqn.q_forward(d_tr.net, d_tape.calls[-1][0][
            "obs"].to(device)).mean())
        q_cql = float(sac.q_value(c_tr.nets["q1"], *(
            c_tape.calls[-1][0][k].to(device)
            for k in ("obs", "actions"))).mean())
    res["q_mean"] = {"sac": q_sac, "dqn": q_dqn, "cql": q_cql}
    gates["c_finite"] = bool(np.isfinite(
        [r[k] for r in upd_sac for k in ("critic_loss", "actor_loss",
                                         "alpha")]
        + [r["loss"] for r in upd_dqn]
        + [r[k] for r in c_res for k in ("loss", "bellman_loss",
                                         "cql_penalty", "actor_loss")]
        + [q_sac, q_dqn, q_cql]).all()) and all(
            r["alpha"] > 0 for r in upd_sac)
    since, want = 0, []
    for r in d_res:
        since += steps["dqn"]
        hit = r["num_updates"] > 0 and since >= \
            dqn_cfg.target_network_update_freq
        want.append(hit)
        since = 0 if hit else since
    res["dqn_target"] = {"changed": changed, "sync_expected": want}
    gates["c_dqn_target_syncs"] = changed == want and any(want) and all(
        e for e, w in zip(equal, want) if w)
    res["sweep"] = sweep
    gates["a_c_sweep"] = all(v["ok"] for v in sweep.values())
    gates["d_no_kernel_launched"] = not any(res["launches"].values())

    # information: each iteration and the updates' operations bound
    res["iterations"] = {
        "sac": _iteration_rows(s_res, [
            sac_cfg.updates_per_iter * ("critic_loss" in r) for r in s_res],
            steps["sac"]),
        "dqn": _iteration_rows(d_res, [r["num_updates"] for r in d_res],
                               steps["dqn"]),
        "cql": _iteration_rows(c_res, [cql_cfg.updates_per_iter] * len(
            c_res), 0)}
    res["results_last"] = {"sac": s_res[-1], "dqn": d_res[-1],
                           "cql": c_res[-1]}
    flop = {"sac": _rlo_update_flop("sac", sac_cfg, 3, 1),
            "dqn": _rlo_update_flop("dqn", dqn_cfg, 4, 2),
            "cql": _rlo_update_flop("cql", cql_cfg, 3, 1)}
    res["update_gflop"] = {k: v / 1e9 for k, v in flop.items()}
    res["update_bound_ms"] = {k: bound(0, v, "float32")[0]
                              for k, v in flop.items()}

    # the profiled learn window: SAC's recorded iteration on the card
    t0 = time.perf_counter()
    if on_card:
        step = _rlo_stepper("sac", s_tr, Adam)[0]
        st0 = _tree_to(s_tape.state0, device)
        calls = [_tree_to(c, device) for c in s_tape.calls]

        def window():
            st = _tree_to(st0, device)
            for call in calls:
                st, aux = step(st, call)
            torch.cuda.synchronize()
        prof = device_profile(window, window)
        prof["ms_per_update"] = prof["wall_ms"] / len(calls)
        res["profile_sac_learn"] = prof

    res["profile_s"] = time.perf_counter() - t0

    # (b) card vs CPU
    t0 = time.perf_counter()
    for name, tr, tape in (("sac", s_tr, s_tape), ("dqn", d_tr, d_tape),
                           ("cql", c_tr, c_tape)):
        res[name] = {}
        _rlo_card_vs_cpu(name, tr, tape, device, res[name], gates)
    res["card_vs_cpu_s"] = time.perf_counter() - t0
    res["gates"] = gates
    res["ok"] = all(gates.values())
    return res


# --- the RL layer's last five algorithms -----------------------------------

# iterations of each trainer in the rl_final phase: past learning_starts,
# then two updating iterations (QMIX updates from its first iteration and
# SlateQ from its third; both run on to their first target sync, QMIX's at
# 256 sampled steps, SlateQ's at 400)
RLF_ITERS = {"qmix": 4, "maddpg": 4, "maml": 2, "alphazero": 2,
             "slateq": 5}
# card vs CPU, f32 with TF32 off, on the first updating iteration's first
# update from the same state and minibatch: each loss term within
# RLF_LOSS_RTOL of the CPU's, each gradient leaf within RLF_GRAD_RTOL of
# its largest element. Then the iteration's updates on the card in f32, the
# CPU in f32 and the card in f64 pairwise within RLF_UPDATE_RTOL of the
# update's norm (f32 rounding over at most 16 Adam steps of MLPs up to 64
# wide; a learner computing anything else lands ~1 of the norm away)
RLF_LOSS_RTOL = 1e-6
RLF_GRAD_RTOL = 1e-6
RLF_UPDATE_RTOL = 1e-4


def _rlf_stepper(name: str, tr, opt_cls):
    """``_rlo_stepper``'s contract for the rl_final learners: (step(state,
    call) -> (state, aux), the optimizers, the trainable part of a
    state), with fresh optimizers of `opt_cls` at the config's rates."""
    from ray_tpu_torch.rl import alpha_zero, maddpg, maml, qmix, slateq
    from ray_tpu_torch.rl.core import make_update
    from ray_tpu_torch.rl.dqn import make_q_update

    cfg = tr.config
    if name in ("qmix", "slateq"):
        opts = [opt_cls(cfg.lr)]
        loss = (qmix.make_qmix_loss(cfg.gamma, cfg.double_q)
                if name == "qmix" else slateq.make_slateq_loss(
                    cfg.gamma, tr.slate_size, tr.null_bias))
        upd = make_q_update(loss, opts[0])

        def step(st, call):
            net, os_, loss_, _ = upd(st[0], st[1], st[2], *call)
            return [net, st[1], os_], {"loss": loss_}
        return step, opts, lambda st: st[0]
    if name == "maddpg":
        opts = [opt_cls(cfg.actor_lr), opt_cls(cfg.critic_lr)]
        upd = maddpg.make_maddpg_update(tr.obs_dims, tr.act_dims, cfg.gamma,
                                        cfg.tau, *opts)

        def step(st, call):
            out = upd(*st, *call)
            return list(out[:4]), {"critic_loss": out[4],
                                   "actor_loss": out[5]}
        return step, opts, lambda st: {"nets": st[0], "target": st[1]}
    if name == "alphazero":
        opts = [opt_cls(cfg.lr)]
        upd = make_update(alpha_zero.az_loss, opts[0])

        def step(st, call):
            net, os_, aux = upd(st[0], st[1], *call)
            return [net, os_], aux
        return step, opts, lambda st: st[0]
    opts = [opt_cls(cfg.meta_lr)]
    upd = maml.make_meta_update(opts[0], cfg.inner_lr)

    def step(st, call):
        p, os_, loss_ = upd(st[0], st[1], *call)
        return [p, os_], {"meta_loss": loss_}
    return step, opts, lambda st: st[0]


def _rlf_first_update(cfg) -> int:
    """The first iteration (0-based) whose sampling fills the replay to
    `cfg.learning_starts`; 0 for a trainer that updates from the start."""
    if not hasattr(cfg, "learning_starts"):
        return 0
    per_iter = cfg.num_rollout_workers * cfg.rollout_fragment_length
    return max(0, -(-cfg.learning_starts // per_iter) - 1)


def _rlf_learner(name, tr):
    """The learner's trees (params and targets) of trainer `tr`."""
    return {"qmix": lambda: [tr.nets, tr.target],
            "maddpg": lambda: [tr.nets, tr.target],
            "slateq": lambda: [tr.net, tr.target],
            "alphazero": lambda: [tr.net],
            "maml": lambda: [tr.params]}[name]()


def _maml_first_order_update(opt, inner_lr):
    """``maml.make_meta_update``'s step with each task's inner gradient a
    constant (first-order MAML): the yardstick for what the second-order
    term costs. Built here from ``pg_loss``; the port has no such mode."""
    import torch

    from ray_tpu_torch.rl import maml
    from ray_tpu_torch.rl.core import (tree_leaves, tree_unflatten_like,
                                       value_and_grad)

    def adapt(p, pre):
        leaves = tree_leaves(p)
        inner = torch.autograd.grad(maml.pg_loss(p, pre), leaves)
        return tree_unflatten_like(
            p, [x - inner_lr * g for x, g in zip(leaves, inner)])

    def total(p, pres, posts):
        losses = [maml.pg_loss(adapt(p, pre), post)
                  for pre, post in zip(pres, posts)]
        return sum(losses) / len(losses), {}

    def update(params, opt_state, pres, posts):
        if opt_state is None:
            opt_state = opt.init(params)
        (loss, _), grads = value_and_grad(total, params, pres, posts)
        opt.step(params, grads, opt_state)
        return params, opt_state, loss
    return update


def _rlf_window(name, tr, tape, device, first_order=False):
    """A function that replays the tape's updates on `device` from its
    state (fresh Adam), and the number of updates it runs. `first_order`
    replays MAML's through ``_maml_first_order_update``."""
    import torch

    from ray_tpu_torch.rl.core import Adam

    if name == "maml" and first_order:
        upd = _maml_first_order_update(Adam(tr.config.meta_lr),
                                       tr.config.inner_lr)

        def step(st, call):
            p, os_, loss_ = upd(st[0], st[1], *call)
            return [p, os_], {"meta_loss": loss_}
    else:
        step = _rlf_stepper(name, tr, Adam)[0]
    st0 = _tree_to(tape.state0, device)
    calls = [_tree_to(c, device) for c in tape.calls]

    def window():
        st = _tree_to(st0, device)
        for call in calls:
            st, _ = step(st, call)
        if device == "cuda":
            torch.cuda.synchronize()
    return window, len(calls)


def phase_rl_final(device="cuda"):
    """The RL layer's last five algorithms (``ray_tpu_torch.rl`` QMIX,
    MADDPG, MAML, AlphaZero, SlateQ) in a session of
    ``ray_tpu_torch.init(num_cpus=8)``, each at its reference config's
    defaults (QMIX hidden 32, embed 16, batch 32, 16 updates; MADDPG hidden
    64, batch 128, 16 updates; MAML hidden 32, 2 tasks x 4 episodes;
    AlphaZero hidden 64, 25 simulations, batch 128, 16 updates; SlateQ
    hidden 64, batch 64, 16 updates) on its own numpy env, the learners on
    `device` in f32 (TF32 off), the rollout and self-play actors on the CPU
    (``CPU_WORKER_ENV``), for RLF_ITERS iterations each. The launch
    counters are zeroed just before the first train() and read after the
    last. Gates: (a) every learner leaf on `device`, every actor without
    CUDA; (b) the first updating iteration's first update card vs CPU
    (loss terms within RLF_LOSS_RTOL, gradients within RLF_GRAD_RTOL of
    each leaf's largest); (c) that iteration's updates, recorded, on the
    card in f32 against the CPU in f32 and the card in f64 within
    RLF_UPDATE_RTOL of the update's norm; (d) finite losses, moved
    weights, QMIX's and SlateQ's targets changed at their syncs and only
    there, MADDPG's target moved by exactly its polyak step (one recorded
    update replayed: the target after equals ``polyak_`` of the target
    before toward the nets after, bit for bit, and is not the nets);
    (e) no kernel launched, no process left after ``shutdown()``.
    Information: each iteration's sampling and learning time, ms per
    update, a profiled learn window per trainer (the recorded iteration
    replayed: idle share, kernels per update), MAML's meta-update against
    its first-order cost. `device` "cpu" rehearses it on the CPU (gates
    (b) and (c) compare the CPU with itself there)."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.rl import alpha_zero, maddpg, maml, qmix, slateq
    from ray_tpu_torch.rl.core import Adam, polyak_, to_host, tree_leaves

    _free_device()
    _checkout_on_pythonpath()
    on_card = device == "cuda"
    res = {"cfg": "QMIX on two_step_game, MADDPG on line_spread, MAML on "
                  "PointGoalEnv, AlphaZero on TicTacToe, SlateQ on "
                  "SlateRecEnv; the configs' defaults, f32 learners on "
                  f"{device} (TF32 off); iterations {RLF_ITERS}"}
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=8)
    res["init_s"] = time.perf_counter() - t0
    pids = {p.pid: "daemon" for p in info["procs"]}
    gates = {}
    # name: (trainer, the update attribute, its state arguments)
    kinds = {"qmix": (qmix.QMIXTrainer, qmix.QMIXConfig, "_update", 3),
             "maddpg": (maddpg.MADDPGTrainer, maddpg.MADDPGConfig,
                        "_update", 4),
             "maml": (maml.MAMLTrainer, maml.MAMLConfig, "_meta_update", 2),
             "alphazero": (alpha_zero.AlphaZeroTrainer,
                           alpha_zero.AlphaZeroConfig, "_update", 2),
             "slateq": (slateq.SlateQTrainer, slateq.SlateQConfig,
                        "_update", 3)}
    trs, tapes, results, w0, syncs, first = {}, {}, {}, {}, {}, {}
    try:
        t0 = time.perf_counter()
        for name, (tr_cls, cfg_cls, attr, n_state) in kinds.items():
            trs[name] = tr_cls(cfg_cls(device=device))
            first[name] = _rlf_first_update(trs[name].config)
            tapes[name] = _UpdateTape(trs[name], n_state, {first[name]},
                                      attr)
        res["trainers_start_s"] = time.perf_counter() - t0
        where = ray_tpu_torch.get([w.placement.remote() for tr in
                                   trs.values() for w in tr.workers])
        res["rollout_actors"] = len(where)
        gates["a_learners_on_device"] = all(
            _leaves_on(_rlf_learner(n, tr), device)
            for n, tr in trs.items())
        gates["a_actors_without_cuda"] = all(not w["cuda_available"]
                                             for w in where)
        for name, tr in trs.items():
            w0[name] = to_host(tr.get_weights())
        _reset_all_launches()
        t_path = time.perf_counter()
        for name, tr in trs.items():
            results[name], syncs[name] = [], []
            for _ in range(RLF_ITERS[name]):
                before = (to_host(tr.target) if name in ("qmix", "slateq")
                          else None)
                results[name].append(tr.train())
                if before is not None:
                    syncs[name].append(_tree_changed(before, tr.target))
        res["path_s"] = time.perf_counter() - t_path
        res["launches"] = _all_launches()
        res["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None)
        gates["d_weights_moved"] = all(
            _tree_changed(w0[n], tr.get_weights()) for n, tr in trs.items())
        pids.update(session_pids(pids))
        t_down = time.perf_counter()
        for tr in trs.values():
            tr.stop()
    finally:
        ray_tpu_torch.shutdown()
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    gates["e_no_process_left"] = not res["pids_alive_after_shutdown"]
    gates["e_no_kernel_launched"] = not any(res["launches"].values())
    res["shutdown_s"] = time.perf_counter() - t_down

    # (d) progress
    loss_keys = {"qmix": ("loss",), "maddpg": ("critic_loss", "actor_loss"),
                 "maml": ("meta_loss",),
                 "alphazero": ("loss", "pi_loss", "v_loss"),
                 "slateq": ("loss",)}
    vals, updated, n_updates = [], {}, {}
    for name, rs in results.items():
        # AlphaZero and MAML update in every iteration and report no count
        n_updates[name] = [r["num_updates"] if "num_updates" in r else (
            trs[name].config.updates_per_iter if name == "alphazero" else 1)
            for r in rs]
        updated[name] = [i for i, u in enumerate(n_updates[name]) if u]
        vals += [r[k] for r in rs[first[name]:] for k in loss_keys[name]]
    res["first_updating_iteration"] = first
    gates["d_updates_ran"] = all(
        updated[n] == list(range(first[n], RLF_ITERS[n])) for n in results)
    gates["d_finite"] = bool(np.isfinite(vals).all())
    res["targets"] = {}
    for name in ("qmix", "slateq"):
        cfg = trs[name].config
        per = cfg.num_rollout_workers * cfg.rollout_fragment_length
        since, want = 0, []
        for r in results[name]:
            since += per
            hit = r["num_updates"] > 0 and \
                since >= cfg.target_network_update_freq
            want.append(hit)
            since = 0 if hit else since
        res["targets"][name] = {"changed": syncs[name],
                                "sync_expected": want,
                                "steps_per_iter": per}
        gates[f"d_{name}_target_syncs"] = syncs[name] == want and any(want)

    # MADDPG's target after one recorded update: exactly its polyak step
    tape = tapes["maddpg"]
    step = _rlf_stepper("maddpg", trs["maddpg"], Adam)[0]
    st = _tree_to(tape.state0, device)
    want = _tree_to(st[1], device)
    st, _ = step(st, _tree_to(tape.calls[0], device))
    polyak_(want, st[0], trs["maddpg"].config.tau)
    gates["d_maddpg_polyak_exact"] = (
        all(torch.equal(a, b) for a, b in zip(tree_leaves(st[1]),
                                              tree_leaves(want)))
        and _tree_changed(st[1], st[0]))

    # information: each iteration, the profiled learn windows
    env_steps = {n: (tr.config.num_rollout_workers
                     * tr.config.rollout_fragment_length
                     if hasattr(tr.config, "rollout_fragment_length") else 0)
                 for n, tr in trs.items()}
    env_steps["maml"] = (2 * trs["maml"].config.num_rollout_workers
                         * trs["maml"].config.episodes_per_task
                         * maml.PointGoalEnv.H)
    res["iterations"] = {n: _iteration_rows(rs, n_updates[n], env_steps[n])
                         for n, rs in results.items()}
    res["results_last"] = {n: rs[-1] for n, rs in results.items()}
    t0 = time.perf_counter()
    if on_card:
        res["profile_learn"] = {}
        for name, tr in trs.items():
            window, n = _rlf_window(name, tr, tapes[name], device)
            prof = device_profile(window, window)
            prof["updates"] = n
            prof["ms_per_update"] = prof["wall_ms"] / n
            prof["kernels_per_update"] = prof["device_events"] / n
            res["profile_learn"][name] = prof
        fo, n = _rlf_window("maml", trs["maml"], tapes["maml"], device,
                            first_order=True)
        so, _ = _rlf_window("maml", trs["maml"], tapes["maml"], device)
        res["maml_meta_update_ms"] = {"second_order": cuda_ms(so, 5) / n,
                                      "first_order": cuda_ms(fo, 5) / n}
    res["profile_s"] = time.perf_counter() - t0

    # (b), (c) card vs CPU
    t0 = time.perf_counter()
    for name, tr in trs.items():
        res[name] = {}
        _rlo_card_vs_cpu(name, tr, tapes[name], device, res[name], gates,
                         stepper=_rlf_stepper, loss_rtol=RLF_LOSS_RTOL,
                         grad_rtol=RLF_GRAD_RTOL,
                         update_rtol=RLF_UPDATE_RTOL)
        gates[f"c_{name}_f32_vs_f64"] = gates.pop(f"b_{name}_iteration")
    res["card_vs_cpu_s"] = time.perf_counter() - t0
    res["gates"] = gates
    res["ok"] = all(gates.values())
    return res


# --- tune: an ASHA sweep of GPT-2 125M on the card -------------------------

TUNE_LRS = (1e-4, 1e-3)
TUNE_MAX_T = 8
TUNE_FIRST_LOSS_RTOL = 1e-5
# a trial's reading of the card's use at its start (mem_get_info): over the
# driver's by its own CUDA context (about 0.5 GB) at most TUNE_CONTEXT_GB;
# every trial within TUNE_CARD_USED_MARGIN_GB of the first, less than one
# context, so no earlier trial's process still held the card
TUNE_CONTEXT_GB = 1.0
TUNE_CARD_USED_MARGIN_GB = 0.25


def _tune_gpt2_trial(config):
    """A tune trial: GPT-2 `preset` (bf16 compute, f32 params) from seed 0
    on `device` (CUDA unless "cpu"), ``make_train_step`` with
    ``adamw(lr, weight_decay=0.01)``, one batch of seeded tokens (seed 7,
    [B, S + 1]), ``tune.report({"loss", "step_ms", ...})`` after every
    step, the first report also carrying where the trial ran: its pid, the
    card memory it found in use, whether every param is on the device,
    its timestamps (entry, the process's age then, imports done, CUDA
    ready, params drawn). The card is freed however the trial ends."""
    import os

    t_enter = time.time()
    with open("/proc/self/stat") as f, open("/proc/uptime") as g:
        age = float(g.read().split()[0]) - int(
            f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf(
                "SC_CLK_TCK")
    import numpy as np
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    start = {"pid": os.getpid(), "t_enter": t_enter,
             "process_age_at_entry_s": age, "t_imported": time.time()}
    dev = torch.device(config["device"] or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        free, total = torch.cuda.mem_get_info(dev)
        start.update(card_used_at_start_gb=(total - free) / 1e9,
                     current_device=torch.cuda.current_device())
    start["t_device_ready"] = time.time()
    cfg = gpt2.PRESETS[config["preset"]]
    init, _ = ts.make_train_state_init(
        lambda g: gpt2.init_params(g, cfg),
        ts.adamw(config["lr"], weight_decay=0.01), device=dev)
    state = init(0)
    B, S = config["batch"]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device=dev)}
    step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg))
    start["params_on_device"] = all(t.device.type == dev.type
                                    for t in ts._leaves(state.params))
    _reset_all_launches()
    start["t_init_done"] = time.time()
    try:
        for i in range(config["steps"]):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            rep = {"loss": float(m["loss"]),      # waits for the step
                   "step_ms": (time.perf_counter() - t0) * 1e3,
                   "launches": _all_launches()}
            tune.report({**rep, **start} if i == 0 else rep)
    finally:
        del state
        if cuda:
            torch.cuda.empty_cache()


class _RecordingScheduler:
    """A scheduler that logs each (trial, result, decision) it makes, in
    the order the tuner asks."""

    def __init__(self, inner):
        self.inner, self.log = inner, []
        self.metric = inner.metric

    def on_result(self, trial_id, result):
        d = self.inner.on_result(trial_id, result)
        self.log.append((trial_id, dict(result), d))
        return d


def _gpt2_first_loss(preset, batch, lr, device):
    """The trial's first step run here: its loss."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt2.PRESETS[preset]
    init, _ = ts.make_train_state_init(
        lambda g: gpt2.init_params(g, cfg),
        ts.adamw(lr, weight_decay=0.01), device=device)
    state = init(0)
    B, S = batch
    b = {"tokens": torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + 1)), device=device)}
    _, m = ts.make_train_step(lambda p, x: gpt2.loss_fn(p, x, cfg))(state, b)
    return float(m["loss"])


def phase_tune(device="cuda", preset="125m", batch=(8, 1024)):
    """``ray_tpu_torch.tune``: a ``Tuner`` over ``_tune_gpt2_trial`` (GPT-2
    `preset` at full width, the trainer phase's batch and sequence), the
    sweep ``lr`` in TUNE_LRS under ``ASHAScheduler(metric="loss",
    mode="min", max_t=TUNE_MAX_T, grace_period=2, reduction_factor=2)``,
    each trial asking for ``{"CPU": 1, "GPU": 1}`` (on the CPU, for a
    rehearsal, ``{"CPU": 1}``), ``max_concurrent_trials=1`` (the controller
    launches up to that many trial actors whatever their resources and
    polls each with a 30 s timeout: a trial waiting that long for the one
    card would be reported lost), the CSV and JSON logger callbacks, in a
    session of ``ray_tpu_torch.init(num_cpus=8)``. The launch counts are
    the trials' own (all six read in their processes, zeroed at their
    start). Gates: (a) every trial's params on the device, and (on the
    card) the card's device-wide use at each trial's start no more than
    the driver's before ``fit()`` plus one CUDA context (TUNE_CONTEXT_GB)
    and within TUNE_CARD_USED_MARGIN_GB of the first trial's; (b) trial 0's first-step loss
    within TUNE_FIRST_LOSS_RTOL of the same step run here first; (c) the
    recorded reports replayed in their order through a fresh
    ``ASHAScheduler`` give the same decisions, each trial stopped at a rung
    has fewer than max_t reports and every other trial max_t; (d)
    ``get_best_result()`` is the trial with the lowest last loss; (e) the
    CSV and JSON files hold every report; (f) no error, no kernel launched,
    no process left after ``shutdown()``. Information: the sweep's wall
    time, each trial's start (from the previous trial's last report to
    its entry: the actor's start), init and first step, its steady ms per
    step against the trainer phase's, and the share of the sweep's wall
    time outside the trials' steps (host clock: 1 - the steps' summed
    host-timed ms over the sweep's wall time; not a device idle share)."""
    import csv
    import statistics
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.train import RunConfig

    _free_device()
    _checkout_on_pythonpath()
    on_card = device == "cuda"
    res = {"cfg": f"gpt2 {preset} batch {list(batch)}, lr in {TUNE_LRS}, "
                  f"ASHA max_t {TUNE_MAX_T} grace 2 rf 2, one trial at a "
                  f"time, on {device}"}
    gates = {}
    t0 = time.perf_counter()
    want_loss = _gpt2_first_loss(preset, batch, TUNE_LRS[0], device)
    res["driver_first_loss"] = want_loss
    res["driver_first_step_s"] = time.perf_counter() - t0
    _free_device()
    asha = dict(metric="loss", mode="min", max_t=TUNE_MAX_T,
                grace_period=2, reduction_factor=2)
    sched = _RecordingScheduler(tune.ASHAScheduler(**asha))
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=8)
    res["init_s"] = time.perf_counter() - t0
    pids = {p.pid: "daemon" for p in info["procs"]}
    if on_card:
        import torch

        free, total = torch.cuda.mem_get_info()
        res["driver_card_used_before_fit_gb"] = (total - free) / 1e9
    try:
        t_fit = time.time()
        t0 = time.perf_counter()
        grid = tune.Tuner(
            _tune_gpt2_trial,
            param_space={"lr": tune.grid_search(list(TUNE_LRS)),
                         "preset": preset, "batch": list(batch),
                         "steps": TUNE_MAX_T,
                         "device": None if on_card else "cpu"},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", scheduler=sched,
                max_concurrent_trials=1,
                resources_per_trial=({"CPU": 1, "GPU": 1} if on_card
                                     else {"CPU": 1})),
            run_config=RunConfig(
                name="gpt2_asha", storage_path=root,
                callbacks=[tune.CSVLoggerCallback(),
                           tune.JsonLoggerCallback()])).fit()
        res["sweep_s"] = time.perf_counter() - t0
        trials = list(grid)
        pids.update({h[0]["pid"]: "trial" for h in
                     (t.metrics_history for t in trials) if h})
        pids.update(session_pids(pids))
        t_down = time.perf_counter()
    finally:
        ray_tpu_torch.shutdown()
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    res["shutdown_s"] = time.perf_counter() - t_down
    res["errors"] = [t.error for t in trials if t.error]
    firsts = [t.metrics_history[0] for t in trials if t.metrics_history]
    res["launches"] = {}
    for t in trials:
        for k, v in (t.metrics_history[-1].get("launches") or {}).items():
            res["launches"][k] = res["launches"].get(k, 0) + v

    # (a)
    gates["a_params_on_device"] = len(firsts) == len(TUNE_LRS) and all(
        f["params_on_device"] for f in firsts)
    if on_card:
        used = [f["card_used_at_start_gb"] for f in firsts]
        gates["a_card_free_at_each_start"] = bool(used) and all(
            f["current_device"] == 0 for f in firsts) and (
            used[0] <= res["driver_card_used_before_fit_gb"]
            + TUNE_CONTEXT_GB) and all(
            abs(u - used[0]) <= TUNE_CARD_USED_MARGIN_GB for u in used)
    # (b)
    got = firsts[0]["loss"] if firsts else float("nan")
    res["trial0_first_loss"] = got
    gates["b_first_loss_equals_driver"] = abs(got - want_loss) <= \
        TUNE_FIRST_LOSS_RTOL * abs(want_loss)
    # (c) the decisions replayed; the stopped trials and their rungs
    fresh = tune.ASHAScheduler(**asha)
    replay = [fresh.on_result(tid, r) for tid, r, _ in sched.log]
    gates["c_replay_same_decisions"] = replay == [d for _, _, d in
                                                  sched.log]
    stopped = {tid: r["training_iteration"] for tid, r, d in sched.log
               if d == "STOP" and r["training_iteration"] < TUNE_MAX_T}
    res["stopped_at_rung"] = stopped
    res["reports_per_trial"] = {t.trial_id: len(t.metrics_history)
                                for t in trials}
    gates["c_report_counts"] = all(
        (n < TUNE_MAX_T) if tid in stopped else (n == TUNE_MAX_T)
        for tid, n in res["reports_per_trial"].items())
    # (d)
    last = {t.trial_id: t.metrics_history[-1]["loss"] for t in trials
            if t.metrics_history}
    best = grid.get_best_result()
    res["best"] = {"trial_id": best.trial_id, "lr": best.config["lr"],
                   "last_loss": last.get(best.trial_id)}
    gates["d_best_is_lowest_last_loss"] = best.trial_id == min(
        last, key=last.get)
    # (e)
    run_dir = Path(root) / "gpt2_asha"
    files_ok = True
    for t in trials:
        d = run_dir / t.trial_id
        with open(d / "progress.csv") as f:
            rows = list(csv.DictReader(f))
        lines = (d / "result.json").read_text().splitlines()
        files_ok &= (len(rows) == len(lines) == len(t.metrics_history)
                     and [float(r["loss"]) for r in rows]
                     == [m["loss"] for m in t.metrics_history]
                     and [json.loads(x)["loss"] for x in lines]
                     == [m["loss"] for m in t.metrics_history])
    gates["e_logger_files_hold_every_report"] = files_ok
    # (f)
    gates["f_no_error"] = not res["errors"]
    gates["f_no_kernel_launched"] = not any(res["launches"].values())
    gates["f_no_process_left"] = not res["pids_alive_after_shutdown"]

    # information: each trial's start, init, first and steady steps
    rows, prev_end, busy = [], t_fit, 0.0
    for t in trials:
        h = t.metrics_history
        if not h:
            continue
        f = h[0]
        steps = [m["step_ms"] for m in h]
        busy += sum(steps) / 1e3
        rows.append({
            "trial_id": t.trial_id, "lr": t.config["lr"],
            "reports": len(h), "last_loss": h[-1]["loss"],
            "start_s": f["t_enter"] - prev_end,
            "process_age_at_entry_s": f["process_age_at_entry_s"],
            "imports_s": f["t_imported"] - f["t_enter"],
            "device_ready_s": f["t_device_ready"] - f["t_imported"],
            "params_init_s": f["t_init_done"] - f["t_device_ready"],
            "init_s": f["t_init_done"] - f["t_enter"],
            "first_step_ms": steps[0],
            "steady_ms_per_step": (statistics.median(steps[1:])
                                   if len(steps) > 1 else None),
            "card_used_at_start_gb": f.get("card_used_at_start_gb")})
        prev_end = h[-1]["_ts"]
    res["trials"] = rows
    res["host_share_outside_steps"] = 1 - busy / res["sweep_s"]
    trainer = RESULTS["phases"].get("trainer", {})
    if trainer.get("step_s_median"):
        res["trainer_ms_per_step"] = trainer["step_s_median"] * 1e3
    res["gates"] = gates
    res["ok"] = all(gates.values())
    return res


# --- the port's engine --------------------------------------------------------


# --- the operator surface: launcher, autoscaler, jobs, workflows -------------

# the ops phase's cluster (JSON, which parses without PyYAML): no GPU unit on
# the head, one autoscaled node type holding the card
OPS_IDLE_TIMEOUT_MIN = 0.1
OPS_MONITOR_INTERVAL_S = 2.0      # the monitor's interval under launcher.up
OPS_CLUSTER = {
    "cluster_name": "ops", "max_workers": 1,
    "idle_timeout_minutes": OPS_IDLE_TIMEOUT_MIN,
    "provider": {"type": "local"},
    "head_resources": {"CPU": 4, "GPU": 0},
    "available_node_types": {"gpu_node": {"resources": {"CPU": 2,
                                                        "GPU": 1}}},
}
OPS_PROMPT_LENS = (64, 192, 320, 512)
OPS_NEW_TOKENS = 32
OPS_TRAIN_LAYERS = 4
OPS_TRAIN_STEPS = 3
OPS_TIMEOUT_S = 600.0
# a Prometheus text exposition line: a sample, a comment or blank
_PROM_SAMPLE = (r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="
                r"\"[^\"]*\",?)*\})? [-+0-9.eEinfINFaN]+( [0-9]+)?$")


def _ops_prompts(V):
    import numpy as np

    rng = np.random.default_rng(11)
    return [rng.integers(0, V, size=n).tolist() for n in OPS_PROMPT_LENS]


def _ops_engine(device, preset, layers=None, params=None):
    """The paged engine of the ops phase: `preset` (its depth, or `layers`),
    flash prefill, page 64, 4 slots, max_seq 1024, seed 0; from `params`
    (a checkpoint's tree) where given."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.PRESETS[preset].replace(attn_impl="flash")
    if device == "cpu":
        cfg = cfg.replace(dtype=torch.float32)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    return LLMEngine(cfg=cfg, params=params, max_slots=4, max_seq_len=1024,
                     kv_layout="paged", page_size=64, seed=0, device=device)


def _ops_generate(eng, prompts):
    """The prompts greedily, OPS_NEW_TOKENS each, submitted at once and
    stepped (step_n(8)) to the end, every launch counter of this process
    set to 0 just before: (tokens, launches)."""
    import torch

    _reset_all_launches()
    reqs = [eng.submit(p, max_new_tokens=OPS_NEW_TOKENS) for p in prompts]
    while eng.has_work():
        eng.step_n(8)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return [r.generated for r in reqs], _all_launches()


class _OpsEngineActor:
    """The ops phase's serving actor (``num_gpus=1``): the 1b preset's
    paged engine built in a worker on the autoscaled node."""

    def __init__(self, device, preset):
        self.eng = _ops_engine(device, preset)

    def ping(self):
        import os

        return os.getpid()

    def serve(self, prompts):
        import os

        import ray_tpu_torch

        tokens, launches = _ops_generate(self.eng, prompts)
        return {"tokens": tokens, "launches": launches, "pid": os.getpid(),
                "node": ray_tpu_torch.get_runtime_context().get_node_id()}


def _ops_job_main(device="cuda", preset="1b", batch=(8, 1024), loop=False):
    """A job's entrypoint (``python3 -c 'import chip_smoke;
    chip_smoke._ops_job_main()'``): the trainer phase's Llama recipe cut to
    OPS_TRAIN_LAYERS for OPS_TRAIN_STEPS steps, printing one ``OPS_JOB``
    JSON line (losses, launches, pid); with `loop`, its pid first and then
    step after step until it is stopped, a loss line each."""
    import os

    layers = min(OPS_TRAIN_LAYERS, _preset_layers(preset))
    if not loop:
        losses, launches = _trainer_llama_run(device, preset, layers,
                                              tuple(batch), OPS_TRAIN_STEPS)
        print("OPS_JOB " + json.dumps({"losses": losses,
                                       "launches": launches,
                                       "pid": os.getpid()}), flush=True)
        return
    print(f"OPS_JOB_PID {os.getpid()}", flush=True)
    for i in range(10_000):
        losses, _ = _trainer_llama_run(device, preset, layers, tuple(batch),
                                       1)
        print(f"OPS_JOB_LOSS {i} {losses[0]}", flush=True)


def _preset_layers(preset):
    from ray_tpu_torch.models import llama

    return llama.PRESETS[preset].n_layers


def _ops_wf_train(storage, device, preset, batch):
    """The workflow's step ``train``: the 4-layer recipe for 3 steps, its
    params saved as a DCP checkpoint under the workflow's storage; returns
    the checkpoint's path, its digest and this run's launches (no tensor:
    a pickled CUDA tensor would load onto the card of whatever process
    reads it). Each run appends to ``train_runs`` beside it."""
    import os

    from ray_tpu_torch.train.checkpoint import Checkpoint

    with open(os.path.join(storage, "train_runs"), "a") as f:
        f.write(f"{os.getpid()}\n")
    layers = min(OPS_TRAIN_LAYERS, _preset_layers(preset))
    losses, launches, state = _llama_train(device, preset, layers,
                                           tuple(batch), OPS_TRAIN_STEPS)
    path = os.path.join(storage, "ckpt")
    Checkpoint.from_state({"params": state.params}, path)
    return {"path": path, "digest": _params_digest(state.params),
            "launches": launches, "losses": losses, "layers": layers}


def _ops_load_params(path):
    from ray_tpu_torch.train.checkpoint import Checkpoint

    return Checkpoint(path).load_state()["params"]


def _ops_wf_serve(trained, prompts, marker, device, preset):
    """The workflow's step ``serve``: fails while `marker` exists (its
    first run, on purpose); else loads ``train``'s checkpoint into the ops
    phase's paged engine at its depth and returns the greedy tokens and
    this process's launches (all six counters, zeroed just before)."""
    import os

    if os.path.exists(marker):
        raise RuntimeError(f"serve fails while {marker} exists")
    params = _ops_load_params(trained["path"])
    eng = _ops_engine(device, preset, layers=trained["layers"],
                      params=params)
    tokens, launches = _ops_generate(eng, prompts)
    return {"tokens": tokens, "launches": launches, "pid": os.getpid(),
            "digest": _params_digest(params)}


def _gpu_pids():
    """The pids ``nvidia-smi`` lists as the card's compute apps (empty
    where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return set()
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def _gone(pids, wait_s=30.0):
    """(alive, on the card): the pids still alive `wait_s` after, and those
    ``nvidia-smi`` still lists then."""
    alive = _alive_after(pids, wait_s)
    deadline = time.time() + wait_s
    on_card = _gpu_pids() & set(pids)
    while on_card and time.time() < deadline:
        time.sleep(0.5)
        on_card = _gpu_pids() & set(pids)
    return alive, sorted(on_card)


def _wait_for(pred, timeout_s, step_s=0.05):
    """Poll `pred` until it returns a true value or `timeout_s` passes;
    its last value."""
    deadline = time.time() + timeout_s
    while True:
        v = pred()
        if v or time.time() > deadline:
            return v
        time.sleep(step_s)


def _http_json(url, body=None):
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        raw = r.read().decode()
        return (json.loads(raw) if r.headers.get_content_type()
                == "application/json" else raw)


def phase_ops(device="cuda", preset="1b", batch=(8, 1024)):
    """The operator surface over one session of the port's runtime, as an
    operator runs it: ``launcher.up`` of OPS_CLUSTER (a JSON config; the
    head advertises no GPU unit, the one node type ``gpu_node`` holds the
    card; max_workers 1, idle_timeout 0.1 min), the port's ``DashboardHead``
    on it and this process connected as a driver.

    (a) autoscaler: a ``num_gpus=1`` actor builds the 1b preset's paged
    engine (full width, 16 layers, bf16, flash prefill) and serves 4
    greedy prompts of 64-512 tokens, 32 new tokens each. Gates: the ask in
    ``get_load``'s unmet demand, exactly one ``gpu_node`` launched by the
    monitor, the actor's node labelled ``autoscaled``, the dashboard's
    ``/api/v0/nodes`` listing it with its GPU unit, the tokens equal to the
    same engine's in this process, K1 and K6 counted in the actor's
    process equal to this process's; after the actor's kill, the node
    terminated within idle_timeout + 3 monitor intervals, none of its
    processes alive and none on the card (nvidia-smi).
    (b) jobs through the dashboard head's REST routes
    (``JobSubmissionClient("http://...")``): the trainer phase's 4-layer 1b
    recipe for 3 steps (B 8 S 1024) as an entrypoint: SUCCEEDED, its
    losses read back through ``/api/jobs/{id}/logs`` within
    TRAIN_SHARDED_LOSS_RTOL of the same run here, its K1/K3/K4 launches
    equal; beside it, a second job looping the same steps, stopped after
    its first loss: STOPPED, its process gone and off the card;
    ``/metrics`` parses as Prometheus text.
    (c) a durable workflow, ``train`` (the same recipe, a DCP checkpoint
    under the workflow's storage) then ``serve`` (the checkpoint in the
    paged engine at 4 layers, the 4 prompts), whose first run fails in
    ``serve`` (a marker file, max_retries=0): FAILED, then ``resume``
    SUCCESSFUL with ``train`` run once (its run file, no K3/K4 launch in
    the resumed run), the tokens and K1/K6 launches equal to an engine
    here loaded from the same checkpoint.
    Then ``launcher.down``: no process of the cluster left. `device`,
    `preset` and `batch` rehearse it on the CPU (``device="cpu",
    preset="tiny", batch=(2, 128)``: the nvidia-smi and launch gates
    compare zeros there)."""
    import ast
    import os
    import pickle
    import re
    import shlex
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu_torch
    from ray_tpu_torch import workflow
    from ray_tpu_torch.autoscaler import launcher
    from ray_tpu_torch.core import runtime as _rt
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient
    from ray_tpu_torch.models import llama

    _free_device()
    _checkout_on_pythonpath()
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="ops_"))
    launcher.STATE_DIR = str(work / "clusters")
    cfg_path = work / "cluster.json"
    cfg_path.write_text(json.dumps(OPS_CLUSTER))
    idle_s = 60.0 * OPS_IDLE_TIMEOUT_MIN
    V = llama.PRESETS[preset].vocab_size
    prompts = _ops_prompts(V)
    res = {"cfg": f"{preset} paged engine (flash, page 64, 4 slots) in a "
                  "num_gpus=1 actor on an autoscaled node; its "
                  f"{OPS_TRAIN_LAYERS}-layer train recipe, B {batch[0]} S "
                  f"{batch[1]}, {OPS_TRAIN_STEPS} AdamW steps, as jobs and "
                  "a workflow",
           "cluster": OPS_CLUSTER, "prompt_lens": list(OPS_PROMPT_LENS),
           "nvidia_smi": RESULTS["phases"].get("device", {}).get(
               "nvidia_smi")}
    gates = {}
    gpu = device == "cuda"

    # the in-process references first, each freed before the cluster runs
    t0 = time.perf_counter()
    eng = _ops_engine(device, preset)
    ref_tokens, ref_launches = _ops_generate(eng, prompts)
    del eng
    _free_device()
    layers = min(OPS_TRAIN_LAYERS, _preset_layers(preset))
    ref_losses, ref_train_launches = _trainer_llama_run(
        device, preset, layers, tuple(batch), OPS_TRAIN_STEPS)
    _free_device()
    res["reference_s"] = time.perf_counter() - t0
    res["reference_launches"] = {"engine": ref_launches,
                                 "train": ref_train_launches}

    state = launcher.up(str(cfg_path))
    session_dir = state["session_dir"]
    nodes_file = Path(session_dir) / "autoscaler_nodes.json"
    gcs_host, gcs_port = state["address"].rsplit(":", 1)
    head = start_dashboard((gcs_host, int(gcs_port)),
                           session_dir=session_dir, port=0)
    base = f"http://{head.host}:{head.port}"
    daemon_pids = {state["gcs_pid"], state["nodelet_pid"],
                   state["monitor_pid"]}
    all_pids = set(daemon_pids)
    try:
        ray_tpu_torch.init(address=state["address"])
        gcs = _rt.get_runtime().gcs_call
        res["head_resources"] = ray_tpu_torch.cluster_resources()
        gates["head_has_no_gpu_unit"] = \
            res["head_resources"].get("GPU", 0.0) == 0.0

        # (a) an actor asking for the card makes the monitor launch gpu_node
        t_ask = time.perf_counter()
        actor = ray_tpu_torch.remote(num_gpus=1)(_OpsEngineActor).remote(
            device, preset)
        demand = _wait_for(lambda: [
            d for d in gcs("get_load")["unmet_demand"]
            if d["resources"].get("GPU", 0) >= 1], 30.0)
        gates["ask_in_unmet_demand"] = bool(demand)

        def autoscaled():
            return [n for n in gcs("get_nodes")
                    if n.alive and (n.labels or {}).get("autoscaled")]

        up = _wait_for(autoscaled, OPS_TIMEOUT_S, 0.2)
        t_registered = time.perf_counter()
        ray_tpu_torch.get(actor.ping.remote(), timeout=OPS_TIMEOUT_S)
        t_ready = time.perf_counter()
        view = [n for n in _http_json(base + "/api/v0/nodes")
                if (n.get("labels") or {}).get("autoscaled")]
        served = ray_tpu_torch.get(actor.serve.remote(prompts),
                                   timeout=OPS_TIMEOUT_S)
        node = {n.node_id.hex(): n for n in gcs("get_nodes")}[served["node"]]
        node_recs = json.loads(nodes_file.read_text())
        node_pids = {r["pid"] for r in node_recs.values()}
        tree = session_pids(node_pids) | {served["pid"]: "actor"}
        all_pids |= set(tree)
        ray_tpu_torch.kill(actor)
        t_kill = time.perf_counter()
        _wait_for(lambda: not json.loads(nodes_file.read_text()),
                  idle_s + 10 * OPS_MONITOR_INTERVAL_S, 0.1)
        t_term = time.perf_counter()
        alive, on_card = _gone(tree)
        launched = [ln for ln in (Path(session_dir) / "monitor.log")
                    .read_text().splitlines() if "autoscaler actions" in ln]
        n_launched = sum(len(ast.literal_eval(ln.split(
            "autoscaler actions: ", 1)[1])["launched"]) for ln in launched)
        res["autoscaler"] = {
            "demand_rows": demand[:2],
            "ask_to_node_registered_s": t_registered - t_ask,
            "node_registered_to_actor_ready_s": t_ready - t_registered,
            "ask_to_actor_ready_s": t_ready - t_ask,
            "kill_to_terminated_s": t_term - t_kill,
            "terminate_limit_s": idle_s + 3 * OPS_MONITOR_INTERVAL_S,
            "monitor_actions": launched, "node_labels": node.labels,
            "node_resources": node.resources_total.quantities,
            "dashboard_nodes": view, "launches": served["launches"],
            "node_pids": sorted(tree), "alive_after": alive,
            "on_card_after": on_card}
        print(f"ops (a): ask -> node registered "
              f"{t_registered - t_ask:.1f} s -> actor ready "
              f"{t_ready - t_registered:.1f} s; kill -> terminated "
              f"{t_term - t_kill:.1f} s", flush=True)
        gates.update({
            "one_gpu_node_launched": n_launched == 1 and len(up) == 1
            and len(node_recs) == 1,
            "actor_on_autoscaled_node":
                node.labels.get("autoscaled") is True
                and node.labels.get("node_type") == "gpu_node"
                and node.resources_total.quantities.get("GPU") == 1.0,
            "dashboard_lists_gpu_node": len(view) == 1
            and view[0]["resources"].get("GPU") == 1.0,
            "actor_tokens_equal": served["tokens"] == ref_tokens,
            "actor_launches_exact": served["launches"] == ref_launches
            and (not gpu or (ref_launches["flash_attention_fwd"] > 0
                 and ref_launches["paged_decode_attention_inplace"] > 0)),
            "node_terminated_in_time":
                not json.loads(nodes_file.read_text())
                and t_term - t_kill <= idle_s + 3 * OPS_MONITOR_INTERVAL_S,
            "node_processes_gone": not alive and not on_card})

        # (b) jobs through the dashboard head, the two side by side on the
        # card, and beside them (c)'s first run, which fails in serve
        client = JobSubmissionClient(base)
        env = {"env_vars": {"PYTHONPATH": os.environ["PYTHONPATH"]}}

        def entry(loop):
            return f"{shlex.quote(sys.executable)} -c " + shlex.quote(
                f"import chip_smoke; chip_smoke._ops_job_main({device!r}, "
                f"{preset!r}, {tuple(batch)!r}, loop={loop})")

        storage = str(work / "workflows")
        os.makedirs(storage)
        marker = str(work / "serve_fails")
        open(marker, "w").close()
        train = workflow.step(_ops_wf_train).bind(storage, device, preset,
                                                  tuple(batch))
        dag = workflow.step(max_retries=0)(_ops_wf_serve).bind(
            train, prompts, marker, device, preset)
        wf_id = "train_then_serve"
        t0 = time.perf_counter()
        job = client.submit_job(entrypoint=entry(False),
                                runtime_env=env, working_dir=str(REPO))
        loop_job = client.submit_job(entrypoint=entry(True),
                                     runtime_env=env, working_dir=str(REPO))
        first_run = workflow.run_async(dag, workflow_id=wf_id,
                                       storage=storage)

        def first_loss():
            text = client.get_job_logs(loop_job)
            return ("OPS_JOB_LOSS" in text) and text

        text = _wait_for(first_loss, OPS_TIMEOUT_S, 0.2) or ""
        loop_pid = next((int(ln.split()[1]) for ln in text.splitlines()
                         if ln.startswith("OPS_JOB_PID ")), None)
        t_stop = time.perf_counter()
        stopped = client.stop_job(loop_job)
        stop_s = time.perf_counter() - t_stop
        loop_status = client.get_job_status(loop_job)
        loop_alive, loop_on_card = _gone([loop_pid] if loop_pid else [])
        status = client.wait_until_finished(job, timeout=OPS_TIMEOUT_S)
        job_s = time.perf_counter() - t0
        logs = _http_json(f"{base}/api/jobs/{job}/logs")["logs"]
        line = next((ln for ln in logs.splitlines()
                     if ln.startswith("OPS_JOB ")), None)
        out = json.loads(line[len("OPS_JOB "):]) if line else {}
        rel = [abs(a - b) / abs(b) for a, b in
               zip(out.get("losses", []), ref_losses)]
        metrics = _http_json(base + "/metrics")
        bad = [ln for ln in metrics.splitlines() if ln
               and not ln.startswith("#")
               and not re.match(_PROM_SAMPLE, ln)]
        res["jobs"] = {"status": status, "job_s": job_s, "losses":
                       out.get("losses"), "reference_losses": ref_losses,
                       "loss_rel_diff": rel,
                       "launches": out.get("launches"),
                       "loop_status": loop_status, "loop_pid": loop_pid,
                       "loop_first_loss_s": t_stop - t0, "stop_s": stop_s,
                       "loop_alive_after": loop_alive,
                       "loop_on_card_after": loop_on_card,
                       "metrics_lines": len(metrics.splitlines()),
                       "metrics_bad_lines": bad[:5]}
        print(f"ops (b): job {status} in {job_s:.1f} s, losses "
              f"{out.get('losses')}; loop job stopped after "
              f"{stop_s:.2f} s: {loop_status}", flush=True)
        gates.update({
            "job_succeeded": status == JobStatus.SUCCEEDED,
            "job_losses_close": len(rel) == OPS_TRAIN_STEPS
            and max(rel) <= TRAIN_SHARDED_LOSS_RTOL,
            "job_launches_exact": out.get("launches") == ref_train_launches
            and (not gpu or ref_train_launches["flash_attention_bwd_dq"] > 0),
            "loop_job_stopped": stopped and loop_status == JobStatus.STOPPED
            and loop_pid is not None,
            "loop_job_gone": not loop_alive and not loop_on_card,
            "metrics_parse": not bad and "raytpu_nodes_alive" in metrics})

        # (c) the workflow: its first run failed in serve (the marker);
        # resume it, and meanwhile load the checkpoint here
        try:
            first_run.result(timeout=OPS_TIMEOUT_S)
            first_error = None
        except Exception as e:   # the failure the marker asks for
            first_error = f"{type(e).__name__}: {e}"
        status_failed = workflow.get_status(wf_id, storage=storage)
        os.unlink(marker)
        with ThreadPoolExecutor(max_workers=1) as pool:
            resuming = pool.submit(workflow.resume, dag, workflow_id=wf_id,
                                   storage=storage)
            with open(Path(storage, wf_id, "steps", train.key() + ".pkl"),
                      "rb") as f:
                trained = pickle.load(f)
            params = _ops_load_params(trained["path"])
            eng = _ops_engine(device, preset, layers=trained["layers"],
                              params=params)
            wf_ref_tokens, wf_ref_launches = _ops_generate(eng, prompts)
            digest = _params_digest(params)
            del eng, params
            resumed = resuming.result(timeout=OPS_TIMEOUT_S)
        _free_device()
        wf_s = time.perf_counter() - t0
        status_resumed = workflow.get_status(wf_id, storage=storage)
        train_runs = Path(storage, "train_runs").read_text().split()
        res["workflow"] = {
            "first_error": first_error, "status_after_failure":
                status_failed, "status_after_resume": status_resumed,
            "train_runs": len(train_runs),
            "seconds_from_jobs_submit": wf_s,
            "train_launches": trained["launches"],
            "train_losses": trained["losses"],
            "serve_launches": resumed["launches"],
            "reference_launches": wf_ref_launches,
            "checkpoint_digest": trained["digest"],
            "files": sorted(str(p.relative_to(storage))
                            for p in Path(storage).rglob("*")
                            if p.is_file())[:40]}
        print(f"ops (c): {status_failed} then {status_resumed}, "
              f"{wf_s:.1f} s after the jobs' submission; train ran "
              f"{len(train_runs)} time(s)", flush=True)
        gates.update({
            "workflow_failed_first": status_failed == "FAILED"
            and first_error is not None and "serve fails" in first_error,
            "workflow_resumed": status_resumed == "SUCCESSFUL",
            "train_ran_once": len(train_runs) == 1
            and resumed["launches"]["flash_attention_bwd_dq"] == 0
            and resumed["launches"]["flash_attention_bwd_dkdv"] == 0,
            "checkpoint_read_back": resumed["digest"] == trained["digest"]
            == digest,
            "workflow_tokens_equal": resumed["tokens"] == wf_ref_tokens,
            "workflow_launches_exact":
                resumed["launches"] == wf_ref_launches
                and (not gpu or wf_ref_launches["flash_attention_fwd"] > 0)})
        all_pids |= set(session_pids(all_pids))
    finally:
        ray_tpu_torch.shutdown()
        head.stop()
        launcher.down(str(cfg_path))
    left, left_on_card = _gone(all_pids)
    shutil.rmtree(work, ignore_errors=True)
    res["pids_alive_after_down"] = left
    res["pids_on_card_after_down"] = left_on_card
    gates["no_process_left"] = not left and not left_on_card
    res["gates"] = gates
    # the path's launches, each counted in the process that launched: the
    # actor's, the job's and the workflow's two steps'
    res["launches"] = {}
    for part in (served["launches"], out.get("launches") or {},
                 trained["launches"], resumed["launches"]):
        for k, n in part.items():
            res["launches"][k] = res["launches"].get(k, 0) + n
    res["workflow_launches"] = {"train": trained["launches"],
                                "serve": resumed["launches"]}
    res["ops_s"] = time.perf_counter() - t_phase
    res["ok"] = all(gates.values())
    if not res["ok"]:
        print(f"ops: failed gates {[k for k, v in gates.items() if not v]}",
              file=sys.stderr, flush=True)
    return res


LINT_MAX_S = 30.0


def phase_lint():
    """raylint (ray_tpu_torch/devtools/lint/) over the port's tree through
    the CLI a user calls, in a subprocess, with no result cache: exit 0,
    no unsuppressed finding, no parse error, more than 100 files, within
    LINT_MAX_S. Its report's summary, the suppressed count and the
    seconds; the failing findings' lines where there are any."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "lint", "--no-cache",
         "--json", "ray_tpu_torch"], cwd=str(REPO), capture_output=True,
        text=True, timeout=10 * LINT_MAX_S)
    seconds = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        doc = {}
    summary = doc.get("summary", {})
    failing = [f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}"
               for f in doc.get("findings", []) if not f["suppressed"]]
    gates = {"exit_0": proc.returncode == 0,
             "report_parsed": bool(summary),
             "no_findings": summary.get("findings") == 0,
             "no_parse_errors": summary.get("parse_errors") == 0,
             "files_over_100": summary.get("files_scanned", 0) > 100,
             "under_max_s": seconds < LINT_MAX_S}
    return {"ok": all(gates.values()), "gates": gates,
            "files": summary.get("files_scanned"),
            "findings": summary.get("findings"),
            "suppressed": summary.get("suppressed"),
            "parse_errors": summary.get("parse_errors"), "seconds": seconds,
            "failing": failing[:20], "stderr": proc.stderr[-2000:]}


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
    passes admit 8, so 16 slots stay live with ~1000-token contexts. Now
    and then CUPTI loses a whole trace: an admission traced with no
    kernel at all (its prefills launch thousands) is taken again, up to 2
    more times, after the 16 requests finish; so is a decode block that
    traced no paged decode kernel (each takes 16 of the 64 new tokens)."""
    V = eng.cfg.vocab_size

    def admit(prompts):
        def run():
            for p in prompts:
                eng.submit(p, max_new_tokens=64)
            eng._admit()
        return run

    for _ in range(3):
        full = [rng.integers(0, V, size=1000).tolist() for _ in range(16)]
        prefill = device_profile(admit(full[:8]), admit(full[8:]))
        if prefill["device_events"]:
            break
        while eng.has_work():
            eng.step_n(8)
    for _ in range(3):
        decode = device_profile(lambda: eng.step_n(8), lambda: eng.step_n(8))
        if decode["paged_kernels"] or eng.kv_layout != "paged":
            break
    return {"profile_prefill": prefill, "profile_decode_block": decode}


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
    res["decode_ran_ring_only"] = ran_paged_only(
        res["profile_decode_block"]["paged_kernels"], RING_SYMBOL)
    res["k5_path"] = k5_path(eng)
    res["ok"] = (res["ok"] and res["k5_path"]["ok"]
                 and res["prefill_ran_wgmma_fwd_only"]
                 and res["decode_ran_ring_only"])
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


class _EngineActor:
    """The runtime phase's actor (``num_gpus=1``): the engine phase's paged
    7b engine (32 layers, bf16, flash prefill, page 64, 16 slots, max_seq
    2048, seed 0) built in a worker process that the port's nodelet
    started, reached from the driver through ``remote``/``get`` only."""

    def __init__(self):
        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.serve.llm import LLMEngine

        t0 = time.perf_counter()
        cfg = llama.PRESETS["7b"].replace(attn_impl="flash")
        self.eng = LLMEngine(cfg=cfg, max_slots=16, max_seq_len=2048,
                             kv_layout="paged", page_size=64, seed=0,
                             device="cuda")
        torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - t0
        self.ref = None

    def ping(self):
        return None

    def serve_wave(self, wave1):
        """The engine_sharded phase's drive of wave 1 (request 3 sampled
        at 0.8, step_n(8) until done), with this process's K1/K6 counters
        set to 0 just before. After the first block, with every request
        live, the KV pool's record is read back from the cluster's memory
        plane; at the end the telemetry is flushed so the tokens counter
        reaches the GCS."""
        import os

        import torch

        import ray_tpu_torch
        from ray_tpu_torch.core import runtime as _rt
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.ops import paged_attention as pa
        from ray_tpu_torch.util import state

        eng = self.eng
        m0 = dict(eng.metrics)
        pa.launches = 0
        fa.launches = 0
        t_run = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=64,
                           temperature=0.8 if i == 3 else 0.0)
                for i, p in enumerate(wave1)]
        eng.step_n(8)
        t_mem = time.perf_counter()
        live = sum(1 for r in reqs if not r.done_event.is_set())
        _rt.get_runtime().flush_task_events(wait=True)
        rep = state.memory_report(top_n=200)
        kv = [r for r in rep.get("top_holders", [])
              if r.get("subsystem") == "kv"]
        kv_expected = eng.pool.used_pages * eng.pool.page_nbytes
        mem_s = time.perf_counter() - t_mem
        while eng.has_work():
            eng.step_n(8)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run - mem_s
        launches = {"paged_decode_attention_inplace": pa.launches,
                    "flash_attention_fwd": fa.launches}
        _rt.get_runtime().flush_task_events(wait=True)
        return {"pid": os.getpid(), "setup_s": self.setup_s,
                "actor_id": ray_tpu_torch.get_runtime_context()
                .get_actor_id(),
                "replica_tag": eng._m_tokens._default_tags.get("replica"),
                **engine_metrics(eng, reqs, m0, run_s),
                "launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "requests_live_at_memory_read": live,
                "kv_records": kv, "kv_expected_bytes": kv_expected,
                "memory_subsystem_bytes": rep.get("subsystem_bytes"),
                "tokens": [r.generated for r in reqs]}

    def put_embed(self):
        """Put the engine's bf16 embedding (a CUDA tensor) into the object
        store's device tier: same-process ``get`` must return the tensor
        itself. Returns the ref (held here too, so the object outlives
        the call) and a digest of the tensor's bytes."""
        import hashlib

        import torch

        import ray_tpu_torch

        emb = self.eng.params["embed"]
        self.ref = ray_tpu_torch.put(emb)
        same = ray_tpu_torch.get(self.ref) is emb
        host = emb.detach().cpu().contiguous()
        return {"ref": [self.ref], "same_process_identity": same,
                "sha256": hashlib.sha256(
                    host.view(torch.int16).numpy().tobytes()).hexdigest(),
                "nbytes": emb.numel() * emb.element_size(),
                "dtype": str(emb.dtype), "shape": list(emb.shape),
                "device": str(emb.device)}


def phase_runtime():
    """The runtime path: ``ray_tpu_torch.init(num_cpus=4)`` on this node
    (its GPU detected, no override), an actor with ``num_gpus=1`` holding
    the engine phase's paged 7b engine, the engine_sharded phase's wave 1
    served through one method call (K1 and K6 launched in the worker),
    the actor's no-op round trip, the device tier (put of the bf16
    embedding in the actor, get in the driver), then ``shutdown()`` and no
    process of the session left."""
    import hashlib
    import statistics

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.core import runtime as _rt
    from ray_tpu_torch.core.node import session_pids
    from ray_tpu_torch.models import llama

    _free_device()
    _checkout_on_pythonpath()
    base = RESULTS["phases"]["engine"]
    cfg = llama.PRESETS["7b"]
    wave1, _ = engine_requests(np.random.default_rng(5), cfg.vocab_size)
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    res = {"cfg": "the engine phase's paged 7b engine in an actor "
                  "(num_gpus=1); the engine_sharded phase's wave 1",
           "nvidia_smi": RESULTS["phases"]["device"]["nvidia_smi"],
           "init_s": init_s}
    pids = {p.pid: "daemon" for p in info["procs"]}
    try:
        res["cluster_resources"] = ray_tpu_torch.cluster_resources()
        actor = ray_tpu_torch.remote(num_gpus=1)(_EngineActor).remote()
        t_up = time.perf_counter()
        ray_tpu_torch.get(actor.ping.remote(), timeout=900)
        res["actor_up_s"] = time.perf_counter() - t_up
        t_call = time.perf_counter()
        wave = ray_tpu_torch.get(actor.serve_wave.remote(wave1), timeout=900)
        res["serve_wave_call_s"] = time.perf_counter() - t_call
        rtt = []
        for _ in range(100):
            t = time.perf_counter()
            ray_tpu_torch.get(actor.ping.remote(), timeout=60)
            rtt.append(time.perf_counter() - t)
        res["noop_round_trip_ms_median"] = statistics.median(rtt) * 1e3
        put = ray_tpu_torch.get(actor.put_embed.remote(), timeout=300)
        t = time.perf_counter()
        got = ray_tpu_torch.get(put["ref"][0], timeout=300)
        stage_s = time.perf_counter() - t
        digest = hashlib.sha256(got.contiguous().view(torch.int16)
                                .numpy().tobytes()).hexdigest()
        res["device_tier"] = {
            **{k: v for k, v in put.items() if k != "ref"},
            "remote_get_s": stage_s,
            "staging_gb_per_s": put["nbytes"] / stage_s / 1e9,
            "remote_dtype": str(got.dtype), "remote_shape": list(got.shape),
            "remote_device": str(got.device),
            "remote_bit_exact": digest == put["sha256"]}
        del got
        raw = _rt.get_runtime().gcs_call(
            "kv_get", ns="metrics", key=b"ray_tpu_serve_tokens_generated")
        series = json.loads(raw)["series"] if raw else []
        counted = sum(x.get("value", 0.0) for x in series
                      if x.get("tags", {}).get("replica")
                      == wave["replica_tag"])
        res["tokens_counter"] = counted
        pids[wave["pid"]] = "actor"
        pids.update(session_pids(pids))
        ray_tpu_torch.kill(actor)
    finally:
        ray_tpu_torch.shutdown()
    res["pids_alive_after_shutdown"] = _alive_after(pids)
    res["session_pids"] = {str(p): m for p, m in pids.items()}
    res.update({k: v for k, v in wave.items() if k != "tokens"})
    res["tokens"] = wave["tokens"]
    greedy = [i for i in range(len(wave1)) if i != 3]
    same = [wave["tokens"][i] == base["tokens"][i] for i in greedy]
    kv_ok = any(r["nbytes"] == wave["kv_expected_bytes"] > 0
                for r in wave["kv_records"])
    dt = res["device_tier"]
    res.update({
        "greedy_requests": greedy, "greedy_tokens_equal": same,
        "engine_decode_tokens_per_s": base["decode_tokens_per_s"],
        "engine_sharded_decode_tokens_per_s":
            RESULTS["phases"].get("engine_sharded", {})
            .get("decode_tokens_per_s"),
        "gates": {
            "gpu_detected": res["cluster_resources"].get("GPU") == 1.0,
            "greedy_tokens_equal": all(same),
            "all_finished_64": wave["all_finished_64"],
            "k1_k6_launched": all(v > 0 for v in wave["launches"].values()),
            "tokens_counter": counted == wave["tokens_generated"] > 0,
            "kv_in_memory_plane": kv_ok
            and wave["requests_live_at_memory_read"] > 0,
            "device_tier_identity": dt["same_process_identity"],
            "device_tier_bit_exact": dt["remote_bit_exact"]
            and dt["remote_dtype"] == "torch.bfloat16"
            and dt["remote_device"] == "cpu"
            and dt["remote_shape"] == dt["shape"],
            "no_process_left": not res["pids_alive_after_shutdown"]}})
    res["ok"] = all(res["gates"].values())
    return res


# --- the serve layer ----------------------------------------------------------

# any one get, stream item or HTTP call of the serve phases; a wedged
# replica fails the phase instead of hanging it
SERVE_TIMEOUT_S = 300.0
SERVE_NEW_TOKENS = 64
# serve and serve_disagg run the 7b width at this depth of its 32 layers
# (the script's time: at 32 their in-process references and replica
# set-ups took 44-58 s of the phases' 83-89 s on an H100's host, at 8 the
# replicas' set-ups 28-47 s of 56-76 s on a slow one)
SERVE_LAYERS = 4
# full KV pages per handoff group of the disaggregated app
SERVE_GROUP_PAGES = 4


def _probe_class():
    """``LLMServer`` with one method more, made here so that the server
    itself gains none: ``probe`` flushes its process's telemetry (so the
    tokens counter reaches the GCS) and returns that process's K1/K6
    launch counts, its engine's replica tag and its pid. A class made in
    a function pickles by value, so replicas need not import this
    script."""
    from ray_tpu_torch.serve.llm import LLMServer

    class ServeProbe(LLMServer):
        def probe(self):
            import os

            from ray_tpu_torch.core import runtime as _rt
            from ray_tpu_torch.ops import flash_attention as fa
            from ray_tpu_torch.ops import paged_attention as pa

            _rt.get_runtime().flush_task_events(wait=True)
            return {"pid": os.getpid(),
                    "replica_tag":
                        self.engine._m_tokens._default_tags.get("replica"),
                    "launches": {
                        "flash_attention_fwd": fa.launches,
                        "paged_decode_attention_inplace": pa.launches}}

    return ServeProbe


def _free_device():
    """Drop what earlier phases left on the card before a phase starts."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _serve_prompts(V):
    """The engine phase's 12 prompts (``engine_requests``, seed 5) as one
    list: indexes 0-7 wave 1 (7 the first of the 512-token shared prefix),
    8-11 wave 2 (8-10 sharing it)."""
    import numpy as np

    wave1, wave2 = engine_requests(np.random.default_rng(5), V)
    return wave1 + wave2


def _stream(handle, body):
    """One stream through a router's handle, each item within
    SERVE_TIMEOUT_S: its frames, the seconds to its first token frame and
    to its end."""
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime as _rt

    rt = _rt.get_runtime()
    t0 = time.perf_counter()
    gen = handle.options(stream=True).method("stream_request").remote(body)
    frames, first = [], None
    while True:
        ref = rt.next_stream_ref(gen.task_id, len(frames) + 1,
                                 timeout=SERVE_TIMEOUT_S)
        if ref is None:
            break
        frames.append(ray_tpu_torch.get(ref, timeout=SERVE_TIMEOUT_S))
        if first is None and frames[-1].get("tokens"):
            first = time.perf_counter() - t0
    return frames, first, time.perf_counter() - t0


def _http(port, path, body, stream):
    """One POST to the HTTP proxy: plain JSON (the router's ``__call__``)
    or ``?stream=1`` (chunked frames of its ``stream_request``)."""
    import http.client
    import urllib.request

    t0 = time.perf_counter()
    if not stream:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            out = json.loads(r.read())
            out["http_status"] = r.status
        return out, time.perf_counter() - t0
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SERVE_TIMEOUT_S)
    try:
        conn.request("POST", path + "?stream=1", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        frames = [json.loads(ln) for ln in resp.read().splitlines()
                  if ln.strip()]
        status = resp.status
    finally:
        conn.close()
    return {"frames": frames, "http_status": status}, \
        time.perf_counter() - t0


def _frames_check(frames, n_new):
    """A stream's contract: token frames then one final frame whose
    ``n_tokens`` counts the tokens the frames carried, all n_new of them,
    with no error. Returns (tokens, ok)."""
    toks = [t for f in frames[:-1] for t in f.get("tokens", [])]
    final = frames[-1] if frames else {}
    ok = (bool(frames) and final.get("done") is True
          and "error" not in final and final.get("status") is None
          and final.get("n_tokens") == len(toks) == n_new
          and all(f.get("tokens") and not f.get("done")
                  for f in frames[:-1]))
    return toks, ok


def _replicas(name):
    import ray_tpu_torch

    ctl = ray_tpu_torch.get_actor("_serve_controller", namespace="serve")
    return ray_tpu_torch.get(ctl.get_replicas.remote(name),
                             timeout=SERVE_TIMEOUT_S)


def _call_replica(replica, method):
    import ray_tpu_torch

    return ray_tpu_torch.get(
        replica.handle_request.remote(method, (), {}, None),
        timeout=SERVE_TIMEOUT_S)


def _tokens_counter(tag):
    """The ``ray_tpu_serve_tokens_generated`` counter of one replica tag,
    read back from the GCS."""
    from ray_tpu_torch.core import runtime as _rt

    raw = _rt.get_runtime().gcs_call(
        "kv_get", ns="metrics", key=b"ray_tpu_serve_tokens_generated")
    series = json.loads(raw)["series"] if raw else []
    return sum(x.get("value", 0.0) for x in series
               if x.get("tags", {}).get("replica") == tag)


def _checkout_on_pythonpath():
    """The runtime's daemons and workers import the port from this
    checkout."""
    import os

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)


def _alive_after(pids, wait_s=30.0):
    """The pids still alive ``wait_s`` after a session's shutdown."""
    from ray_tpu_torch.core.node import pid_alive

    deadline = time.time() + wait_s
    while time.time() < deadline and any(pid_alive(p) for p in pids):
        time.sleep(0.5)
    return [p for p in pids if pid_alive(p)]


def _serve_session(object_store_memory=None):
    """``ray_tpu_torch.init(num_cpus=8)`` with the checkout on the
    daemons' PYTHONPATH; returns the session's daemon pids."""
    import ray_tpu_torch

    _checkout_on_pythonpath()
    sys_cfg = ({"object_store_memory": int(object_store_memory)}
               if object_store_memory else None)
    info = ray_tpu_torch.init(num_cpus=8, _system_config=sys_cfg)
    return {p.pid: "daemon" for p in info["procs"]}


def _end_session(pids):
    """``serve.shutdown()`` and ``shutdown()``; the pids (of the session's
    daemons, replicas and workers) still alive 30 s later."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.node import session_pids

    pids.update(session_pids(pids))
    try:
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    return _alive_after(pids)


def phase_serve(preset="7b", device="cuda"):
    """The monolithic app behind the router: ``serve.run`` of an
    ``LLMServer`` replica (the engine phase's paged engine cut to
    SERVE_LAYERS (4) of its 32 layers: bf16, flash, page 64, 16 slots,
    max_seq 2048, seed 0; decode_block 8)
    behind an ``LLMRouter`` with an HTTP route. Four greedy prompts (two
    unique, two sharing the 512-token prefix; 64 new tokens each) go one
    at a time through the router's streaming handle, then again as HTTP
    POSTs (two plain, two ``?stream=1``); their tokens must equal an
    in-process engine's with the replica's configuration, run first on
    the same prompts in the same order (one request at a time gives each
    step the replica's shapes, and the order its prefix cache). Then the
    engine phase's 12 requests (request 3 at temperature 0.8) stream at
    once. ``preset``/``device`` rehearse the phase on the CPU
    (``"tiny"``, ``"cpu"``: no GPU unit, the kernels' plain versions)."""
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.llm_router import LLMRouter

    _free_device()
    cfg = llama.PRESETS[preset]
    cfg = cfg.replace(attn_impl="flash",
                      n_layers=min(cfg.n_layers, SERVE_LAYERS))
    ekw = dict(cfg=cfg, max_slots=16, max_seq_len=2048, kv_layout="paged",
               page_size=64, seed=0, device=device)
    allp = _serve_prompts(cfg.vocab_size)
    seq_idx = [0, 2, 7, 8]          # two unique, two sharing the prefix
    prompts = [allp[i] for i in seq_idx]
    n_new = SERVE_NEW_TOKENS

    t0 = time.perf_counter()
    eng = LLMEngine(**ekw)
    ref = [[eng.generate(p, n_new) for p in prompts] for _ in range(2)]
    ref_s = time.perf_counter() - t0
    del eng
    _free_device()

    res = {"cfg": f"{preset}, {cfg.n_layers} layers, flash, paged page 64, "
                  "16 slots, max_seq 2048, seed 0, decode_block 8; "
                  "LLMRouter (affinity) + HTTP proxy",
           "nvidia_smi": RESULTS["phases"].get("device", {})
           .get("nvidia_smi"),
           "prompt_idx": seq_idx, "prompt_lens": [len(p) for p in prompts],
           "reference_s": ref_s}
    pids = _serve_session()
    try:
        port = serve.start(http_port=0)
        gpu = {"num_gpus": 1} if device == "cuda" else {}
        llm = serve.deployment(
            _probe_class(), name="llm7b", num_replicas=1,
            ray_actor_options=gpu).bind(decode_block=8,
                                        max_queue_depth=None, **ekw)
        app = serve.deployment(LLMRouter, name="llm7b_router",
                               num_replicas=1).bind(llm, policy="affinity")
        t = time.perf_counter()
        handle = serve.run(app, route_prefix="/llm")
        res["deploy_s"] = time.perf_counter() - t
        (rep,) = _replicas("llm7b")
        bodies = [{"prompt": p, "max_new_tokens": n_new} for p in prompts]

        handle_toks, http_toks, streams_ok, ttft_seq = [], [], [], []
        for body in bodies:
            frames, first, _ = _stream(handle, body)
            toks, ok = _frames_check(frames, n_new)
            handle_toks.append(toks)
            streams_ok.append(ok)
            ttft_seq.append(first)
        http_status = []
        for i, body in enumerate(bodies):
            out, _ = _http(port, "/llm", body, stream=i >= 2)
            http_status.append(out["http_status"])
            if i >= 2:
                toks, ok = _frames_check(out["frames"], n_new)
                streams_ok.append(ok)
            else:
                toks = out.get("tokens")
            http_toks.append(toks)

        wave = [None] * len(allp)

        def one(i):
            wave[i] = _stream(handle, {
                "prompt": allp[i], "max_new_tokens": n_new,
                "temperature": 0.8 if i == 3 else 0.0})

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(len(allp))]
        t_wave = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVE_TIMEOUT_S)
        wave_s = time.perf_counter() - t_wave
        wave_done = [w is not None for w in wave]
        wave_checks = [_frames_check(w[0], n_new) if w else ([], False)
                       for w in wave]
        streams_ok += [ok for _, ok in wave_checks]
        wave_toks = [t for t, _ in wave_checks]
        ttft_wave = [w[1] for w in wave if w and w[1] is not None]

        probe = _call_replica(rep, "probe")
        pids[probe["pid"]] = "replica"
        stats = _call_replica(rep, "stats")
        rstats = ray_tpu_torch.get(handle.method("stats").remote(),
                                   timeout=SERVE_TIMEOUT_S)
        counted = _tokens_counter(probe["replica_tag"])
    finally:
        alive = _end_session(pids)
    n_requests = 2 * len(prompts) + len(allp)
    n_wave_tok = sum(len(t) for t in wave_toks)
    res.update({
        "launches": probe["launches"],
        "handle_tokens_equal": [a == b for a, b in zip(handle_toks, ref[0])],
        "http_tokens_equal": [a == b for a, b in zip(http_toks, ref[1])],
        "http_status": http_status, "streams_ok": streams_ok,
        "ttft_sequential_s": ttft_seq,
        "wave": {"requests": len(allp), "finished": sum(wave_done),
                 "wall_s": wave_s, "tokens": n_wave_tok,
                 "decode_tokens_per_s": n_wave_tok / wave_s,
                 "ttft_mean_s": (sum(ttft_wave) / len(ttft_wave)
                                 if ttft_wave else None),
                 "ttft_max_s": max(ttft_wave) if ttft_wave else None},
        "engine_phase": {k: RESULTS["phases"].get("engine", {}).get(k)
                         for k in ("decode_tokens_per_s", "ttft_mean_s",
                                   "ttft_max_s")},
        "replica_stats": {k: stats.get(k) for k in (
            "requests", "tokens_generated", "mean_ttft_s", "ttft_p50_s",
            "ttft_p99_s", "prefix_cache", "decode_block_s",
            "decode_blocks")},
        "router_stats": {k: rstats.get(k) for k in (
            "requests", "shed", "replica_shed", "reroutes",
            "affinity_picks")},
        "tokens_counter": counted, "pids_alive_after_shutdown": alive,
        "tokens": {"handle": handle_toks, "http": http_toks,
                   "wave": wave_toks}})
    res["gates"] = {
        "handle_tokens_equal": all(res["handle_tokens_equal"]),
        "http_tokens_equal": all(res["http_tokens_equal"])
        and http_status == [200] * len(prompts),
        "wave_all_finished_64": all(wave_done)
        and all(len(t) == n_new for t in wave_toks),
        "streams_ok": all(streams_ok),
        "k1_k6_launched": all(v > 0 for v in probe["launches"].values()),
        "tokens_counter": counted == stats.get("tokens_generated")
        == n_requests * n_new,
        "router_counts_every_request": rstats.get("requests") == n_requests
        and not rstats.get("shed") and not rstats.get("replica_shed"),
        "no_process_left": not alive}
    res["ok"] = all(res["gates"].values())
    return res


def phase_serve_disagg(preset="7b", device="cuda"):
    """One prefill and one decode replica behind ``DisaggRouter`` on one
    card (0.5 GPU unit each): the serve phase's engine with 8 slots, page
    groups of 4 pages. Seven greedy prompts, one at a time: the four
    sharing the 512-token prefix, two unique ones of 256 tokens or more
    and the shortest, which exports nothing. Reference: the handoff
    replayed in process in the same order: engine A (the replicas'
    configuration) runs ``generate(p, 1)`` and exports each full group of
    ``p`` as ``prefill_request`` does; a fresh engine B imports the groups
    (``import_kv_pages``) and runs ``generate(p, 64)``. The app's tokens
    must equal B's; each group must cross the store once."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggRouter
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.paged_kv import page_chain_hashes

    _free_device()
    cfg = llama.PRESETS[preset]
    cfg = cfg.replace(attn_impl="flash",
                      n_layers=min(cfg.n_layers, SERVE_LAYERS))
    ps, gp, n_new = 64, SERVE_GROUP_PAGES, SERVE_NEW_TOKENS
    ekw = dict(cfg=cfg, max_slots=8, max_seq_len=2048, kv_layout="paged",
               page_size=ps, seed=0, device=device)
    allp = _serve_prompts(cfg.vocab_size)
    shared_idx = [7, 8, 9, 10]
    others = [i for i in range(len(allp)) if i not in shared_idx]
    unique_idx = [i for i in others if len(allp[i]) >= gp * ps][:2]
    short_idx = min(others, key=lambda i: len(allp[i]))
    idx = shared_idx[:2] + unique_idx[:1] + [short_idx] + shared_idx[2:] \
        + unique_idx[1:]
    prompts = [allp[i] for i in idx]

    t0 = time.perf_counter()
    A, B = LLMEngine(**ekw), LLMEngine(**ekw)
    ref, groups, group_hashes = [], [], []
    for p in prompts:
        A.generate(p, 1)
        per_page = page_chain_hashes(p, ps)
        n_groups = len(A.pool.match_prefix(per_page)) // gp
        for g in range(n_groups):
            p0, p1 = g * gp, (g + 1) * gp
            k, v = A.export_kv_pages(A.pool.match_prefix(per_page[:p1])[p0:p1])
            B.import_kv_pages(per_page[p0:p1], k, v)
            group_hashes.append(per_page[p1 - 1])
        groups.append(n_groups)
        ref.append(B.generate(p, n_new))
    ref_s = time.perf_counter() - t0
    kv_dtype_bytes = A.kp.element_size()
    del A, B
    _free_device()
    distinct = len(set(group_hashes))
    group_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * gp * ps
                   * (cfg.d_model // cfg.n_heads) * kv_dtype_bytes)

    res = {"cfg": f"{preset}, {cfg.n_layers} layers, flash, paged page "
                  f"{ps}, 8 slots per engine, max_seq 2048, seed 0, "
                  f"group_pages {gp}; one prefill + one decode replica",
           "nvidia_smi": RESULTS["phases"].get("device", {})
           .get("nvidia_smi"),
           "prompt_idx": idx, "prompt_lens": [len(p) for p in prompts],
           "groups_per_prompt": groups, "distinct_groups": distinct,
           "group_bytes": group_bytes, "reference_s": ref_s}
    # every distinct group stays in the store with room to spare: none
    # spills
    store = max(2 * 1024**3, distinct * group_bytes + 1024**3)
    res["object_store_memory"] = store
    pids = _serve_session(object_store_memory=store)
    try:
        gpu = {"num_gpus": 0.5} if device == "cuda" else {}
        probe_cls = _probe_class()
        kw = dict(decode_block=8, max_queue_depth=None, group_pages=gp,
                  **ekw)
        prefill = serve.deployment(
            probe_cls, name="dz_prefill", num_replicas=1,
            ray_actor_options=gpu).bind(mode="prefill", **kw)
        decode = serve.deployment(
            probe_cls, name="dz_decode", num_replicas=1,
            ray_actor_options=gpu).bind(mode="decode", **kw)
        app = serve.deployment(DisaggRouter, name="dz_router",
                               num_replicas=1).bind(
            decode, prefill_app=prefill, policy="affinity")
        t = time.perf_counter()
        handle = serve.run(app)
        res["deploy_s"] = time.perf_counter() - t
        (pf,) = _replicas("dz_prefill")
        (dec,) = _replicas("dz_decode")
        got, streams_ok, ttft = [], [], []
        for p in prompts:
            frames, first, _ = _stream(handle, {"prompt": p,
                                                "max_new_tokens": n_new})
            toks, ok = _frames_check(frames, n_new)
            got.append(toks)
            streams_ok.append(ok)
            ttft.append(first)
        rstats = ray_tpu_torch.get(handle.method("stats").remote(),
                                   timeout=SERVE_TIMEOUT_S)
        # the router acks each handoff fire-and-forget: wait for them
        deadline = time.time() + 30
        while True:
            pf_stats = _call_replica(pf, "stats")
            if pf_stats.get("handoff_acked", 0) >= len(prompts) \
                    or time.time() > deadline:
                break
            time.sleep(0.2)
        dec_stats = _call_replica(dec, "stats")
        probes = {"prefill": _call_replica(pf, "probe"),
                  "decode": _call_replica(dec, "probe")}
        for role, pr in probes.items():
            pids[pr["pid"]] = role
    finally:
        alive = _end_session(pids)
    launches = {n: sum(pr["launches"][n] for pr in probes.values())
                for n in probes["prefill"]["launches"]}
    serve_ph = RESULTS["phases"].get("serve", {})
    mono = {}
    if serve_ph:
        # the serve phase's tokens of the same prompts: its sequential
        # passes where it sent the prompt one at a time, else its wave
        for i, toks in zip(serve_ph["prompt_idx"],
                           serve_ph["tokens"]["handle"]):
            mono[i] = toks
        for i, toks in enumerate(serve_ph["tokens"]["wave"]):
            mono.setdefault(i, toks)
    agree = [sum(a == b for a, b in zip(t, mono[i])) if i in mono else None
             for i, t in zip(idx, got)]
    mono_ttft = dict(zip(serve_ph.get("prompt_idx", []),
                         serve_ph.get("ttft_sequential_s", [])))
    ex = {k[len("handoff_"):]: v for k, v in pf_stats.items()
          if k.startswith("handoff_")}
    ad = {k[len("adopt_"):]: v for k, v in dec_stats.items()
          if k.startswith("adopt_")}
    res.update({
        "launches": launches,
        "launches_by_replica": {r: pr["launches"]
                                for r, pr in probes.items()},
        "tokens_equal": [a == b for a, b in zip(got, ref)],
        "streams_ok": streams_ok,
        "router_stats": {k: rstats.get(k) for k in (
            "requests", "handoffs", "handoffs_lost", "shed",
            "prefill_reroutes", "reroutes")},
        "exporter": ex, "adopter": ad,
        "export_gb_per_s": (ex.get("put_bytes", 0)
                            / max(ex.get("export_s", 0.0), 1e-9) / 1e9),
        "adopt_gb_per_s": (ad.get("adopted_bytes", 0)
                           / max(ad.get("adopt_s", 0.0), 1e-9) / 1e9),
        "ttft_s": ttft,
        "ttft_monolithic_s": [mono_ttft.get(i) for i in idx],
        "monolithic_tokens_agree": agree,
        "pids_alive_after_shutdown": alive, "tokens": got})
    res["gates"] = {
        "tokens_equal_replayed_handoff": all(res["tokens_equal"]),
        "streams_ok": all(streams_ok),
        "handoffs": rstats.get("handoffs") == len(prompts)
        and rstats.get("handoffs_lost") == 0,
        "each_group_crosses_once": ex.get("puts") == distinct
        and ex.get("reused_groups") == len(group_hashes) - distinct,
        "put_bytes": ex.get("put_bytes") == distinct * group_bytes,
        "adopted_bytes": ad.get("adopted_groups") == len(group_hashes)
        and ad.get("adopted_bytes") == len(group_hashes) * group_bytes,
        "every_handoff_acked": ex.get("acked") == len(prompts)
        and ex.get("inflight_handoffs") == 0,
        "k1_in_prefill_k6_in_decode":
            probes["prefill"]["launches"]["flash_attention_fwd"] > 0
            and probes["decode"]["launches"]
            ["paged_decode_attention_inplace"] > 0,
        "no_process_left": not alive}
    res["ok"] = all(res["gates"].values())
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
    counter = paged_counters(cfg.head_dim)[1]
    name = "paged_attention" + ("_wide" if cfg.head_dim > 256 else "")
    setattr(pa, counter, 0)
    outs = [pa.paged_attention(q, eng.kp[i], eng.vp[i], pt, ln)
            for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    launches = {name: getattr(pa, counter)}
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
                 and launches[name] == cfg.n_layers
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


# engine_contiguous runs the 7b width at this depth: its int8 init draws
# on the host leaf by leaf (ROADMAP item 18), 174-262 s at all 32 layers,
# ~58 s at 8
ENGINE_CONTIGUOUS_LAYERS = 2


def phase_engine_contiguous():
    """The JAX engine's default configuration on the card: the 7b preset at
    full width cut to ENGINE_CONTIGUOUS_LAYERS layers, bf16, contiguous KV
    (16 slots x 2048 tokens), int8
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

    cfg = llama.PRESETS["7b"].replace(attn_impl="flash",
                                      n_layers=ENGINE_CONTIGUOUS_LAYERS)
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
    res = {"cfg": f"7b width, {ENGINE_CONTIGUOUS_LAYERS} of its 32 layers, "
                  "bf16, int8 weights, flash, contiguous KV, 16 slots, "
                  "max_seq 2048",
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
            "flash_kernels": sorted(n for n in by_name if "flash_" in n),
            "paged_kernels": sorted(n for n in by_name
                                    if "paged_decode" in n)}


def ran_only(names, symbol) -> bool:
    """Kernel names, at least one, all of them the kernel `symbol`."""
    return bool(names) and all(symbol in n for n in names)


def _ptxas_of(source: str, symbol: str, head_dim: int,
              dtype: str = "bfloat16") -> list:
    """The build phase's ptxas lines ("registers; spills") of the entry
    functions of `source` that instantiate kernel `symbol` at `head_dim`
    (its mangled name holds ``<symbol>ILi<head_dim>E``); above 256, where
    the kernels take the head dim at run time, its instances of `dtype`
    (``<symbol>I13__nv_bfloat16`` or ``<symbol>If``)."""
    logs = RESULTS["phases"].get("build", {}).get("ptxas", {}).get(source, {})
    if head_dim > 256:
        key = symbol + ("I13__nv_bfloat16" if dtype == "bfloat16" else "If")
    else:
        key = f"{symbol}ILi{head_dim}E"
    return sorted({v for n, v in logs.items() if key in n})


def ran_wgmma_fwd_only(profile) -> bool:
    """A bf16 window's forward attention launches (K1/K2) all ran the
    TMA/wgmma kernel, and there was at least one."""
    return ran_only([n for n in profile["flash_kernels"] if "flash_fwd_" in n],
                    WGMMA_FWD_SYMBOL)


# --- driver -----------------------------------------------------------------


PHASES = ("build", "k6", "k5", "k1", "card_vs_cpu", "engine",
          "card_vs_cpu_contiguous", "engine_contiguous", "k2", "k3k4",
          "shapes", "train_card_vs_cpu", "train", "train_sharded", "sp_pp", "moe",
          "vit", "trainer", "data", "rl", "rl_offpolicy", "engine_sharded",
          "runtime", "serve", "serve_disagg", "rl_final", "tune", "ops",
          "lint")

# the TPU kernels of ray_tpu that the port has not reached yet (ROADMAP.md)
TO_PORT: dict = {}


KERNEL_PHASES = {"k6": phase_k6, "k5": phase_k5, "k1": phase_k1,
                 "k2": phase_k2, "k3k4": phase_k3k4}
PATH_PHASES = {"card_vs_cpu": phase_card_vs_cpu, "engine": phase_engine,
               "card_vs_cpu_contiguous": phase_card_vs_cpu_contiguous,
               "engine_contiguous": phase_engine_contiguous,
               "shapes": phase_shapes,
               "train_card_vs_cpu": phase_train_card_vs_cpu,
               "train": phase_train, "train_sharded": phase_train_sharded,
               "sp_pp": phase_sp_pp, "moe": phase_moe, "vit": phase_vit,
               "trainer": phase_trainer, "data": phase_data,
               "rl": phase_rl, "rl_offpolicy": phase_rl_offpolicy,
               "engine_sharded": phase_engine_sharded,
               "runtime": phase_runtime, "serve": phase_serve,
               "serve_disagg": phase_serve_disagg,
               "rl_final": phase_rl_final, "tune": phase_tune,
               "ops": phase_ops, "lint": phase_lint}


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
        ring = {n: v for n, v in logs.get("paged_attention", {}).items()
                if RING_SYMBOL in n}
        # the kernels above head dim 256 (every instance of them)
        wide = {n: v for src in logs.values() for n, v in src.items()
                if any(sym in n for sym in (WIDE_FWD_SYMBOL, WIDE_DQ_SYMBOL,
                                            WIDE_DKDV_SYMBOL, ANY_SYMBOL))}
        emit("build", seconds=time.perf_counter() - t0, per_source_s=took,
             ptxas=logs, ring_ptxas=ring, ring_spill_free=bool(ring) and all(
                 "0 bytes spill stores, 0 bytes spill loads" in v
                 for v in ring.values()),
             wide_ptxas=wide, wide_spill_free=bool(wide) and all(
                 "0 bytes spill stores, 0 bytes spill loads" in v
                 for v in wide.values()))
        return True
    if ph in KERNEL_PHASES:
        t0 = time.perf_counter()
        cases = KERNEL_PHASES[ph]()
        emit(ph, cases=cases, phase_s=time.perf_counter() - t0)
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
    # engine_sharded, runtime's actor (counted in its worker process), and
    # the serve phases' replicas (counted in theirs: serve's one replica,
    # serve_disagg's prefill and decode replicas summed); training: train,
    # train_card_vs_cpu (the run on which K2 launches), train_sharded,
    # sp_pp's pipeline routes, moe's forward and training, and trainer's
    # workers (counted in theirs: the GPT-2 runs, none, and the
    # Llama run); data: the batch predictor's actor (counted in its
    # process); rl: PPO on pixels, rl_offpolicy: the off-policy and
    # offline learners, rl_final: QMIX, MADDPG, MAML, AlphaZero and SlateQ,
    # which run none of them; tune: the GPT-2 trials (counted in their
    # processes), whose plain attention runs none; ops: the autoscaled
    # node's serving actor, the job's trainer and the workflow's train and
    # serve steps, each counted in its own process)
    paths = {"engine": ph["engine"]["launches"],
             "engine_k5": ph["engine"]["k5_path"]["launches"],
             "card_vs_cpu_contiguous":
                 ph["card_vs_cpu_contiguous"]["launches"],
             "engine_contiguous": ph["engine_contiguous"]["launches"],
             "shapes": ph["shapes"]["launches"],
             "train": ph["train"]["launches"],
             "train_card_vs_cpu": ph["train_card_vs_cpu"]["launches"],
             "train_sharded": ph["train_sharded"]["launches"],
             "sp_pp": ph["sp_pp"]["launches"],
             "moe": ph["moe"]["launches"],
             "trainer": ph["trainer"]["launches"],
             "data": ph["data"]["launches"],
             "rl": ph["rl"]["launches"],
             "rl_offpolicy": ph["rl_offpolicy"]["launches"],
             "engine_sharded": ph["engine_sharded"]["launches"],
             "runtime": ph["runtime"]["launches"],
             "serve": ph["serve"]["launches"],
             "serve_disagg": ph["serve_disagg"]["launches"],
             "rl_final": ph["rl_final"]["launches"],
             "tune": ph["tune"]["launches"],
             "ops": ph["ops"]["launches"]}
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
    # the same six above head dim 256 (the wide kernels; the paged ones the
    # any-shape kernel), timed at head dim 512
    wide34 = case("k3k4", "d512")
    rows += [
        ("flash_attention_fwd_wide", "ray_tpu_torch/csrc/flash_attention.cu",
         "ray_tpu/ops/flash_attention.py:37", case("k1", "d512"), ""),
        ("flash_attention_fwd_window_wide",
         "ray_tpu_torch/csrc/flash_attention.cu",
         "ray_tpu/ops/flash_attention.py:123",
         case("k2", f"d512-w{WIDE_WINDOW}"), ""),
        ("flash_attention_bwd_dq_wide",
         "ray_tpu_torch/csrc/flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:251", wide34, "k3_"),
        ("flash_attention_bwd_dkdv_wide",
         "ray_tpu_torch/csrc/flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:297", wide34, "k4_"),
        ("paged_decode_attention_inplace_wide",
         "ray_tpu_torch/csrc/paged_attention.cu",
         "ray_tpu/ops/paged_attention.py:127", case("k6", "hd512"), ""),
        ("paged_attention_wide", "ray_tpu_torch/csrc/paged_attention.cu",
         "ray_tpu/ops/paged_attention.py:61", case("k5", "hd512"), ""),
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
