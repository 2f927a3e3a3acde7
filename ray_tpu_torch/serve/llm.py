"""Continuous-batching LLM engine, in PyTorch.

Port of ``ray_tpu/serve/llm.py``'s ``LLMEngine``, both KV layouts:

- ``kv_layout="contiguous"`` (the default, as in JAX): one [max_seq] cache
  row per slot (``llama.KVCache``); decode is ``llama.decode_step`` and
  chunked prefill ``llama.prefill_tail_contiguous``. The only layout that
  serves sliding-window models;
- ``kv_layout="paged"``: the paged pools with FIFO page gating, prefix
  caching and recompute-preemption on the copied ``paged_kv.PagePool``;
  decode runs the fused paged kernel K6 on every layer.

Common to both:

- a fixed pool of decode SLOTS: every decode step runs [max_slots] rows
  whatever the number of live requests (inactive rows are masked);
- bucketed prefill: prompts are right-padded to a power-of-two bucket, as
  in the JAX engine, so both engines see the same shapes (and buckets of
  at least 128 tokens take the flash kernel under ``attn_impl="flash"``);
- admission between decode steps, with chunked prefill;
- ``step_n``: n decode steps with ON-DEVICE greedy/temperature sampling
  and one host fetch per block (``step`` is ``step_n(1)``);
- ``quantize="int8"``: weight-only int8 (``llama.quantize_params_int8``),
  made leaf by leaf as the init draws them on the host
  (``llama.init_params_int8``), or applied to a caller's params
  (idempotent).

PyTorch replaces ``jax.jit`` with eager calls: the caches are updated in
place by the kernels and scatters (where JAX donates them), and the
device-resident decode state (last tokens, masks, temperatures, lengths,
page table) is uploaded only when slot membership changes, as in JAX.

``mesh=``/``rules=`` (together): the weights rest in their shards as
DTensors placed by ``llama.param_specs`` and the rules (drawn leaf by leaf
and placed as drawn; int8 quantizes each shard after, its scale the max
over the GLOBAL input dim, so the tree gathered back is the unsharded
engine's bit for bit). Prefill and decode gather each weight whole at its
use and keep the KV pools whole; tensor-parallel compute in them (K6/K5
over kv-head-sharded pools) is ROADMAP.md queue 1 item 12.

Cluster metrics: the engine records TTFT, admission seconds, decode-block
seconds and generated tokens into ``util.metrics`` instruments tagged with
its replica (the actor id from the runtime context, "driver" or "local"),
beside the local ``metrics`` dict, as JAX's engine does.

``LLMServer`` is the serve deployment around the engine (a copy of JAX's):
a decode thread drives every engine it hosts (the default one, the
multiplexed models and the retiring ones), and it serves the monolithic,
prefill and decode roles of disaggregated serving (``serve/disagg.py``).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.paged_kv import PagePool, page_chain_hashes

logger = logging.getLogger("ray_tpu_torch.serve.llm")


def _place_params(tree, dev):
    """An unsharded param tree on ``dev``, one leaf at a time, so a host
    tree never exists twice on the card: tensors move (a leaf already on
    ``dev`` is kept as it is), numpy arrays become tensors
    (``llama.params_from_jax``: bf16 stays bf16, int8 ``q8`` leaves stay
    integer)."""
    if isinstance(tree, dict):
        return {k: _place_params(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return llama.params_from_jax(tree, dev)


class LLMQueueFull(Exception):
    """Raised by submit() when the admission queue is at max_queue_depth
    (the serve layer maps it to HTTP 429)."""


@dataclass
class _Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    slot: int = -1
    generated: List[int] = field(default_factory=list)
    #: tokens present in BOTH prompt and generated after a recompute-
    #: preemption folded generated tokens into the resume prompt; real
    #: sequence length = len(prompt) + len(generated) - overlap
    overlap: int = 0
    error: Optional[str] = None
    done_event: threading.Event = field(default_factory=threading.Event)
    # pulsed whenever generated grows (token-streaming consumers wait on it)
    progress: threading.Event = field(default_factory=threading.Event)
    submit_time: float = field(default_factory=time.time)
    first_token_time: Optional[float] = None


class LLMEngine:
    """Synchronous engine core; drive with step()/step_n(). Thread-safe
    submit."""

    def __init__(self, cfg=None, params=None, *, preset: str = "tiny",
                 max_slots: int = 8, max_seq_len: Optional[int] = None,
                 eos_token: int = -1, seed: int = 0, mesh=None, rules=None,
                 kv_layout: str = "contiguous", page_size: int = 64,
                 num_pages: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 prefix_caching: bool = True,
                 prefix_cache_max_tail: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 quantize: Optional[str] = None, device=None):
        self.device = dev = resolve_device(device)
        if (mesh is None) != (rules is None):
            raise ValueError("LLMEngine takes mesh= and rules= together")
        if mesh is not None and mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r} but the "
                             f"engine's device is {dev.type!r}")
        if quantize is not None and quantize != "int8":
            raise ValueError(f"quantize must be 'int8', got {quantize!r}")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if cfg is None:
            cfg = llama.PRESETS[preset]
            if dev.type != "cuda":
                # bf16 on the card; f32 elsewhere, as the JAX engine off-TPU
                cfg = cfg.replace(dtype=torch.float32)
        self.max_seq = max_seq_len or cfg.max_seq_len
        if self.max_seq > cfg.max_seq_len:
            # decode sizes its RoPE tables from cfg.max_seq_len; RoPE is
            # computed, not learned, so extending the cfg is exact
            cfg = cfg.replace(max_seq_len=self.max_seq)
        if kv_layout == "paged" and cfg.sliding_window is not None:
            raise ValueError(
                "kv_layout='paged' does not support sliding_window "
                "configs; use the contiguous layout for windowed models")
        self.cfg = cfg
        self.max_slots = max_slots
        self.eos = eos_token
        self.max_queue_depth = max_queue_depth
        # sharded (mesh + rules): every weight is placed by param_specs and
        # the rules as a DTensor holding this rank's shard (shard first,
        # quantize after, as JAX does); prefill and decode gather each
        # weight whole at its use
        place = None
        if mesh is not None:
            from ray_tpu_torch.parallel import sharding

            place = sharding.leaf_placer(mesh, llama.param_specs(cfg), rules,
                                         dev)
        if params is None:
            # serving holds no master weights: init in the compute dtype
            icfg = cfg.replace(param_dtype=cfg.dtype)
            if quantize == "int8":
                # drawn on the host, as the JAX engine draws off the CPU,
                # and quantized leaf by leaf onto the device, one layer's
                # slice at a time: the float tree never exists whole on
                # the card (7b: 13.5 GB of bf16 beside 6.7 GB of int8; a
                # 70b int8 engine would not fit an 80 GB card otherwise).
                # The host generator gives the card the CPU engine's int8
                # tree bit for bit from one seed; the quantization's f32
                # passes run on the card, and the host only draws.
                # Sharded, each leaf is placed as drawn and its shard
                # quantized, the scale's max taken over every shard.
                params = llama.init_params_int8(
                    torch.Generator().manual_seed(seed), icfg, device=dev,
                    place=place)
            else:
                gen = torch.Generator(device=dev).manual_seed(seed)
                params = llama.init_params(gen, icfg, place)
        elif mesh is not None:
            params = sharding.shard_params(mesh, params,
                                           llama.param_specs(cfg), rules, dev)
        else:
            # a caller's tree may lie on the host (JAX's engine computes on
            # numpy leaves where they are; a ModelRegistry fetch gives CPU
            # tensors): place it on the device leaf by leaf
            params = _place_params(params, dev)
        if quantize == "int8":
            # weight-only int8: device memory at rest halves against bf16
            # (7B: ~6.7 GB); idempotent, so a quantized tree passes through
            params = llama.quantize_params_int8(params)
        self.quantize = quantize
        self.params = params
        self.kv_layout = kv_layout
        # automatic prefix caching (paged only): share full prompt pages by
        # content hash; a hit skips that prefix's prefill compute and
        # memory, and chunked tail-prefill rounds finish admission
        self.prefix_caching = bool(prefix_caching)
        self.prefix_cache_max_tail = (
            prefix_cache_max_tail if prefix_cache_max_tail is not None
            else 4 * page_size)
        if kv_layout == "paged":
            maxP = -(-self.max_seq // page_size)
            # default pool = the memory a contiguous cache would commit
            # (+ trash page); the paged win is packing MORE slots into it
            num_pages = num_pages or max_slots * maxP + 1
            self.kp, self.vp = llama.init_paged_cache(cfg, num_pages,
                                                      page_size, device=dev)
            page_nbytes = (self.kp.nbytes + self.vp.nbytes) // num_pages
            self.pool = PagePool(num_pages, page_size, max_slots, maxP,
                                 page_nbytes=page_nbytes)
            self._len_host = np.zeros((max_slots,), np.int64)
            self._pt_dev = torch.as_tensor(self.pool.table, device=dev)
            self._len_dev = torch.zeros((max_slots,), dtype=torch.int32,
                                        device=dev)
            self._table_dirty = False
            self.cache = None
        else:
            self.pool = None
            self.cache = llama.init_cache(cfg, max_slots, max_seq=self.max_seq,
                                          device=dev)
        self.slots: List[Optional[_Request]] = [None] * max_slots
        self.lock = threading.Lock()
        self.pending: List[_Request] = []
        # requests that own a slot but are mid-prefill: each _admit round
        # advances them by one bounded chunk; masked OUT of decode until
        # their tail completes
        self._prefilling: List[_Request] = []
        #: chunk size for the chunked-prefill path. None => plain prompts
        #: prefill in one call and only prefix-cache tails are chunked
        self.prefill_chunk = prefill_chunk
        self._next_id = 0
        # device-resident decode state, uploaded only when slot
        # membership changes
        self._last = torch.zeros((max_slots, 1), dtype=torch.int32,
                                 device=dev)
        self._active_dev = torch.zeros((max_slots,), dtype=torch.int32,
                                       device=dev)
        self._temps_dev = torch.zeros((max_slots,), dtype=torch.float32,
                                      device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5eed)
        self._masks_dirty = True
        self.metrics = {"requests": 0, "tokens_generated": 0,
                        "ttft_sum": 0.0, "ttft_count": 0}
        # Cluster-visible instruments (util.metrics -> batched telemetry
        # reports), replica-tagged so the future serve router can read
        # per-replica admission cost and TTFT percentiles from the GCS.
        # The plain dict above stays the local stats() view.
        from ray_tpu_torch.util import metrics as _um
        try:
            import ray_tpu_torch
            replica = (ray_tpu_torch.get_runtime_context().get_actor_id()
                       or "driver")
        except Exception:
            replica = "local"
        tag = {"replica": str(replica)[:16]}
        self._m_ttft = _um.Histogram(
            "ray_tpu_serve_ttft_s", "time to first token per request",
            boundaries=[0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30],
            tag_keys=("replica",)).set_default_tags(tag)
        self._m_admit = _um.Counter(
            "ray_tpu_serve_admit_s", "seconds spent in request admission",
            tag_keys=("replica",)).set_default_tags(tag)
        self._m_decode_block = _um.Histogram(
            "ray_tpu_serve_decode_block_s",
            "fused decode-block wall seconds",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5],
            tag_keys=("replica",)).set_default_tags(tag)
        self._m_tokens = _um.Counter(
            "ray_tpu_serve_tokens_generated", "generated tokens",
            tag_keys=("replica",)).set_default_tags(tag)

    def _record_first_token(self, r, now: float) -> None:
        """Client-visible TTFT, once per request (re-admission after a
        recompute-preemption must not reset it or double-count)."""
        r.first_token_time = now
        ttft = now - r.submit_time
        self.metrics["ttft_sum"] += ttft
        self.metrics["ttft_count"] += 1
        self._m_ttft.observe(ttft)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ---- submission --------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               temperature: float = 0.0) -> _Request:
        with self.lock:
            if (self.max_queue_depth is not None
                    and len(self.pending) >= self.max_queue_depth):
                self.metrics["rejected"] = \
                    self.metrics.get("rejected", 0) + 1
                raise LLMQueueFull(
                    f"admission queue at max_queue_depth="
                    f"{self.max_queue_depth}; retry later")
            req = _Request(self._next_id, list(prompt), max_new_tokens,
                           temperature)
            self._next_id += 1
            self.pending.append(req)
            self.metrics["requests"] += 1
        return req

    def has_work(self) -> bool:
        with self.lock:
            return bool(self.pending) or any(s is not None for s in self.slots)

    # ---- engine step -------------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _chunk_size(self) -> int:
        """Tokens of prefill per admission round for the chunked path."""
        if self.prefill_chunk:
            return self.prefill_chunk
        if self.kv_layout == "paged":
            return self.prefix_cache_max_tail
        return 512

    def _admit(self):
        chunk = self._chunk_size()
        with self.lock:
            free = [i for i, s in enumerate(self.slots) if s is None]
            chunked_new = []
            admit = []
            if self.kv_layout == "paged":
                self._admit_paged(free, chunk, chunked_new, admit)
            else:
                for r in list(self.pending):
                    if not free:
                        break
                    plen = min(len(r.prompt), self.max_seq - 1)
                    self._assign_slot(r, free.pop(0), plen, chunk,
                                      chunked_new, admit)
                    self.pending.remove(r)
            self._prefilling.extend(chunked_new)
        # advance every mid-prefill request (fresh prefix hits included)
        # by one bounded chunk — one batched call for the whole set
        self._prefill_round(chunk)
        if not admit:
            return
        P = self._bucket(max(len(r.prompt) for r in admit))
        toks = np.zeros((len(admit), P), np.int32)
        lens = np.zeros((len(admit),), np.int32)
        for i, r in enumerate(admit):
            p = r.prompt[-P:]
            toks[i, :len(p)] = p
            lens[i] = len(p)
        lens_dev = self._tensor(lens)
        logits, ks, vs = llama.prefill(self.params, self._tensor(toks),
                                       lens_dev, self.cfg)
        slots = self._tensor([r.slot for r in admit], torch.long)
        if self.kv_layout == "paged":
            self._pt_dev = self._tensor(self.pool.table)
            llama.scatter_prefill_pages(self.kp, self.vp, ks, vs,
                                        self._pt_dev, slots, lens_dev,
                                        self.pool.page_size)
            for i, r in enumerate(admit):
                self._len_host[r.slot] = int(lens[i])
            self._len_dev = self._tensor(self._len_host)
            self._table_dirty = False
        else:
            # the new KV into the slots' cache rows, and their lengths
            self.cache.k[:, slots, :P] = ks.to(self.cache.k.dtype)
            self.cache.v[:, slots, :P] = vs.to(self.cache.v.dtype)
            self.cache.length[slots] = lens_dev
        del ks, vs
        for i, r in enumerate(admit):
            r._filled = int(lens[i])
        self._masks_dirty = True
        self._emit_first_tokens(list(enumerate(admit)), logits, len(admit))

    def _admit_paged(self, free, chunk, chunked_new, admit):
        """FIFO admission gated on BOTH a free slot and enough free pages
        for the prompt (caller holds self.lock) — head-of-line blocks
        rather than starving long prompts."""
        for r in list(self.pending):
            if not free:
                break
            plen = min(len(r.prompt), self.max_seq - 1)
            # a prompt that can NEVER fit must fail now, or it
            # head-of-line blocks the queue forever
            if self.pool.pages_for(plen) > min(
                    self.pool.max_pages_per_slot, self.pool.num_pages - 1):
                self.pending.remove(r)
                r.error = (f"prompt of {plen} tokens exceeds the KV page "
                           f"pool capacity")
                r.done_event.set()
                r.progress.set()
                continue
            if self._try_admit_cached(r, free, plen):
                chunked_new.append(r)
                self.pending.remove(r)
                continue
            slot = free[0]
            if not self.pool.grow(slot, plen):
                break
            free.pop(0)
            self._assign_slot(r, slot, plen, chunk, chunked_new, admit)
            self.pending.remove(r)

    def _assign_slot(self, r, slot: int, plen: int, chunk: int,
                     chunked_new: list, admit: list):
        """Bind a request to its slot (caller holds self.lock), routing
        long prompts to the chunked-prefill path when enabled."""
        r.slot = slot
        self.slots[slot] = r
        if self.prefill_chunk and plen > chunk:
            # long prompt: bounded chunks across admission rounds
            r._tail = list(r.prompt[-plen:])
            r._filled = 0
            if self.kv_layout == "paged":
                self._len_host[slot] = 0
            chunked_new.append(r)
        else:
            admit.append(r)

    def _emit_first_tokens(self, pairs, logits, nb: int):
        """Shared completion path for every prefill flavor (plain,
        prefix-hit, chunked): sample each finished row's first token,
        record TTFT, register prompt pages for prefix caching, and
        finish/notify. pairs = [(logits_row, request)]; nb = the logits
        batch size (pad rows get temp 0)."""
        if not pairs:
            return
        temps = np.zeros((nb,), np.float32)
        for i, r in pairs:
            temps[i] = r.temperature
        first = self._sample(logits, self._tensor(temps, torch.float32))
        first = first.cpu().numpy()
        upd = self._tensor([r.slot for _, r in pairs], torch.long)
        self._last[upd, 0] = self._tensor([int(first[i]) for i, _ in pairs])
        now = time.time()
        for i, r in pairs:
            r.generated.append(int(first[i]))
            if r.first_token_time is None:
                self._record_first_token(r, now)
            self.metrics["tokens_generated"] += 1
            self._m_tokens.inc()
            if (self.kv_layout == "paged" and self.prefix_caching
                    and r._filled < self.max_seq):
                # register this prompt's FULL pages for later hits (they
                # stay read-only: decode appends past the fill). Prompts
                # truncated to the FULL max_seq window are skipped: the
                # lookup side views the last max_seq-1 tokens.
                self.pool.register(r.slot, page_chain_hashes(
                    list(r.prompt)[-r._filled:], self.pool.page_size))
            self._maybe_finish(r)
            r.progress.set()

    def _prefill_round(self, chunk: int):
        """One bounded prefill chunk for every mid-prefill request, in ONE
        batched call. Requests whose tail completes sample their first
        token here and join the next decode step; the rest stay masked out
        of decode and continue next round."""
        with self.lock:
            rows = list(self._prefilling)
        if not rows:
            return
        takes = [min(len(r._tail), chunk) for r in rows]
        Tb = self._bucket(max(takes))
        n = len(rows)
        if self.kv_layout == "paged":
            # pad the batch to a power of two, as the JAX engine does to
            # bound its programs; pad rows have tail_len 0 and write the
            # trash page
            nb = 1
            while nb < n:
                nb *= 2
        else:
            # contiguous has no trash row a pad entry could target, so the
            # batch stays exact
            nb = n
        toks = np.zeros((nb, Tb), np.int32)
        tl = np.zeros((nb,), np.int32)
        pl = np.zeros((nb,), np.int32)
        for i, r in enumerate(rows):
            t = r._tail[:takes[i]]
            toks[i, :len(t)] = t
            tl[i] = len(t)
            pl[i] = r._filled
        if self.kv_layout == "paged":
            tab = np.zeros((nb, self.pool.table.shape[1]), np.int32)
            tab[:n] = self.pool.table[[r.slot for r in rows]]
            logits, _, _ = llama.prefill_paged_tail(
                self.params, self._tensor(toks), self._tensor(tl),
                self._tensor(pl), self._tensor(tab), self.kp, self.vp,
                self.cfg)
        else:
            logits, self.cache = llama.prefill_tail_contiguous(
                self.params, self._tensor(toks), self._tensor(tl),
                self._tensor(pl), self.cache,
                self._tensor([r.slot for r in rows]), self.cfg)
        finished = []
        with self.lock:
            for i, r in enumerate(rows):
                r._filled += takes[i]
                r._tail = r._tail[takes[i]:]
                if self.kv_layout == "paged":
                    self._len_host[r.slot] = r._filled
                if not r._tail:
                    finished.append((i, r))
                    self._prefilling.remove(r)
            self._masks_dirty = True
            if self.kv_layout == "paged":
                self._table_dirty = True
        self._emit_first_tokens(finished, logits, nb)

    def _try_admit_cached(self, r, free: List[int], plen: int) -> bool:
        """Prefix-cache admission (caller holds self.lock): if the
        prompt's leading FULL pages are cached, adopt them — no prefill
        compute, no new pages for the prefix. The unmatched tail is
        finished by the chunked-prefill rounds. Returns False to fall back
        to the full prefill."""
        if not self.prefix_caching:
            return False
        ptoks = list(r.prompt[-plen:])   # view matching registration
        # memoized: a head-of-line-blocked request would otherwise re-hash
        # its whole prompt once per step until admission
        hashes = getattr(r, "_page_hashes", None)
        if hashes is None:
            hashes = page_chain_hashes(ptoks, self.pool.page_size)
            if len(hashes) * self.pool.page_size >= plen:
                hashes = hashes[:-1]  # keep >=1 tail token as decode input
            r._page_hashes = hashes
        if not hashes:
            return False
        pages = self.pool.match_prefix(hashes)
        if not pages:
            return False
        matched = len(pages) * self.pool.page_size
        slot = free[0]
        self.pool.adopt(slot, pages)
        if not self.pool.grow(slot, plen):   # room for the tail's KV
            self.pool.release(slot)          # rollback: drops the refs
            return False
        free.pop(0)
        r.slot = slot
        self.slots[slot] = r
        self._len_host[slot] = matched       # tail-prefill advances it
        r._tail = ptoks[matched:]
        r._filled = matched
        self.metrics["prefix_hits"] = \
            self.metrics.get("prefix_hits", 0) + 1
        self.metrics["prefix_hit_tokens"] = \
            self.metrics.get("prefix_hit_tokens", 0) + matched
        return True

    def _sample(self, logits, temps):
        """On-device sampling: greedy where temps <= 0, else a categorical
        draw at logits / temp (Gumbel-max, from the engine's generator).
        Returns [rows] int64 on the device; no host sync."""
        greedy = torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(u))
        sampled = torch.argmax(
            logits / torch.clamp(temps, min=1e-4)[:, None] + gumbel, dim=-1)
        return torch.where(temps <= 0.0, greedy, sampled)

    def _seq_len(self, r: _Request) -> int:
        return len(r.prompt) + len(r.generated) - r.overlap

    @staticmethod
    def _decode_ready(r: Optional[_Request]) -> bool:
        """A slot participates in decode only once its prefill is
        complete — mid-chunked-prefill rows are masked out."""
        return r is not None and not getattr(r, "_tail", None)

    def _maybe_finish(self, r: _Request):
        if (len(r.generated) >= r.max_new_tokens
                or (self.eos >= 0 and r.generated
                    and r.generated[-1] == self.eos)
                or self._seq_len(r) >= self.max_seq - 1):
            with self.lock:
                if r.slot >= 0:
                    if self.kv_layout == "paged":
                        self.pool.release(r.slot)
                        self._len_host[r.slot] = 0
                        self._table_dirty = True
                    self.slots[r.slot] = None
                    r.slot = -1
                    self._masks_dirty = True
            r.done_event.set()
            r.progress.set()

    def _preempt_one(self) -> bool:
        """Pools exhausted mid-decode: evict the most recently admitted
        request (vLLM's recompute-preemption policy) — its pages free up,
        it rejoins the FRONT of the queue with prompt+generated as the new
        prompt, and prefill recomputes its KV when pages are available."""
        with self.lock:
            active = [r for r in self.slots if r is not None]
            if len(active) <= 1:
                return False
            victim = max(active, key=lambda r: r.req_id)
            self.pool.release(victim.slot)
            self._len_host[victim.slot] = 0
            self.slots[victim.slot] = None
            victim.slot = -1
            # resume prompt = everything decoded so far; `overlap` keeps
            # sequence-length accounting from double-counting
            victim.prompt = list(victim.prompt) + \
                list(victim.generated[victim.overlap:])
            victim.overlap = len(victim.generated)
            # the resume prompt changed, so its page hashes did too
            if hasattr(victim, "_page_hashes"):
                del victim._page_hashes
            # a mid-prefill victim restarts admission from scratch
            if getattr(victim, "_tail", None):
                victim._tail = None
                if victim in self._prefilling:
                    self._prefilling.remove(victim)
            self.pending.insert(0, victim)
            self._table_dirty = True
            self._masks_dirty = True
            self.metrics["preemptions"] = \
                self.metrics.get("preemptions", 0) + 1
        return True

    def _ensure_paged_capacity(self, n: int) -> int:
        """Grow every active slot to hold n more tokens, preempting if the
        pool runs dry. Returns the usable n (0 if nothing active)."""
        def pages_needed(n_try: int) -> int:
            total = 0
            for r in active:
                if r.slot < 0:
                    continue
                need_tok = min(int(self._len_host[r.slot]) + n_try,
                               self.max_seq)
                need_pages = self.pool.pages_for(need_tok)
                total += max(need_pages - len(self.pool.owned[r.slot]), 0)
            return total

        def try_grow(n_try: int) -> bool:
            # precheck against the pool so a doomed attempt allocates
            # NOTHING (available_pages counts refcount-0 cached pages too:
            # grow() reclaims them on demand)
            if pages_needed(n_try) > self.pool.available_pages:
                return False
            ver_before = self.pool.table_version
            ok = True
            for r in active:
                if r.slot < 0:
                    continue
                need = int(self._len_host[r.slot]) + n_try
                if not self.pool.grow(r.slot, min(need, self.max_seq)):
                    ok = False
                    break
            if self.pool.table_version != ver_before:
                self._table_dirty = True   # device copy is stale
            return ok

        while True:
            with self.lock:
                active = [r for r in self.slots if r is not None]
            if not active:
                return 0
            # prefer a smaller block over evicting someone
            n_try = n
            while n_try >= 1:
                if try_grow(n_try):
                    return n_try
                n_try //= 2
            if not self._preempt_one():
                # lone request can't grow: cap the block at the tokens its
                # current pages still hold (0 -> caller finishes it)
                slot = active[0].slot
                cap = len(self.pool.owned[slot]) * self.pool.page_size
                return max(min(n, cap - int(self._len_host[slot])), 0)

    def _sync_device_state(self, active_mask, temps):
        """Upload ONLY what went stale: the steady decode loop uploads
        nothing (lengths advance on the device; the page table and masks
        change only on admit/finish/preempt/page growth)."""
        paged = self.kv_layout == "paged"
        if paged and self._table_dirty:
            self._pt_dev = self._tensor(self.pool.table)
            self._table_dirty = False
        if self._masks_dirty:
            self._active_dev = self._tensor(active_mask)
            self._temps_dev = self._tensor(temps, torch.float32)
            if paged:
                self._len_dev = self._tensor(self._len_host)
            self._masks_dirty = False
        return self._active_dev

    def _snapshot(self):
        """(decode-ready requests, active mask, temps, occupied slots);
        caller holds self.lock."""
        active_reqs = [r for r in self.slots if self._decode_ready(r)]
        active_mask = np.array(
            [1 if self._decode_ready(s) else 0 for s in self.slots],
            np.int32)
        temps = np.zeros((self.max_slots,), np.float32)
        for r in active_reqs:
            temps[r.slot] = r.temperature
        occupied = sum(1 for s in self.slots if s is not None)
        return active_reqs, active_mask, temps, occupied

    def _emit_block(self, active_reqs, toks) -> None:
        """Hand a block of decoded tokens [n, slots] to its requests."""
        now = time.time()
        for r in list(active_reqs):
            for j in range(toks.shape[0]):
                if r.slot < 0:
                    break  # finished mid-block; surplus tokens dropped
                r.generated.append(int(toks[j, r.slot]))
                if r.first_token_time is None:   # defensive: admission
                    self._record_first_token(r, now)  # normally did this
                self.metrics["tokens_generated"] += 1
                self._m_tokens.inc()
                self._maybe_finish(r)
            r.progress.set()

    def step(self) -> int:
        """Admit + one decode step for all active slots. Returns the number
        of occupied slots after the step."""
        return self.step_n(1)

    def step_n(self, n: int = 8) -> int:
        """Admit, then run up to n decode steps with on-device sampling
        and one host fetch. n is clamped so no active slot can outrun its
        token budget or the cache, and rounded down to a power of two (the
        JAX engine's program buckets; kept so both engines take the same
        blocks)."""
        t_adm = time.time()
        self._admit()
        adm = time.time() - t_adm
        self.metrics["admit_s"] = self.metrics.get("admit_s", 0.0) + adm
        self._m_admit.inc(adm)
        with self.lock:
            active_reqs, active_mask, temps, occupied = self._snapshot()
        if not active_reqs:
            # mid-prefill slots may still be occupied: report them so
            # callers keep driving the engine
            return occupied
        n_eff = max(n, 1)
        for r in active_reqs:
            n_eff = min(n_eff,
                        r.max_new_tokens - len(r.generated),
                        self.max_seq - 1 - self._seq_len(r))
        b = 1
        while b * 2 <= n_eff:
            b *= 2
        n_eff = b
        if self.kv_layout == "paged":
            n_cap = self._ensure_paged_capacity(n_eff)
            if n_cap < 1:
                for r in list(active_reqs):
                    # page-capped truncation is an ERROR the client must
                    # see
                    r.max_new_tokens = len(r.generated)
                    r.error = ("generation truncated: KV page pool "
                               f"exhausted after {len(r.generated)} tokens")
                    self._maybe_finish(r)
                return 0
            while n_eff > n_cap:
                n_eff //= 2
            # capacity growth may have preempted a slot — re-snapshot
            with self.lock:
                active_reqs, active_mask, temps, occupied = self._snapshot()
            if not active_reqs:
                return occupied
        t_blk = time.time()
        act = self._sync_device_state(active_mask, temps)
        last, toks = self._last, []
        for _ in range(n_eff):
            if self.kv_layout == "paged":
                logits, _, _, self._len_dev = llama.decode_step_paged(
                    self.params, last, self.kp, self.vp, self._pt_dev,
                    self._len_dev, self.cfg, active=act)
            else:
                logits, self.cache = llama.decode_step(
                    self.params, last, self.cache, self.cfg, active=act)
            tok = self._sample(logits, self._temps_dev)
            last = tok[:, None].to(torch.int32)
            toks.append(tok)
        if self.kv_layout == "paged":
            self._len_host += active_mask.astype(np.int64) * n_eff
        self._last = last
        toks = torch.stack(toks).cpu().numpy()  # the block's one host fetch
        now = time.time()
        self.metrics["decode_block_s"] = \
            self.metrics.get("decode_block_s", 0.0) + (now - t_blk)
        self.metrics["decode_blocks"] = \
            self.metrics.get("decode_blocks", 0) + 1
        self.metrics["decode_block_tokens"] = \
            self.metrics.get("decode_block_tokens", 0) + n_eff
        self._m_decode_block.observe(now - t_blk)
        self._emit_block(active_reqs, toks)
        with self.lock:
            return sum(1 for s in self.slots if s is not None)

    def generate(self, prompt: List[int], max_new_tokens: int = 32,
                 temperature: float = 0.0, decode_block: int = 8) -> List[int]:
        """Synchronous convenience: submit + drive until done."""
        req = self.submit(prompt, max_new_tokens, temperature)
        while not req.done_event.is_set():
            self.step_n(decode_block)
        return req.generated

    # ---- disagg KV handoff -------------------------------------------------

    def _require_paged(self, what: str) -> None:
        if self.kv_layout != "paged":
            raise ValueError(f"{what} needs kv_layout='paged'")

    def export_kv_pages(self, pages: List[int]):
        """Host-side gather of physical KV pages for a prefill->decode
        handoff (paged layout only; call under self.lock so a reclaim
        can't recycle the pages mid-gather). Returns (k, v) CPU tensors
        shaped (n_layers, n_kv_heads, len(pages), page_size, head_dim) in
        the pool dtype."""
        self._require_paged("export_kv_pages")
        idx = self._tensor(pages, torch.long)
        return self.kp[:, :, idx].cpu(), self.vp[:, :, idx].cpu()

    def import_kv_pages(self, page_hashes: List[bytes], k, v) -> int:
        """Adopt externally-exported KV pages (tensors or numpy arrays as
        export_kv_pages returns): allocate physical pages, write the
        payload in one scatter per pool, and register them under their
        chain hashes so the next submit's _try_admit_cached adopts them
        with zero prefill compute. Returns the number of NEW pages written
        (already-registered hashes are reused, not rewritten)."""
        self._require_paged("import_kv_pages")
        with self.lock:
            pairs = self.pool.import_pages(list(page_hashes))
            new = [(i, p) for i, (p, is_new) in enumerate(pairs) if is_new]
            if not new:
                return 0
            sel = torch.as_tensor([i for i, _ in new], dtype=torch.long)
            idx = self._tensor([p for _, p in new], torch.long)
            self.kp[:, :, idx] = torch.as_tensor(k)[:, :, sel].to(
                self.device, self.kp.dtype)
            self.vp[:, :, idx] = torch.as_tensor(v)[:, :, sel].to(
                self.device, self.vp.dtype)
            return len(new)


class LLMServer:
    """Serve deployment hosting an engine; a background thread drives the
    decode loop so concurrent requests batch continuously.

    Threads and the card. Three threads touch an engine: the decode
    thread (``_loop``: prefill and decode, so the flash and paged kernels
    launch from it), the thread that constructs it (the replica's, or
    ``asyncio.to_thread`` for a multiplexed model) and the executor
    threads of the disaggregated handoff (``export_kv_pages`` /
    ``import_kv_pages`` under ``engine.lock``). PyTorch's current stream
    is per thread and starts as the device's default stream; nothing here
    sets another, so all three enqueue on the one default stream of the
    engine's device and see each other's work in order: a page exported
    after a decode step reads what that step wrote, and a page imported
    before an admission is on the device before the admission's kernels
    read it. The kernel wrappers launch on ``torch.cuda.current_stream``
    of their tensors' device, which is that stream.

    Engine kwargs (``device`` included) pass through ``**kw``; the
    replica's engine runs on ``resolve_device(device)``: CUDA unless the
    caller asks for the CPU. A replica needs no ``GPU`` resource unit to
    use the card, as JAX's replicas take ``jax.devices()[0]`` without a
    ``TPU`` unit: a deployment that wants the units asks for them in
    ``ray_actor_options``."""

    def __init__(self, preset: str = "tiny", max_slots: int = 8,
                 eos_token: int = -1, params=None, cfg=None,
                 decode_block: int = 8, mode: str = "monolithic",
                 group_pages: Optional[int] = None,
                 retained_groups: Optional[int] = None,
                 use_directory: bool = True,
                 multiplexed: bool = False,
                 max_models: Optional[int] = None,
                 models: Optional[Dict[str, dict]] = None, **kw):
        if mode not in ("monolithic", "prefill", "decode"):
            raise ValueError(f"unknown LLMServer mode {mode!r}")
        if multiplexed and mode != "monolithic":
            raise ValueError("model multiplexing needs mode='monolithic'")
        if mode != "monolithic":
            # disagg handoff is expressed in physical KV pages + chain
            # hashes: contiguous caches have neither
            kw.setdefault("kv_layout", "paged")
            if kw["kv_layout"] != "paged" or not kw.get("prefix_caching",
                                                        True):
                raise ValueError("disagg modes need kv_layout='paged' "
                                 "with prefix_caching on")
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _gc
        self.mode = mode
        self.group_pages = (group_pages if group_pages is not None
                            else _gc.serve_disagg_group_pages)
        self.retained_groups = (retained_groups if retained_groups
                                is not None
                                else _gc.serve_disagg_retained_groups)
        self.use_directory = use_directory
        self._exporter = None   # lazy: needs the in-actor runtime
        self._adopter = None
        self.engine = LLMEngine(cfg=cfg, params=params, preset=preset,
                                max_slots=max_slots, eos_token=eos_token, **kw)
        # --- model multiplexing (serve/multiplex.py) ------------------------
        # Model id "" (or absent) always means the default engine above;
        # named models resolve through a _ModelCache of per-model
        # LLMEngines bounded by serve_max_models_per_replica. The LRU's
        # unloader parks the evicted engine on `_retiring` so the decode
        # loop finishes its in-flight generations before dropping it —
        # evicting a busy model must not kill live streams.
        self.multiplexed = multiplexed
        self._engine_kwargs = dict(cfg=cfg, params=params, preset=preset,
                                   max_slots=max_slots, eos_token=eos_token,
                                   **kw)
        self._model_spec: Dict[str, dict] = dict(models or {})
        self._model_registry = None   # lazy: needs the in-actor runtime
        # `_retiring` is shared between the event-loop thread (unloader
        # appends) and the decode thread (filter-reassign): both sides
        # take this lock, or an engine appended mid-filter is lost and
        # its in-flight streams never step again
        self._retire_lock = threading.Lock()
        self._retiring: List[LLMEngine] = []
        self._unpublished: set = set()
        from ray_tpu_torch.serve.multiplex import _ModelCache
        self._models = _ModelCache(
            type(self)._load_model,
            max_models if max_models is not None
            else _gc.serve_max_models_per_replica,
            unloader=type(self)._unload_model)
        # fused decode steps per host sync (1 = lowest latency per token,
        # higher = fewer host round-trips; new arrivals wait at most one
        # block for admission)
        self.decode_block = decode_block
        self._wake = threading.Event()
        self._stop = False
        self._draining = False
        # decode-loop progress beacon: armed while the engine has
        # admitted work, ticked per decode block — a wedged device step
        # (or a deadlocked engine lock) flags as a StallEvent instead of
        # silently freezing every in-flight stream
        from ray_tpu_torch.observability import health as _health
        self._beacon = _health.beacon("serve:decode", deadline_s=30.0)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _engines(self) -> List["LLMEngine"]:
        """Every engine the decode loop must drive: default + resident
        multiplexed models + evicted-but-still-busy retirees. Runs on
        the decode thread while the event loop loads/evicts models, so
        it reads the cache's immutable snapshot — never the live
        OrderedDict."""
        engines = [self.engine]
        engines.extend(self._models.values_snapshot())
        with self._retire_lock:
            engines.extend(self._retiring)
        return engines

    def _loop(self):
        while not self._stop:
            worked = False
            try:
                for eng in self._engines():
                    if eng.has_work():
                        if not self._beacon.busy:
                            self._beacon.arm(queue=self.queue_len())
                        eng.step_n(self.decode_block)
                        self._beacon.tick()
                        worked = True
                if self._retiring:
                    # a retiree with no admitted work left has finished
                    # its in-flight generations; drop it (engine GC
                    # frees pages)
                    with self._retire_lock:
                        self._retiring = [e for e in self._retiring
                                          if e.has_work()]
            except Exception:
                # one engine's bad step must not kill the decode thread
                # — that would freeze every stream on the replica, not
                # just the failing one
                logger.exception("decode loop step failed; continuing")
                time.sleep(0.05)
                continue
            if not worked:
                self._beacon.disarm()
                self._wake.wait(timeout=0.01)
                self._wake.clear()
        self._beacon.disarm()

    # ---- model multiplexing ------------------------------------------------

    def _registry(self):
        if self._model_registry is None:
            from ray_tpu_torch.serve.multiplex import ModelRegistry
            self._model_registry = ModelRegistry()
        return self._model_registry

    def _fetch_published(self, model_id: str):
        """Blocking: resolve published weights from the object store.
        Returns None ONLY when the id is genuinely unpublished (the
        engine then inits from its preset/spec). Registry or fetch
        failures propagate so the load fails loudly — a transient store
        timeout must not silently serve default weights under the
        requested model id."""
        reg = self._registry()
        if not reg.contains(model_id):
            return None
        return reg.fetch(model_id)

    async def _load_model(self, model_id: str) -> "LLMEngine":
        """_ModelCache loader: build the per-model engine. Weights come
        from the ModelRegistry when published (one pinned store copy
        shared by every replica on the node); engine construction (the
        weights' placement on the device) runs off the event loop."""
        params = await asyncio.to_thread(self._fetch_published, model_id)
        kw = dict(self._engine_kwargs)
        kw.update(self._model_spec.get(model_id, {}))
        if params is not None:
            kw["params"] = params
        return await asyncio.to_thread(LLMEngine, **kw)

    def _unload_model(self, model_id: str, engine: "LLMEngine"):
        """_ModelCache unloader: retire, don't kill — the decode loop
        keeps driving the engine until its in-flight generations finish,
        then drops the last reference (page pool + weights free)."""
        with self._retire_lock:
            self._retiring.append(engine)
        self._wake.set()

    async def _engine_for(self, model_id: str) -> "LLMEngine":
        if not model_id:
            return self.engine
        if not self.multiplexed:
            raise LLMQueueFull(
                f"replica is not multiplexed; cannot serve model "
                f"{model_id!r}")
        eng = await self._models.get(self, model_id)
        self._wake.set()
        return eng

    async def load_model(self, model_id: str) -> List[str]:
        """Controller scale-up entry: warm-load `model_id` on this
        replica and (re)publish it to the router-visible set."""
        self._unpublished.discard(model_id)
        await self._engine_for(model_id)
        return self.loaded_models()

    def unpublish_model(self, model_id: str) -> bool:
        """Controller scale-down step 1: stop advertising the model so
        routers drain away; the engine stays resident until
        unload_model()."""
        if model_id in self._models.cache:
            self._unpublished.add(model_id)
            return True
        return False

    async def unload_model(self, model_id: str) -> bool:
        """Controller scale-down step 2 (after the per-model queue
        drains): evict the engine through the retiring path."""
        self._unpublished.discard(model_id)
        return await self._models.unload(self, model_id)

    def loaded_models(self) -> List[str]:
        """Models this replica ADVERTISES (resident minus draining) —
        what rides report_load to the router/controller."""
        return [m for m in self._models.models()
                if m not in self._unpublished]

    def model_queue_len(self, model_id: str) -> int:
        """Backlog of one model's engine (0 if not resident) — the
        controller's unpublish->drain->unload poll target."""
        eng = self._models.cache.get(model_id)
        if eng is None:
            return 0
        with eng.lock:
            return (len(eng.pending)
                    + sum(1 for s in eng.slots if s is not None))

    def model_stats(self) -> Dict[str, Any]:
        """Per-model view for the controller's autoscaler tick."""
        return {
            "models": self.loaded_models(),
            "resident": self._models.models(),
            "queues": {m: self.model_queue_len(m)
                       for m in self._models.models()},
            "loads": self._models.load_count,
            "evictions": self._models.eviction_count,
            "retiring": len(self._retiring),
            "draining": self._draining,
        }

    async def __call__(self, request) -> Dict[str, Any]:
        # handle-call payloads arrive as dicts; HTTP POSTs arrive as
        # http_proxy.Request objects (same duality stream_request handles)
        if not isinstance(request, dict):
            request = request.json()
        prompt = list(request["prompt"])
        from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id
        model = str(request.get("model") or get_multiplexed_model_id() or "")
        try:
            if self._draining:
                raise LLMQueueFull("replica draining; retry elsewhere")
            if model and model in self._unpublished:
                raise LLMQueueFull(f"model {model!r} draining on this "
                                   "replica; retry elsewhere")
            eng = await self._engine_for(model)
            req = eng.submit(prompt,
                             int(request.get("max_new_tokens", 32)),
                             float(request.get("temperature", 0.0)))
        except LLMQueueFull as e:
            from ray_tpu_torch.serve.http_proxy import Response

            return Response({"error": str(e)}, status_code=429,
                            headers={"Retry-After": "1"})
        except Exception as e:
            from ray_tpu_torch.serve.http_proxy import Response

            return Response({"error": f"model load failed: {e}"},
                            status_code=500)
        self._wake.set()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, req.done_event.wait)
        if req.error:
            from ray_tpu_torch.serve.http_proxy import Response

            return Response({"error": req.error}, status_code=400)
        ttft = (req.first_token_time - req.submit_time
                if req.first_token_time else None)
        return {"tokens": req.generated, "ttft_s": ttft}

    async def stream_request(self, request) -> Any:
        """Token-streaming endpoint (the proxy's streaming contract; ref:
        serve response streaming): yields each newly generated token batch
        as soon as the decode loop lands it, finishing with a stats line.
        `request` is an http_proxy.Request (?stream=1) or a plain dict
        (handle calls)."""
        body = request if isinstance(request, dict) else request.json()
        from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id
        model = str(body.get("model") or get_multiplexed_model_id() or "")
        try:
            if self._draining:
                raise LLMQueueFull("replica draining; retry elsewhere")
            if model and model in self._unpublished:
                raise LLMQueueFull(f"model {model!r} draining on this "
                                   "replica; retry elsewhere")
            eng = await self._engine_for(model)
            req = eng.submit(list(body["prompt"]),
                             int(body.get("max_new_tokens", 32)),
                             float(body.get("temperature", 0.0)))
        except LLMQueueFull as e:
            # streaming contract has no status line mid-stream: shed as a
            # typed first frame so clients can back off like on the 429
            yield {"error": str(e), "status": 429, "done": True}
            return
        except Exception as e:
            # model load failed: typed 503 first frame — the router
            # avoids this replica and retries the stream elsewhere
            yield {"error": f"model load failed: {e}", "status": 503,
                   "done": True}
            return
        self._wake.set()
        loop = asyncio.get_running_loop()
        # stream-progress beacon (shared across this replica's streams):
        # ticked per yielded frame, armed while any stream is waiting on
        # the decode loop — no frames across the deadline = stall
        from ray_tpu_torch.observability import health as _health
        sbeacon = _health.beacon("serve:stream", deadline_s=60.0)
        if not sbeacon.busy:
            sbeacon.arm(streaming=True)
        cursor = 0
        while True:
            new = req.generated[cursor:]
            if new:
                cursor += len(new)
                sbeacon.tick()
                yield {"tokens": new}
            elif req.done_event.is_set():
                # done was observed AFTER an empty snapshot; tokens may
                # have landed between the two — drain once more
                new = req.generated[cursor:]
                if new:
                    cursor += len(new)
                    yield {"tokens": new}
                break
            else:
                req.progress.clear()
                if len(req.generated) > cursor or req.done_event.is_set():
                    continue   # progress raced the clear
                await loop.run_in_executor(None, req.progress.wait, 1.0)
        ttft = (req.first_token_time - req.submit_time
                if req.first_token_time else None)
        sbeacon.tick()
        sbeacon.disarm()
        out = {"done": True, "n_tokens": cursor, "ttft_s": ttft}
        if req.error:
            out["error"] = req.error
        yield out

    # ---- disaggregated serving (serve/disagg.py) ---------------------------

    def _ensure_transfer(self):
        """Lazily build the kv_transfer plumbing — both ends need the
        in-actor runtime (zero-copy put/get + gcs_call)."""
        from ray_tpu_torch.serve.kv_transfer import (HandoffAdopter,
                                               HandoffExporter,
                                               PrefixDirectory)
        if self._adopter is None:
            self._adopter = HandoffAdopter()
        if self._exporter is None and self.mode == "prefill":
            import uuid
            directory = PrefixDirectory() if self.use_directory else None
            self._exporter = HandoffExporter(
                owner=f"llm-{uuid.uuid4().hex[:12]}",
                page_tokens=self.engine.pool.page_size,
                group_pages=self.group_pages,
                retained_groups=self.retained_groups,
                directory=directory)

    async def prefill_request(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """mode="prefill": fill the prompt's KV pages (one generated
        token's worth of engine work — prefill + registration; the token
        is discarded, decode regenerates it bitwise-identically at
        temperature 0), export the leading full page GROUPS through the
        zero-copy store, and return the handoff envelope."""
        assert self.mode == "prefill", self.mode
        self._ensure_transfer()
        body = body if isinstance(body, dict) else body.json()
        prompt = list(body["prompt"])
        res = await self.__call__({"prompt": prompt, "max_new_tokens": 1,
                                   "temperature": 0.0})
        if not isinstance(res, dict):   # Response: shed or engine error
            status = getattr(res, "status_code", 500)
            return {"error": (res.body or {}).get("error", "prefill failed"),
                    "status": status}
        eng = self.engine
        ps = eng.pool.page_size
        per_page = page_chain_hashes(prompt, ps)
        with eng.lock:
            cached = eng.pool.match_prefix(per_page)
        # export only groups whose every page is registered (admission
        # keeps >=1 tail token un-paged, so the final partial group
        # never exports — the decode side tail-prefills it)
        n_groups = len(cached) // self.group_pages
        export_tokens = prompt[:n_groups * self.group_pages * ps]

        def payload_for_group(s: int, e: int) -> dict:
            p0, p1 = s // ps, e // ps
            with eng.lock:
                pages = eng.pool.match_prefix(per_page[:p1])[p0:p1]
                if len(pages) != p1 - p0:
                    raise RuntimeError("page group evicted before export")
                k, v = eng.export_kv_pages(pages)
            return {"k": k, "v": v, "page_hashes": per_page[p0:p1]}

        # store puts + directory registration are blocking runtime calls
        # — banned on the event-loop thread (raylint blocking-in-async)
        envelope = await asyncio.to_thread(
            self._exporter.export,
            export_tokens, payload_for_group,
            lambda p: int(p["k"].nbytes) + int(p["v"].nbytes),
            prompt_len=len(prompt))
        return {"envelope": envelope,
                "matched_tokens": len(export_tokens)}

    def ack_handoff(self, handoff_id: str) -> bool:
        if self._exporter is None:
            return False
        return self._exporter.ack(handoff_id)

    async def adopt_decode(self, envelope: Dict[str, Any], body) -> Any:
        """mode="decode": map the envelope's page groups in from the
        store (engine.import_kv_pages — registered + evictable, no
        prefill compute), then serve the request through the normal
        streaming path: admission's _try_admit_cached adopts the
        imported pages and only the un-paged tail prefills."""
        assert self.mode == "decode", self.mode
        self._ensure_transfer()
        try:
            # blocking zero-copy gets: executor thread, not the loop
            payloads = await asyncio.to_thread(self._adopter.adopt, envelope)
            for payload in payloads:
                self.engine.import_kv_pages(payload["page_hashes"],
                                            payload["k"], payload["v"])
        except Exception:
            # exporter (or its store) died before we mapped the pages
            # in: tell the router to re-prefill on a survivor
            yield {"handoff_lost": True, "done": True}
            return
        async for frame in self.stream_request(body):
            if isinstance(frame, dict) and frame.get("done") \
                    and "handoff_id" not in frame and not frame.get("error"):
                frame = dict(frame)
                frame["handoff_id"] = envelope.get("handoff_id")
            yield frame

    def queue_len(self) -> int:
        """Engine-side backlog: requests queued for admission plus slots
        mid-generation. The serve Replica adds this to its own RPC
        in-flight count, so the controller's autoscaler and the LLM
        router's pressure score both see work the engine has ACCEPTED
        but not finished — not just the RPCs currently parked in
        stream_request. Multiplexed replicas sum across every engine
        (default + per-model + retiring)."""
        total = 0
        for eng in self._engines():
            with eng.lock:
                total += (len(eng.pending)
                          + sum(1 for s in eng.slots if s is not None))
        return total

    def drain(self) -> None:
        """Stop accepting new work; in-flight generations run to
        completion. New submissions shed with LLMQueueFull, which the
        LLM router reads as 'route elsewhere' — the scale-down protocol
        (ServeController._drain_then_kill) then polls queue_len() to 0
        before killing the actor."""
        self._draining = True
        if self._exporter is not None:
            # unpin retained + in-flight page groups and withdraw our
            # global-directory entries before the controller kills us
            self._exporter.close()

    def stats(self) -> Dict[str, Any]:
        m = dict(self.engine.metrics)
        with self.engine.lock:
            m["pending"] = len(self.engine.pending)
            m["active_slots"] = sum(
                1 for s in self.engine.slots if s is not None)
            m["max_slots"] = self.engine.max_slots
        m["draining"] = self._draining
        m["mode"] = self.mode
        if self.multiplexed:
            # advertised set + per-model backlog: the router folds these
            # into its stats map (warm-replica routing) and report_load
            # (per-model autoscaling)
            m["models"] = self.loaded_models()
            m["model_queue"] = {mm: self.model_queue_len(mm)
                                for mm in self._models.models()}
            m["model_loads"] = self._models.load_count
            m["model_evictions"] = self._models.eviction_count
        if self._exporter is not None:
            m.update({f"handoff_{k}": v
                      for k, v in self._exporter.stats().items()})
        if self._adopter is not None:
            m.update({f"adopt_{k}": v
                      for k, v in self._adopter.stats().items()})
        if m["ttft_count"]:
            m["mean_ttft_s"] = m["ttft_sum"] / m["ttft_count"]
            p50 = self.engine._m_ttft.quantile(0.5)
            if p50 is not None:
                m["ttft_p50_s"] = p50
                m["ttft_p99_s"] = self.engine._m_ttft.quantile(0.99)
        if getattr(self.engine, "pool", None) is not None:
            m["prefix_cache"] = self.engine.pool.cache_stats()
        return m
