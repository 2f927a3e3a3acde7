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
beside the local ``metrics`` dict, as JAX's engine does. Not ported yet
(ROADMAP.md queue 1 item 6): ``LLMServer``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.paged_kv import PagePool, page_chain_hashes


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
