"""Group bootstrap + the peer-to-peer transport every backend rides.

Two kinds of helper actors per group:

- one ``_Coordinator`` (created by rank 0, named ``_collective_{group}``)
  — the legacy gather/broadcast rendezvous. It doubles as the bootstrap
  barrier: every rank allgathers its (node id, mailbox handle) through
  it once, which yields the membership table the ``Topology`` and the
  peer-to-peer backends are built from.
- one ``_Mailbox`` per rank (named ``_collective_{group}_mbx{rank}``) —
  a keyed async slot store. Ring/hierarchical backends move chunks by
  pushing into the *receiver's* mailbox (object-store peer-to-peer:
  sender worker → receiver-mailbox worker, no global fan-in point) and
  the receiver draining its own mailbox. Every ``take`` carries a
  server-side timeout so a dead sender can never park a round forever.

Failure detection: a timed-out ``take``/``exchange`` returns a sentinel
instead of blocking; the client then pings every peer mailbox and raises
``CollectiveTimeoutError`` naming the unresponsive ranks.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.collective.errors import CollectiveError, CollectiveTimeoutError
from ray_tpu_torch.collective.topology import Topology
from ray_tpu_torch.observability import health as _health
from ray_tpu_torch.observability import memory as _memory
from ray_tpu_torch.observability.edges import record_transfer

#: Sentinel dict key marking a server-side timeout reply.
TIMEOUT_KEY = "__col_timeout__"
#: Sentinel dict key marking a zero-copy envelope: the mailbox carries
#: only {ZC_KEY: True, "ref": ObjectRef, "nbytes": n}; the bulk bytes sit
#: in the object store and the receiver resolves them via the pinned
#: zero-copy local read (core/runtime.py _ReadPin).
ZC_KEY = "__col_zc_ref__"
#: Receiver → sender ack keys (sender frees its pinned chunk copy on ack).
ACK_PREFIX = "__ack__:"
#: Sender-side cap on unacked zero-copy bytes before send() blocks on a
#: bounded ack reap — bounds store usage for a peer that drains slowly.
ZC_WINDOW_BYTES = 64 * 1024 * 1024

#: the CPU each helper actor (a rank's mailbox, the group's coordinator)
#: asks for: fractional, so that helpers lane-pack into shared workers
HELPER_CPUS = 0.01


def _is_timeout(v) -> bool:
    return isinstance(v, dict) and TIMEOUT_KEY in v


def _is_zc(v) -> bool:
    return isinstance(v, dict) and ZC_KEY in v


# --------------------------------------------------------------------------
# helper actors
# --------------------------------------------------------------------------


@ray_tpu_torch.remote
class _Mailbox:
    """Keyed rendezvous slots for one rank's inbound collective traffic.

    Methods are deliberately SYNCHRONOUS: with max_concurrency > 1 they
    run on the worker's executor threads, where blocking is allowed —
    packaging a large return pins it in the object store via a blocking
    nodelet RPC, which the runtime forbids on the event-loop thread (an
    async ``take`` returning a big chunk would trip that guard)."""

    def __init__(self):
        import threading

        self.slots: Dict[str, Any] = {}
        self.cv = threading.Condition()

    def put(self, key: str, value) -> bool:
        with self.cv:
            self.slots[key] = value
            self.cv.notify_all()
        return True

    def put_many(self, items: Dict[str, Any]) -> bool:
        """One RPC delivers a whole wave of keyed slots (a ring step's
        pipeline_chunks sub-chunks) instead of one actor call each."""
        with self.cv:
            self.slots.update(items)
            self.cv.notify_all()
        return True

    def take(self, key: str, timeout_s: float):
        """Block until `key` arrives (or time out → sentinel), then pop it."""
        with self.cv:
            if not self.cv.wait_for(lambda: key in self.slots,
                                    timeout=timeout_s):
                return {TIMEOUT_KEY: key}
            return self.slots.pop(key)

    def drain(self, prefix: str, timeout_s: float = 0.0) -> List[str]:
        """Pop and return every key starting with `prefix` (ack reaping).
        With timeout_s > 0 blocks until at least one match (or timeout)."""
        with self.cv:
            if timeout_s > 0:
                self.cv.wait_for(
                    lambda: any(k.startswith(prefix) for k in self.slots),
                    timeout=timeout_s)
            keys = [k for k in self.slots if k.startswith(prefix)]
            for k in keys:
                del self.slots[k]
            return keys

    def ping(self) -> bool:
        return True


@ray_tpu_torch.remote
class _Coordinator:
    """Gather-style rendezvous: every rank contributes, everyone gets the
    combined result (the legacy O(world × bytes) funnel — kept as the
    ``gather`` backend and as the bootstrap allgather)."""

    def __init__(self, world_size: int):
        import threading

        self.world = world_size
        self.rounds: Dict[tuple, dict] = {}
        self.cv = threading.Condition()
        self.bytes_in = 0          # transfer accounting: fan-in volume

    def exchange(self, op: str, seq: int, rank: int, data,
                 timeout_s: float = 300.0):
        """All ranks call with their contribution; returns the combined
        result once everyone arrived, or a timeout sentinel naming the
        ranks that never showed up. Synchronous on purpose — see _Mailbox
        (large combined results must be packaged off the event loop)."""
        key = (op, seq)
        # payload_nbytes, not ndarray-only: gather's fan-in volume must
        # stay honest for lists/dicts/pytrees too (bench + tests assert it)
        self.bytes_in += payload_nbytes(data)
        with self.cv:
            slot = self.rounds.setdefault(key, {"parts": {}, "result": None})
            slot["parts"][rank] = data
            if len(slot["parts"]) == self.world:
                slot["result"] = self._combine(op, slot["parts"])
                self.cv.notify_all()
            else:
                def done():
                    s = self.rounds.get(key)
                    return s is None or s["result"] is not None

                if not self.cv.wait_for(done, timeout=timeout_s):
                    missing = [r for r in range(self.world)
                               if r not in slot["parts"]]
                    return {TIMEOUT_KEY: missing}
            result = self.rounds[key]["result"][rank]
            slot["parts"].pop(rank, None)
            if not slot["parts"]:
                self.rounds.pop(key, None)
            return result

    def _combine(self, op: str, parts_by_rank: Dict[int, Any]) -> list:
        parts = [parts_by_rank[r] for r in range(self.world)]
        if op == "allreduce_sum":
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return [out] * self.world
        if op == "allgather":
            return [list(parts)] * self.world
        if op == "barrier":
            return [True] * self.world
        if op == "broadcast":
            srcs = [p for p in parts if p is not None]
            if not srcs:
                # every rank passed None: a bare StopIteration here would
                # vanish inside the async handler — name the misuse
                raise ValueError(
                    "broadcast: no source rank provided data")
            return [srcs[0]] * self.world
        if op == "reducescatter":
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return list(np.array_split(total, self.world))
        raise ValueError(op)

    def stats(self) -> dict:
        return {"bytes_in": self.bytes_in}

    def ping(self) -> bool:
        return True


# --------------------------------------------------------------------------
# transfer accounting
# --------------------------------------------------------------------------


#: One priced exemplar per unknown type — pickling EVERY send's payload
#: to size it was a per-call hot spot; sizes within a type are close
#: enough for accounting, and the cache is bounded.
_FALLBACK_NBYTES: Dict[type, int] = {}
_FALLBACK_NBYTES_MAX = 256


def payload_nbytes(obj) -> int:
    """Approximate wire size of a collective payload.

    Fast paths cover everything the transport actually moves (ndarray,
    bytes, zero-copy envelopes, containers of those); arbitrary objects
    are priced by pickling one exemplar per type (bounded cache) instead
    of pickling on every send."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, memoryview):
        return int(obj.nbytes)
    if obj is None or isinstance(obj, (bool, int, float)):
        return 8
    if isinstance(obj, str):
        return 8 + len(obj)
    if isinstance(obj, dict):
        if ZC_KEY in obj:
            # zero-copy envelope: the wire carries a tiny ref, but the
            # TRANSFER is the chunk it names — account the chunk
            try:
                return int(obj["nbytes"])
            except (KeyError, TypeError, ValueError):
                pass
        return sum(payload_nbytes(o) for o in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(payload_nbytes(o) for o in obj)
    t = type(obj)
    n = _FALLBACK_NBYTES.get(t)
    if n is None:
        try:
            n = len(pickle.dumps(obj, protocol=5))
        except Exception:
            n = 64
        if len(_FALLBACK_NBYTES) < _FALLBACK_NBYTES_MAX:
            _FALLBACK_NBYTES[t] = n
    return n


class TransferStats:
    """Per-rank byte accounting — the hook the bandwidth-optimality tests
    and ``bench.py --bench collective`` assert against."""

    def __init__(self):
        self.bytes_sent = 0          # total payload bytes this rank pushed
        self.bytes_sent_inter = 0    # subset that crossed a node boundary
        self.bytes_recv = 0
        self.sends = 0
        self.recvs = 0
        self.zc_sends = 0            # sends that rode the zero-copy tier
        self.zc_bytes_sent = 0       # ...and their payload bytes
        self.eager_sends = 0         # sends that rode the inline mailbox
        self.coord_sends = 0         # coordinator exchanges (gather/boot)

    def snapshot(self) -> dict:
        return {"bytes_sent": self.bytes_sent,
                "bytes_sent_inter": self.bytes_sent_inter,
                "bytes_recv": self.bytes_recv,
                "sends": self.sends, "recvs": self.recvs,
                "zc_sends": self.zc_sends,
                "zc_bytes_sent": self.zc_bytes_sent,
                "eager_sends": self.eager_sends,
                "coord_sends": self.coord_sends}

    def reset(self):
        self.__init__()


# --------------------------------------------------------------------------
# group context
# --------------------------------------------------------------------------


def _actor_name(group: str, suffix: str = "") -> str:
    return f"_collective_{group}{suffix}"


def _current_config():
    """The live runtime's Config (workers inherit init()'s system config
    via the nodelet spawn), or the env-layer GLOBAL_CONFIG outside one."""
    from ray_tpu_torch.core import runtime as rt

    r = rt.current_runtime_or_none()
    if r is not None and getattr(r, "cfg", None) is not None:
        return r.cfg
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG


def _resolve_named(name: str, deadline_s: float = 30.0):
    deadline = time.time() + deadline_s
    while True:
        try:
            return ray_tpu_torch.get_actor(name)
        except ValueError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


class GroupContext:
    """One rank's view of a collective group: membership, topology,
    mailbox handles, sequencing, transfer accounting.

    Ops must be issued in the same order on every rank (standard
    collective contract); ``seq`` ties the rounds together.
    """

    #: transport → (eager_threshold, zerocopy_threshold) overrides; None
    #: means "take it from Config". zerocopy_threshold None disables the
    #: zero-copy tier entirely; eager 1<<62 forces everything inline.
    TRANSPORTS = ("auto", "mailbox", "zerocopy", "eager")

    def __init__(self, name: str, world_size: int, rank: int,
                 timeout_s: float = 60.0, transport: str = "auto"):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world of {world_size}")
        if transport not in self.TRANSPORTS:
            raise ValueError(f"unknown collective transport {transport!r}; "
                             f"one of {self.TRANSPORTS}")
        self.name = name
        self.world = world_size
        self.rank = rank
        self.timeout_s = float(timeout_s)
        self.seq = 0
        self.stats = TransferStats()
        self.mailboxes: Dict[int, Any] = {}
        self.transport = transport
        cfg = _current_config()
        if transport == "mailbox":        # the pre-zero-copy transport
            self.eager_threshold, self.zc_threshold = 0, None
        elif transport == "eager":        # everything one inline message
            self.eager_threshold, self.zc_threshold = 1 << 62, None
        elif transport == "zerocopy":     # every ndarray/bytes chunk via ref
            self.eager_threshold, self.zc_threshold = 0, 1
        else:
            self.eager_threshold = int(cfg.collective_eager_threshold_bytes)
            zc = int(cfg.collective_zerocopy_threshold_bytes)
            self.zc_threshold = zc if zc > 0 else None
        #: unacked zero-copy chunks this rank put(): key → (ref, nbytes,
        #: waiter_rank). The ref pins the store copy until the receiver's
        #: resolve ack — explicit lifetime instead of racing the
        #: borrower handoff.
        self._zc_inflight: Dict[str, Tuple[Any, int, int]] = {}
        self._zc_bytes = 0
        # Measured coordinator-funnel model (feeds the cost-based backend
        # auto-selector): RTT EWMA from small exchanges, effective funnel
        # bandwidth from bulk ones.
        self.coord_lat_ewma: Optional[float] = None
        self.coord_bw_ewma: Optional[float] = None
        # Progress beacon for the watchdog (observability/health.py):
        # armed around every blocking wait with the op + rank it waits
        # on, so a hung round is flagged as a StallEvent naming the
        # suspect rank — typically long before timeout_s fires.
        self._beacon = _health.beacon(
            f"collective:{name}:r{rank}",
            deadline_s=float(cfg.collective_stall_deadline_s))

        coord_name = _actor_name(name)
        mbx_name = _actor_name(name, f"_mbx{rank}")
        # Own mailbox first (peers resolve it by name), then rank 0 brings
        # up the coordinator everyone bootstraps through.
        # Fractional CPU on purpose: 0 < cpu < 1 makes helper actors
        # lane-packable (nodelet._laneable) so a group's whole helper
        # fleet shares one worker process instead of each holding a
        # max_workers_per_node slot — many live groups would otherwise
        # exhaust the worker cap and wedge the next group's bootstrap.
        self.mailbox = _Mailbox.options(
            name=mbx_name, num_cpus=HELPER_CPUS,
            max_concurrency=max(4 * world_size, 16)).remote()
        if rank == 0:
            try:
                self.coord = _Coordinator.options(
                    name=coord_name, num_cpus=HELPER_CPUS,
                    max_concurrency=max(world_size * 2, 4)).remote(world_size)
            except ValueError:
                self.coord = _resolve_named(coord_name)
        else:
            self.coord = _resolve_named(coord_name)
        self._await_helpers(self.timeout_s)

        try:
            node_id = ray_tpu_torch.get_runtime_context().get_node_id()
        except Exception:
            node_id = "local"
        # Bootstrap budget is deliberately generous: joining can pay for
        # several fresh worker-process spawns (~5 s of framework import each,
        # more on a loaded box) before the first rank even registers.
        table = self.coord_exchange(
            "allgather", {"rank": rank, "node": node_id,
                          "mailbox": self.mailbox},
            timeout_s=max(self.timeout_s, 120.0))
        self.mailboxes = {e["rank"]: e["mailbox"] for e in table}
        self.topology = Topology.build({e["rank"]: e["node"] for e in table})

    def _await_helpers(self, limit_s: float) -> None:
        """Wait up to `limit_s` for this rank's mailbox and the group's
        coordinator to answer a ping. Each asks for HELPER_CPUS, so none
        is placed while every CPU is held (a gang whose workers take
        every CPU): the wait then raises a CollectiveError naming the
        shortfall, where the bootstrap allgather would block for its own
        much longer budget and name no cause."""
        pings = {"mailbox": self.mailbox.ping.remote(),
                 "coordinator": self.coord.ping.remote()}
        ready, _ = ray_tpu_torch.wait(list(pings.values()),
                                      num_returns=len(pings),
                                      timeout=limit_s)
        ready_ids = {r.id for r in ready}
        missing = [what for what, r in pings.items()
                   if r.id not in ready_ids]
        if not missing:
            return
        for helper in (self.mailbox, self.coord if self.rank == 0 else None):
            try:
                if helper is not None:
                    ray_tpu_torch.kill(helper)
            except Exception:
                pass
        try:
            free = f"{ray_tpu_torch.available_resources().get('CPU', 0.0):g}"
        except Exception:
            free = "an unknown amount of"
        raise CollectiveError(
            f"collective group {self.name!r} rank {self.rank}: its "
            f"{' and '.join(missing)} actor(s) were not placed within "
            f"{limit_s:.1f}s. Each needs {HELPER_CPUS} CPU and the cluster "
            f"has {free} CPU free: the gang's workers (or other actors) "
            "hold every CPU. Leave a CPU free or give the workers less.",
            group_name=self.name, op="bootstrap")

    # -- coordinator path (gather backend + bootstrap) -------------------

    def coord_exchange(self, op: str, data, timeout_s: Optional[float] = None):
        t = self.timeout_s if timeout_s is None else timeout_s
        self.seq += 1
        n = payload_nbytes(data)
        self.stats.bytes_sent += n
        self.stats.sends += 1
        self.stats.coord_sends += 1
        t0 = time.perf_counter()
        self._beacon.arm(op=op, seq=self.seq, phase="coord",
                         waiting_on="coordinator")
        try:
            out = self._checked_get(
                self.coord.exchange.remote(op, self.seq, self.rank, data, t),
                op=op, budget_s=t)
        finally:
            self._beacon.tick()
            self._beacon.disarm()
        if _is_timeout(out):
            self._flight_dump(f"collective:{op}:coord_timeout",
                              suspect_ranks=out[TIMEOUT_KEY], seq=self.seq)
            raise CollectiveTimeoutError(
                f"collective {op} (group {self.name!r}, seq {self.seq}) "
                f"timed out after {t:.1f}s waiting for ranks {out[TIMEOUT_KEY]}",
                group_name=self.name, op=op, suspect_ranks=out[TIMEOUT_KEY])
        self._observe_coord(n, time.perf_counter() - t0)
        return out

    def _observe_coord(self, nbytes: int, dt: float) -> None:
        """Fold one funnel round into the measured coordinator model the
        cost-based auto-selector prices the gather backend with. The
        bootstrap allgather (seq 1) is excluded — it pays actor spawns,
        not transport."""
        if self.seq <= 1 or dt <= 0:
            return
        a = 0.25
        if nbytes < 4096:
            # small exchange ≈ pure rendezvous RTT (still includes rank
            # skew, which a real gather round pays too)
            self.coord_lat_ewma = (dt if self.coord_lat_ewma is None
                                   else a * dt + (1 - a) * self.coord_lat_ewma)
        elif nbytes >= 64 * 1024:
            # funnel serializes world×bytes in and out of one process;
            # invert the gather cost model for effective bandwidth
            bw = (2.0 * self.world * nbytes) / dt
            self.coord_bw_ewma = (bw if self.coord_bw_ewma is None
                                  else a * bw + (1 - a) * self.coord_bw_ewma)

    # -- peer-to-peer path (ring / hier backends) ------------------------

    def _zc_eligible(self, payload, n: int) -> bool:
        return (self.zc_threshold is not None and n >= self.zc_threshold
                and isinstance(payload, (np.ndarray, bytes, bytearray)))

    def _reap_zc_acks(self, block: bool = False) -> None:
        """Free chunks whose receivers acked their resolve. Non-blocking
        at op boundaries; when the unacked window overflows, block with a
        hard deadline (a wedged peer surfaces as ITS timeout, not as this
        rank parking forever in a reap)."""
        if not self._zc_inflight:
            return
        deadline = time.monotonic() + (min(10.0, self.timeout_s) if block
                                       else 0.0)
        while True:
            wait = min(0.25, max(0.0, deadline - time.monotonic()))
            try:
                keys = ray_tpu_torch.get(
                    self.mailbox.drain.remote(ACK_PREFIX, wait),
                    timeout=30.0)
            except Exception:
                return               # mailbox gone: destroy() will clear
            for k in keys:
                entry = self._zc_inflight.pop(k[len(ACK_PREFIX):], None)
                if entry is not None:
                    self._zc_bytes -= entry[1]
                    _memory.tracker().unpin(entry[0].id, "await_ack")
            if (not block or self._zc_bytes <= ZC_WINDOW_BYTES
                    or time.monotonic() >= deadline):
                return

    def _tag_staged(self, ref, n: int, key: str, waiter_rank: int) -> None:
        """Attribute a staged zero-copy chunk to the collective subsystem
        and pin it with the ack it waits on — `cli blackbox` / the memory
        report then name exactly which ack a stuck pinned chunk is missing
        (and which rank owes it)."""
        mem = _memory.tracker()
        mem.retag(ref.id, "collective", group=self.name, ack_key=key)
        mem.pin(ref.id, "await_ack", ack_key=key, waiter_rank=waiter_rank)

    def _stage_payload(self, key: str, payload, n: int, hops: int = 1,
                       dst_rank: int = -1):
        """Pick the wire form for one payload: zero-copy envelope (ref
        into the object store) or the inline value itself.

        `hops > 1` declares a multi-hop envelope (ring all-gather): the
        ref will be forwarded hop-to-hop and only the FINAL receiver
        acks, to this rank's mailbox under `ack_key` — forwarding is
        sequential, so the last hop resolving implies every earlier hop
        did too. The staged ref stays pinned until that single ack."""
        if not self._zc_eligible(payload, n):
            self.stats.eager_sends += 1
            return payload
        if self._zc_bytes > ZC_WINDOW_BYTES:
            self._reap_zc_acks(block=True)
        ref = ray_tpu_torch.put(payload)
        self._zc_inflight[key] = (ref, n, dst_rank)
        self._zc_bytes += n
        self.stats.zc_sends += 1
        self.stats.zc_bytes_sent += n
        self._tag_staged(ref, n, key, dst_rank)
        return {ZC_KEY: True, "ref": ref, "nbytes": n,
                "owner": self.rank, "ack_key": key, "hops": hops}

    def send(self, dst_rank: int, key: str, payload) -> None:
        """Fire-and-forget push into dst's mailbox (object-store p2p).

        Bulk ndarray/bytes payloads at or above zc_threshold take the
        zero-copy tier: one put() into the store, only the ObjectRef
        rides the mailbox actor; the store copy stays pinned in
        _zc_inflight until the receiver acks its resolve."""
        n = payload_nbytes(payload)
        self.stats.bytes_sent += n
        self.stats.sends += 1
        if self.topology.node_of(dst_rank) != self.topology.node_of(self.rank):
            self.stats.bytes_sent_inter += n
        value = self._stage_payload(key, payload, n, dst_rank=dst_rank)
        # a lost put surfaces as the receiver's timeout + peer probe
        # raylint: disable=leaked-object-ref -- fire-and-forget by design
        self.mailboxes[dst_rank].put.remote(key, value)

    def send_many(self, dst_rank: int, items: Sequence[Tuple[str, Any]],
                  hops: int = 1) -> None:
        """send() for a wave of keyed payloads (one ring step's sub-
        chunks): the zero-copy puts batch into ONE nodelet pin RPC and
        the whole wave rides ONE mailbox put_many call. `hops` is the
        multi-hop envelope declaration (see _stage_payload)."""
        inter = (self.topology.node_of(dst_rank)
                 != self.topology.node_of(self.rank))
        entries: Dict[str, Any] = {}
        zc_wave: List[Tuple[str, Any, int]] = []
        for key, payload in items:
            n = payload_nbytes(payload)
            self.stats.bytes_sent += n
            self.stats.sends += 1
            if inter:
                self.stats.bytes_sent_inter += n
            if self._zc_eligible(payload, n):
                zc_wave.append((key, payload, n))
            else:
                self.stats.eager_sends += 1
                entries[key] = payload
        if zc_wave:
            if self._zc_bytes > ZC_WINDOW_BYTES:
                self._reap_zc_acks(block=True)
            from ray_tpu_torch.core import runtime as rt

            r = rt.current_runtime_or_none()
            if r is not None:
                refs = r.put_batch([p for _, p, _ in zc_wave])
            else:
                refs = [ray_tpu_torch.put(p) for _, p, _ in zc_wave]
            for (key, _, n), ref in zip(zc_wave, refs):
                self._zc_inflight[key] = (ref, n, dst_rank)
                self._zc_bytes += n
                self.stats.zc_sends += 1
                self.stats.zc_bytes_sent += n
                self._tag_staged(ref, n, key, dst_rank)
                entries[key] = {ZC_KEY: True, "ref": ref, "nbytes": n,
                                "owner": self.rank, "ack_key": key,
                                "hops": hops}
        # raylint: disable=leaked-object-ref -- fire-and-forget by design
        self.mailboxes[dst_rank].put_many.remote(entries)

    def recv(self, src_rank: int, key: str, *, op: str = ""):
        """Blocking take from OWN mailbox of the value `src_rank` pushed.

        A zero-copy envelope is resolved through the pinned local read
        (same-node: zero-copy numpy view over shm; cross-node: nodelet
        pull), then acked back to the OWNER's mailbox so it can free its
        pinned copy — the ack only fires after a successful resolve."""
        return self.recv_fwd(src_rank, key, op=op)[0]

    def forward(self, dst_rank: int, key: str, env: dict) -> None:
        """Relay a still-live zero-copy envelope to the next hop without
        re-staging the payload: the SAME ObjectRef rides on, with `hops`
        decremented so the final receiver knows to ack the owner. Only
        valid for an envelope recv_fwd returned with hops > 1 (i.e. not
        yet acked); the bytes count as sent — the ref logically carries
        them — which keeps the ring bandwidth-optimality accounting."""
        n = int(env["nbytes"])
        self.stats.bytes_sent += n
        self.stats.sends += 1
        self.stats.zc_sends += 1
        self.stats.zc_bytes_sent += n
        if self.topology.node_of(dst_rank) != self.topology.node_of(self.rank):
            self.stats.bytes_sent_inter += n
        # raylint: disable=leaked-object-ref -- fire-and-forget by design
        self.mailboxes[dst_rank].put.remote(
            key, dict(env, hops=int(env["hops"]) - 1))

    def recv_fwd(self, src_rank: int, key: str, *, op: str = ""):
        """recv() that also returns the zero-copy envelope (or None for
        inline payloads). An envelope with hops > 1 has NOT been acked:
        the caller MUST forward() it onward — the downstream ranks and
        the owner's pinned copy are waiting on that chain."""
        t0 = time.perf_counter()
        self._beacon.arm(op=op, seq=self.seq, key=key,
                         waiting_on_rank=src_rank)
        try:
            out = self._checked_get(
                self.mailbox.take.remote(key, self.timeout_s),
                op=op, budget_s=self.timeout_s)
        finally:
            self._beacon.tick()
            self._beacon.disarm()
        if _is_timeout(out):
            suspects = self.probe_peers()
            self._flight_dump(f"collective:{op or 'op'}:recv_timeout",
                              suspect_ranks=suspects or [src_rank], key=key)
            detail = suspects or "none — peers alive but round stalled"
            raise CollectiveTimeoutError(
                f"collective {op or 'op'} (group {self.name!r}) timed out "
                f"after {self.timeout_s:.1f}s waiting on rank {src_rank} "
                f"(key {key!r}); unresponsive ranks: {detail}",
                group_name=self.name, op=op,
                suspect_ranks=suspects or [src_rank])
        env = None
        if _is_zc(out):
            env = out
            n = int(env["nbytes"])
            # Clock only the store resolve: the mailbox wait above is
            # rendezvous skew (sender not ready), not edge transfer time
            # — folding it in makes bulk edges look an order of magnitude
            # slower than they are and poisons the auto-selector's
            # bandwidth estimate.
            t0 = time.perf_counter()
            try:
                val = ray_tpu_torch.get(env["ref"], timeout=self.timeout_s)
            except (ray_tpu_torch.exceptions.GetTimeoutError,
                    ray_tpu_torch.exceptions.ObjectLostError) as e:
                suspects = self.probe_peers()
                self._flight_dump(f"collective:{op or 'op'}:zc_unresolved",
                                  suspect_ranks=suspects or [src_rank],
                                  key=key)
                raise CollectiveTimeoutError(
                    f"collective {op or 'op'} (group {self.name!r}): "
                    f"zero-copy chunk from rank {src_rank} (key {key!r}) "
                    f"never resolved ({type(e).__name__}); unresponsive "
                    f"ranks: {suspects or [src_rank]}",
                    group_name=self.name, op=op,
                    suspect_ranks=suspects or [src_rank]) from e
            if int(env.get("hops", 1)) <= 1:
                owner = int(env.get("owner", src_rank))
                ack_key = env.get("ack_key", key)
                # raylint: disable=leaked-object-ref -- fire-and-forget ack
                self.mailboxes[owner].put.remote(ACK_PREFIX + ack_key, True)
            out = val
        else:
            n = payload_nbytes(out)
        self.stats.bytes_recv += n
        self.stats.recvs += 1
        # Per-edge observation for the EWMA model. Inline payloads record
        # the full round (rendezvous IS the per-hop cost at small sizes);
        # zero-copy payloads record resolve time only (t0 reset above).
        record_transfer(self.topology.node_of(src_rank),
                        self.topology.node_of(self.rank), n,
                        time.perf_counter() - t0, kind="collective")
        return out, env

    def _checked_get(self, ref, *, op: str, budget_s: float):
        """get() that converts transport failures into CollectiveError."""
        try:
            # modest slack over the server-side timeout: the sentinel is
            # the primary mechanism, this is the belt for a dead mailbox
            return ray_tpu_torch.get(ref, timeout=budget_s + 15.0)
        except (ray_tpu_torch.exceptions.ActorDiedError,
                ray_tpu_torch.exceptions.ActorUnavailableError,
                ray_tpu_torch.exceptions.WorkerCrashedError) as e:
            suspects = self.probe_peers()
            self._flight_dump(f"collective:{op or 'op'}:member_lost",
                              suspect_ranks=suspects, error=repr(e))
            raise CollectiveError(
                f"collective {op or 'op'} (group {self.name!r}) lost a "
                f"member: {e}; unresponsive ranks: {suspects}",
                group_name=self.name, op=op, suspect_ranks=suspects) from e
        except ray_tpu_torch.exceptions.GetTimeoutError as e:
            suspects = self.probe_peers()
            self._flight_dump(f"collective:{op or 'op'}:get_timeout",
                              suspect_ranks=suspects)
            raise CollectiveTimeoutError(
                f"collective {op or 'op'} (group {self.name!r}) timed out "
                f"after {budget_s:.1f}s; unresponsive ranks: {suspects}",
                group_name=self.name, op=op, suspect_ranks=suspects) from e
        except ray_tpu_torch.exceptions.TaskError as e:
            cause = getattr(e, "cause", None)
            if isinstance(cause, (ValueError, CollectiveError)):
                raise cause
            raise

    def _flight_dump(self, reason: str, **extra) -> None:
        """Write the black box on the way into a CollectiveError — the
        ring still holds the rounds leading up to the failure. Never
        lets recording problems mask the collective error itself."""
        try:
            from ray_tpu_torch import _rt
            rt = _rt.get_runtime()
            # Staged zero-copy chunks still pinned awaiting an ack: the
            # dump names WHICH ack each stuck chunk waits on and which
            # rank owes it — the usual culprit in a wedged ring.
            staged = [{"ack_key": k, "nbytes": e[1],
                       "waiter_rank": e[2] if len(e) > 2 else None,
                       "object": e[0].id.hex()[:16]}
                      for k, e in list(self._zc_inflight.items())[:64]]
            rt.flight.dump(reason, extra=dict(
                extra, group=self.name, rank=self.rank, world=self.world,
                seq=self.seq, staged_unacked=staged,
                staged_unacked_bytes=self._zc_bytes))
        except Exception:
            pass

    def probe_peers(self, probe_timeout_s: float = 3.0) -> List[int]:
        """Ping every peer mailbox; return ranks that did not answer."""
        refs, order = [], []
        for r, mbx in self.mailboxes.items():
            if r == self.rank:
                continue
            try:
                refs.append(mbx.ping.remote())
                order.append(r)
            except Exception:
                order.append(r)
                refs.append(None)
        suspects = []
        for r, ref in zip(order, refs):
            if ref is None:
                suspects.append(r)
                continue
            try:
                ray_tpu_torch.get(ref, timeout=probe_timeout_s)
            except Exception:
                suspects.append(r)
        return sorted(suspects)

    # -- lifecycle -------------------------------------------------------

    def next_seq(self) -> int:
        # op boundary: cheap non-blocking reap of zero-copy acks so a
        # steady stream of ops keeps the inflight window near-empty
        self._reap_zc_acks(block=False)
        self.seq += 1
        return self.seq

    def destroy(self):
        """Kill every helper actor this rank can name (idempotent)."""
        mem = _memory.tracker()
        for ref, _, _ in self._zc_inflight.values():
            mem.unpin(ref.id, "await_ack")
        self._zc_inflight.clear()
        self._zc_bytes = 0
        _health.drop_beacon(self._beacon.component)
        for name in ([_actor_name(self.name)]
                     + [_actor_name(self.name, f"_mbx{r}")
                        for r in range(self.world)]):
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
            except Exception:
                pass
