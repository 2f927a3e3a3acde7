"""Standing channels: the compiled-DAG data plane.

Reference: the compiled-graph (aDAG) execution layer the reference ships
under python/ray/dag — once a static DAG is compiled, per-call dispatch
(task-spec build, submit queue, scheduler round) is replaced by raw
enqueues onto channels negotiated once at compile time. Our transport is
the existing worker RPC plane rather than shared-memory mutable objects,
but the shape is the same: one standing channel per compiled node, opened
on the worker hosting that node's actor, with pre-resolved routes to its
consumers.

Protocol (all frames carry the driver-assigned execution sequence number):

  channel_open(spec)                    negotiate: bind the channel to its
                                        actor lane, unpack const args once
  channel_push(channel_id, seq, slot,   one value frame for one input slot
               kind, payload)           of one execution
  channel_close(channel_id)             release the channel
  channel_result(sink_id, seq, slot,    worker -> driver delivery onto the
                 kind, payload)         CompiledDAG's output sink

A channel gathers the frames of execution `seq` until all of its input
slots arrived, then dispatches — strictly in seq order, so pipelined
in-flight executions cannot interleave on the actor even when their
frames arrive out of order. Results forward directly worker->worker along
the compiled edges (driver round-trips only at the sink), with a local
fast path when producer and consumer lanes share a worker process.

Error propagation is typed and per-sequence: an input error frame is
forwarded downstream without executing (poisoning exactly that seq), an
actor death surfaces as ActorDiedError carrying the actor id, and a
method raise travels as the raised exception itself.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.status import ActorDiedError, RayTpuError

_memory_mod = None


def _memattr():
    """Lazy memory-attribution tracker (observability imports core at
    module top, so core modules must import it on first use)."""
    global _memory_mod
    if _memory_mod is None:
        from ray_tpu_torch.observability import memory
        _memory_mod = memory.tracker()
    return _memory_mod

logger = logging.getLogger("ray_tpu_torch.channels")

# Standing-channel instruments, created on first channel_open (lazy so
# importing this module never pulls util.metrics -> runtime). Held in a
# module global because the metrics registry is weak.
_instruments = None


def _channel_instruments():
    global _instruments
    if _instruments is None:
        from ray_tpu_torch.util import metrics
        _instruments = (
            metrics.Gauge(
                "ray_tpu_channel_queue_depth",
                "executions buffered in a standing channel's seq gather "
                "map (arrived but not yet dispatched)", tag_keys=("channel",)),
            metrics.Gauge(
                "ray_tpu_channel_inflight_seq",
                "next execution sequence a standing channel will dispatch "
                "(monotonic progress indicator)", tag_keys=("channel",)),
            metrics.Histogram(
                "ray_tpu_channel_hop_seconds",
                "per-hop forward latency along compiled-DAG channel edges",
                boundaries=[1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3,
                            0.01, 0.05, 0.1, 0.5, 1.0],
                tag_keys=("channel",)),
        )
    return _instruments

# frame kinds
F_DATA = "data"    # one packed value
F_ERR = "err"      # packed exception; poisons this seq downstream
F_ITEM = "item"    # one packed stream item (sink-bound only)
F_END = "end"      # stream end; payload = packed item count


@dataclass(frozen=True)
class ChannelEdge:
    """One pre-resolved route out of a channel."""

    kind: str                 # "push" (to another channel) | "result" (sink)
    addr: Tuple[str, int]     # worker (push) or driver (result) RPC address
    target: str               # downstream channel_id or sink_id
    slot: int                 # input slot at the target
    label: str = ""           # consumer label, for edge telemetry


@dataclass
class ChannelSpec:
    """Everything a worker needs to host one compiled node; shipped once
    at channel_open, never per call."""

    channel_id: str
    actor_id: Any                       # ids.ActorID
    method: str
    args_template: Tuple[Tuple, ...]    # ("const",packed)|("slot",i)|("slot_attr",i,key)
    kwargs_template: Tuple[Tuple[str, Tuple], ...]
    n_slots: int                        # frames required per seq (>= 1)
    downstream: Tuple[ChannelEdge, ...] = ()
    streaming_ok: bool = False          # generator results stream item frames
    label: str = ""


def _extract(base: Any, key: Any) -> Any:
    """InputAttributeNode semantics, applied worker-side."""
    if isinstance(base, dict):
        return base[key]
    if isinstance(key, int):
        return base[key]
    return getattr(base, key)


def pack_value(value: Any) -> bytes:
    return serialization.pack(value)


def pack_error(err: BaseException) -> bytes:
    """Exceptions travel as themselves; unpicklable ones degrade to a
    typed wrapper carrying the repr."""
    try:
        return serialization.pack(err)
    except Exception:
        return serialization.pack(
            RayTpuError(f"{type(err).__name__}: {err!r}"))


class _Channel:
    """Worker-side state of one standing channel."""

    __slots__ = ("spec", "args_template", "kwargs_template", "frames",
                 "next_seq", "dispatched", "buffered_bytes", "mem_tracked")

    def __init__(self, spec: ChannelSpec):
        self.spec = spec
        # consts unpack ONCE here; per-execution cost is slot lookups only
        self.args_template = [self._prep(e) for e in spec.args_template]
        self.kwargs_template = [(k, self._prep(e))
                                for k, e in spec.kwargs_template]
        self.frames: Dict[int, Dict[int, Tuple[str, bytes]]] = {}
        self.next_seq = 0
        self.dispatched = 0
        self.buffered_bytes = 0     # payload bytes parked in `frames`
        self.mem_tracked = False    # synthetic record currently registered

    @staticmethod
    def _prep(entry: Tuple) -> Tuple:
        if entry[0] == "const":
            return ("const", serialization.unpack(entry[1]))
        return entry

    def build_args(self, values: Dict[int, Any]) -> Tuple[list, dict]:
        def one(entry):
            tag = entry[0]
            if tag == "const":
                return entry[1]
            if tag == "slot":
                return values[entry[1]]
            return _extract(values[entry[1]], entry[2])   # slot_attr

        return ([one(e) for e in self.args_template],
                {k: one(e) for k, e in self.kwargs_template})


class ChannelHost:
    """Hosts the standing channels of one worker process: gathers frames,
    dispatches executions onto actor lanes in seq order, forwards results
    along pre-resolved edges."""

    def __init__(self, worker):
        self.worker = worker
        self.runtime = worker.runtime
        self._channels: Dict[str, _Channel] = {}
        # one progress beacon for this host's channel reader: armed while
        # any channel holds partially-gathered / out-of-order seqs (the
        # compiled-graph wedge signature: an upstream stopped pushing
        # mid-execution), ticked on every frame
        from ray_tpu_torch.observability import health
        self._beacon = health.beacon("channels", deadline_s=30.0)
        self._gauges = _channel_instruments()

    # ------------------------------------------------------------ rpc surface

    async def rpc_channel_open(self, spec: ChannelSpec) -> dict:
        lane = self.worker.lanes.get(spec.actor_id)
        if lane is None or lane.instance is None:
            return {"ok": False, "error": "no actor hosted here"}
        self._channels[spec.channel_id] = _Channel(spec)
        return {"ok": True}

    def push(self, channel_id: str, seq: int, slot: int, kind: str,
             payload: bytes) -> dict:
        """Synchronous, non-blocking up to the lane enqueue — eligible for
        the RPC server's inline ONEWAY fast path."""
        ch = self._channels.get(channel_id)
        if ch is None:
            return {"ok": False, "error": "no such channel"}
        self._deliver(ch, seq, slot, kind, payload)
        return {"ok": True}

    async def rpc_channel_close(self, channel_id: str) -> dict:
        ch = self._channels.pop(channel_id, None)
        if ch is not None and ch.mem_tracked:
            _memattr().release("channel:" +
                               (ch.spec.label or ch.spec.channel_id[:8]))
        return {"ok": True}

    # --------------------------------------------------------------- delivery

    def _deliver(self, ch: _Channel, seq: int, slot: int, kind: str,
                 payload: bytes) -> None:
        """Runs on the event loop (RPC handler or local fast path)."""
        if seq < ch.next_seq:
            return   # stale duplicate of an already-dispatched seq
        frames = ch.frames.setdefault(seq, {})
        prev = frames.get(slot)
        frames[slot] = (kind, payload)
        ch.buffered_bytes += len(payload) - (len(prev[1]) if prev else 0)
        fl = getattr(self.runtime, "flight", None)
        if fl is not None:
            fl.record({"kind": "channel_frame", "ts": time.time(),
                       "channel": ch.spec.label or ch.spec.channel_id[:8],
                       "seq": seq, "slot": slot, "frame_kind": kind,
                       "nbytes": len(payload)})
        # dispatch strictly in seq order: pipelined executions whose frames
        # raced ahead wait in the gather map until their turn
        while ch.frames.get(ch.next_seq) is not None \
                and len(ch.frames[ch.next_seq]) >= ch.spec.n_slots:
            slots = ch.frames.pop(ch.next_seq)
            ch.buffered_bytes -= sum(len(p) for _, p in slots.values())
            seq_now = ch.next_seq
            ch.next_seq += 1
            ch.dispatched += 1
            self._dispatch(ch, seq_now, slots)
        self._beacon.tick()
        label = ch.spec.label or ch.spec.channel_id[:8]
        self._track_buffer(ch, label)
        depth_g, seq_g, _hop = self._gauges
        depth_g.set(float(len(ch.frames)), {"channel": label})
        seq_g.set(float(ch.next_seq), {"channel": label})
        if ch.frames:
            self._beacon.arm(channel=label, waiting_seq=ch.next_seq,
                             buffered=len(ch.frames))
        elif self._beacon.busy \
                and not any(c.frames for c in self._channels.values()):
            self._beacon.disarm()

    def _track_buffer(self, ch: _Channel, label: str) -> None:
        """Mirror this channel's parked reorder bytes into the memory
        plane as a synthetic (non-store) record, pinned with the seq the
        gather is stuck behind while frames are parked — `top mem` then
        shows a wedged compiled graph as channel bytes waiting on a seq."""
        mem = _memattr()
        key = "channel:" + label
        if ch.buffered_bytes > 0:
            mem.attribute(key, "channel", ch.buffered_bytes, store=False,
                          waiting_seq=ch.next_seq, buffered=len(ch.frames))
            if not ch.mem_tracked:
                mem.pin(key, "reorder")
                ch.mem_tracked = True
        elif ch.mem_tracked:
            mem.release(key)
            ch.mem_tracked = False

    def _dispatch(self, ch: _Channel, seq: int,
                  slots: Dict[int, Tuple[str, bytes]]) -> None:
        # an errored input poisons this seq: forward, don't execute
        for kind, payload in slots.values():
            if kind == F_ERR:
                self._spawn_forward(ch, seq, F_ERR, payload)
                return
        lane = self.worker.lanes.get(ch.spec.actor_id)
        if lane is None or lane.instance is None:
            self._spawn_forward(ch, seq, F_ERR, pack_error(ActorDiedError(
                f"compiled-dag actor {ch.spec.actor_id.hex()[:12]} is not "
                f"hosted here (killed or restarted)",
                actor_id=ch.spec.actor_id.hex())))
            return
        method = getattr(lane.instance, ch.spec.method, None)
        if method is None:
            self._spawn_forward(ch, seq, F_ERR, pack_error(AttributeError(
                f"actor has no method {ch.spec.method!r}")))
            return
        if inspect.iscoroutinefunction(method) \
                or inspect.isasyncgenfunction(method):
            # async methods run on the loop; create order == dispatch order
            asyncio.get_running_loop().create_task(
                self._run_async(ch, seq, slots, lane, method))
            return
        # sync methods keep actor FIFO semantics: the whole
        # resolve+execute+pack rides the actor's serial lane executor
        fut = lane.executor.submit(self._run_sync, ch, seq, slots,
                                   lane, method)
        fut.add_done_callback(lambda f: f.exception())  # never unraised

    # -------------------------------------------------------------- execution

    def _run_sync(self, ch: _Channel, seq: int, slots, lane, method) -> None:
        """Lane-executor thread: unpack inputs, run, forward."""
        t0 = time.perf_counter()
        try:
            values = {i: serialization.unpack(p)
                      for i, (_, p) in slots.items()}
            args, kwargs = ch.build_args(values)
            value = method(*args, **kwargs)
        except BaseException as e:   # noqa: BLE001 — typed err frame
            if isinstance(e, KeyboardInterrupt) \
                    and self.worker.lanes.get(ch.spec.actor_id) is not lane:
                e = ActorDiedError(
                    f"compiled-dag actor {ch.spec.actor_id.hex()[:12]} "
                    "killed mid-execute", actor_id=ch.spec.actor_id.hex())
            self._spawn_forward(ch, seq, F_ERR, pack_error(e))
            return
        if ch.spec.streaming_ok and inspect.isgenerator(value):
            idx = 0
            try:
                for item in value:
                    idx += 1
                    self._spawn_forward(ch, seq, F_ITEM, pack_value(item))
                self._spawn_forward(ch, seq, F_END, pack_value(idx))
            except BaseException as e:   # noqa: BLE001 — typed err frame
                self._spawn_forward(ch, seq, F_ERR, pack_error(e))
            self._emit_span(ch, seq, t0)
            return
        self._spawn_forward(ch, seq, F_DATA, pack_value(value))
        self._emit_span(ch, seq, t0)

    async def _run_async(self, ch: _Channel, seq: int, slots, lane,
                         method) -> None:
        """Event loop: async (generator) methods; arg unpack still hops to
        the lane executor because user payloads can be arbitrarily big."""
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        try:
            args, kwargs = await loop.run_in_executor(
                lane.executor, self._build_async_args, ch, slots)
        except BaseException as e:   # noqa: BLE001 — typed err frame
            await self._forward(ch, seq, F_ERR, pack_error(e))
            return
        try:
            if inspect.isasyncgenfunction(method):
                if not ch.spec.streaming_ok:
                    raise TypeError(
                        f"{ch.spec.label or ch.spec.method}: generator "
                        "methods are only supported at a compiled DAG's "
                        "output node")
                agen = method(*args, **kwargs)
                idx = 0
                async for item in agen:
                    idx += 1
                    payload = await loop.run_in_executor(None, pack_value,
                                                         item)
                    await self._forward(ch, seq, F_ITEM, payload)
                await self._forward(ch, seq, F_END, pack_value(idx))
            else:
                async with lane.async_sem:
                    if self.worker.lanes.get(ch.spec.actor_id) is not lane \
                            or lane.instance is None:
                        raise ActorDiedError(
                            f"compiled-dag actor "
                            f"{ch.spec.actor_id.hex()[:12]} killed",
                            actor_id=ch.spec.actor_id.hex())
                    value = await method(*args, **kwargs)
                payload = await loop.run_in_executor(None, pack_value, value)
                await self._forward(ch, seq, F_DATA, payload)
            self._emit_span(ch, seq, t0)
        except BaseException as e:   # noqa: BLE001 — typed err frame
            await self._forward(ch, seq, F_ERR, pack_error(e))

    @staticmethod
    def _build_async_args(ch: _Channel, slots) -> Tuple[list, dict]:
        values = {i: serialization.unpack(p) for i, (_, p) in slots.items()}
        return ch.build_args(values)

    # ------------------------------------------------------------- forwarding

    def _spawn_forward(self, ch: _Channel, seq: int, kind: str,
                       payload: bytes) -> None:
        """Fire the forward from any thread without blocking the lane —
        the downstream's seq gate re-establishes ordering."""
        self.runtime._spawn(self._forward(ch, seq, kind, payload))

    async def _forward(self, ch: _Channel, seq: int, kind: str,
                       payload: bytes) -> None:
        for edge in ch.spec.downstream:
            # stream frames are sink-bound only: an intermediate consumer
            # of a streaming node is rejected at compile time
            if kind in (F_ITEM, F_END) and edge.kind != "result":
                continue
            try:
                t0 = time.perf_counter()
                await self._send_one(edge, seq, kind, payload)
                self._record_edge(ch, edge, len(payload),
                                  time.perf_counter() - t0)
            except Exception as e:
                # the consumer is unreachable: the driver's in-flight
                # poisoning (actor-state watch at the ref) surfaces it
                logger.warning("channel %s -> %s forward failed: %s",
                               ch.spec.label or ch.spec.channel_id,
                               edge.target[:12], e)

    async def _send_one(self, edge: ChannelEdge, seq: int, kind: str,
                        payload: bytes) -> None:
        addr = tuple(edge.addr)
        me = self.runtime.address
        if me is not None and addr == me.addr:
            # local fast path: producer and consumer lanes share this
            # worker (lane packing) or the driver compiled its own node
            if edge.kind == "push":
                chd = self._channels.get(edge.target)
                if chd is not None:
                    self._deliver(chd, seq, edge.slot, kind, payload)
                return
            if self.runtime.deliver_channel_result(edge.target, seq,
                                                   edge.slot, kind, payload):
                return
        # one-way frames: no reply round-trip on the hot path — the wire is
        # FIFO per connection and the consumer's seq gate tolerates loss
        # only via the driver's actor-death poisoning, which is the same
        # failure domain that would have eaten the reply anyway
        client = self.runtime.pool.get(addr)
        if edge.kind == "push":
            await client.oneway("channel_push", channel_id=edge.target,
                                seq=seq, slot=edge.slot, kind=kind,
                                payload=payload)
        else:
            await client.oneway("channel_result", sink_id=edge.target,
                                seq=seq, slot=edge.slot, kind=kind,
                                payload=payload)

    # ------------------------------------------------------------ telemetry

    def _record_edge(self, ch: _Channel, edge: ChannelEdge, nbytes: int,
                     seconds: float) -> None:
        """Per-edge EWMA observations under dag:-prefixed endpoints, so
        the observability edge model prices compiled hops the same way it
        prices object pulls and collective rounds."""
        try:
            self.runtime.telemetry.record_edge(
                f"dag:{ch.spec.label or ch.spec.channel_id[:8]}",
                f"dag:{edge.label or edge.target[:8]}",
                nbytes, seconds, kind="dag_channel")
            self._gauges[2].observe(
                seconds, {"channel": ch.spec.label or ch.spec.channel_id[:8]})
        except Exception:
            pass

    def _emit_span(self, ch: _Channel, seq: int, t0: float) -> None:
        from ray_tpu_torch.util import tracing

        if tracing.is_enabled():
            tracing.emit_span(
                f"dag::{ch.spec.label or ch.spec.method}",
                time.time() - (time.perf_counter() - t0),
                time.perf_counter() - t0,
                {"seq": seq, "channel": ch.spec.channel_id[:8],
                 "actor_id": ch.spec.actor_id.hex()[:12]})
