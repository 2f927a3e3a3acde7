"""Compiled execution graphs: static DAGs out of the dispatch path.

Reference: the experimental compiled-DAG layer under python/ray/dag
(`dag.experimental_compile()`): when a DAG's shape is known up front,
compile it ONCE — topologically sort, instantiate every `ClassNode` actor,
pin method bindings, resolve actor routes, and negotiate one standing
channel per node (core/channels.py) with pre-resolved edges to its
consumers. After that, `compiled.execute(x)` is a raw enqueue: pack the
input once, push one frame per entry channel, return a `CompiledDAGRef`
that resolves from the output sink. No per-call task-spec build, no
ObjectID registration, no scheduler round, no mailbox queueing.

Sequencing: every execute() gets a monotonically increasing sequence
number. Channels gather frames per seq and dispatch strictly in seq
order, so in-flight executions pipeline through the graph without
interleaving corruption even when frames race on the wire.

Errors are typed and per-sequence: a method raise travels down the
channel as the exception itself, an actor killed mid-execute surfaces as
`ActorDiedError` at the ref — poisoning only that sequence number; later
sequences fail with their own frames. A GCS DEAD notification is the
fallback for frames lost with a crashed worker: the ref's wait loop
watches the actor-state cache and poisons what can no longer complete.

Restrictions (mirroring the reference's aDAG): actor-method nodes only
(no `FunctionNode`), at most one `InputNode`, `MultiOutputNode` only at
the root, no DAG nodes nested inside container arguments, and `ClassNode`
constructor args must be static. Generator leaves stream item frames to
the ref (iterate the ref) and are only legal at a single-leaf root.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.channels import (F_DATA, F_END, F_ERR, F_ITEM, ChannelEdge,
                                   ChannelSpec, pack_value)
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.core.status import (ActorDiedError, GetTimeoutError,
                                 RayTpuError)
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                  FunctionNode, InputAttributeNode,
                                  InputNode, MultiOutputNode)

logger = logging.getLogger("ray_tpu_torch.dag.compiled")

_WAIT_SLICE_S = 0.05


class _PendingExec:
    """Sink-side state of one in-flight sequence number."""

    __slots__ = ("frames", "error", "items", "stream_ended", "t0",
                 "span_emitted")

    def __init__(self):
        self.frames: Dict[int, bytes] = {}
        self.error: Optional[BaseException] = None
        self.items: deque = deque()
        self.stream_ended = False
        self.t0 = time.time()       # execute() wall clock, for the span
        self.span_emitted = False


class _ChannelSink:
    """Driver-side output endpoint: channel_result frames land here (on
    the runtime loop), refs consume from any thread."""

    def __init__(self, sink_id: str, n_slots: int):
        self.sink_id = sink_id
        self.n_slots = n_slots
        self._cond = threading.Condition()
        self._pending: Dict[int, _PendingExec] = {}
        # set by CompiledDAG: called once per seq when it completes
        # (all slots / error / stream end) — the driver-side execute span
        self.on_complete = None

    def expect(self, seq: int) -> None:
        with self._cond:
            self._pending[seq] = _PendingExec()

    def deliver(self, seq: int, slot: int, kind: str,
                payload: bytes) -> None:
        with self._cond:
            rec = self._pending.get(seq)
            if rec is None:
                return   # resolved or torn down; late frame
            if kind == F_ERR:
                if rec.error is None:
                    try:
                        rec.error = serialization.unpack(payload)
                    except Exception as e:
                        rec.error = RayTpuError(
                            f"undecodable channel error frame: {e!r}")
            elif kind == F_ITEM:
                rec.items.append(payload)
            elif kind == F_END:
                rec.stream_ended = True
            else:
                rec.frames[slot] = payload
            self._maybe_complete(seq, rec)
            self._cond.notify_all()

    def _maybe_complete(self, seq: int, rec: _PendingExec) -> None:
        """Under self._cond: fire on_complete exactly once per seq, when
        its output is fully determined."""
        if rec.span_emitted or self.on_complete is None:
            return
        done = (rec.error is not None or rec.stream_ended
                or len(rec.frames) >= self.n_slots)
        if done:
            rec.span_emitted = True
            try:
                self.on_complete(seq, rec)
            except Exception:
                pass

    def poison(self, seq: int, err: BaseException) -> None:
        with self._cond:
            rec = self._pending.get(seq)
            if rec is not None and rec.error is None:
                rec.error = err
                self._maybe_complete(seq, rec)
                self._cond.notify_all()

    def poison_all(self, err: BaseException) -> None:
        with self._cond:
            for rec in self._pending.values():
                if rec.error is None:
                    rec.error = err
            self._cond.notify_all()

    def pop(self, seq: int) -> None:
        with self._cond:
            self._pending.pop(seq, None)

    def record(self, seq: int) -> Optional[_PendingExec]:
        return self._pending.get(seq)

    @property
    def cond(self) -> threading.Condition:
        return self._cond

    def inflight(self) -> int:
        with self._cond:
            return len(self._pending)


_UNSET = object()


class CompiledDAGRef:
    """Handle to one execution of a CompiledDAG. `get()` resolves the
    output; iterating consumes a streaming leaf's items in order."""

    def __init__(self, dag: "CompiledDAG", seq: int, streaming: bool):
        self._dag = dag
        self._seq = seq
        self._streaming = streaming
        self._result = _UNSET

    @property
    def seq(self) -> int:
        return self._seq

    def done(self) -> bool:
        if self._result is not _UNSET:
            return True
        sink = self._dag._sink
        with sink.cond:
            rec = sink.record(self._seq)
            if rec is None:
                return True
            return (len(rec.frames) >= sink.n_slots
                    or bool(rec.items) or rec.stream_ended
                    or rec.error is not None)

    def get(self, timeout: Optional[float] = None):
        if self._result is not _UNSET:
            if isinstance(self._result, BaseException):
                raise self._result
            return self._result
        sink = self._dag._sink
        deadline = None if timeout is None else time.monotonic() + timeout
        with sink.cond:
            while True:
                rec = sink.record(self._seq)
                if rec is None:
                    raise RuntimeError(
                        f"compiled-dag seq {self._seq} was discarded "
                        "(torn down or already consumed)")
                if len(rec.frames) >= sink.n_slots:
                    # completion wins over poisoning: the frames are here
                    payloads = [rec.frames[i] for i in range(sink.n_slots)]
                    break
                if rec.items or rec.stream_ended:
                    raise TypeError("the compiled leaf returned a "
                                    "generator; iterate the ref instead "
                                    "of calling get()")
                if rec.error is not None:
                    self._result = rec.error
                    sink._pending.pop(self._seq, None)
                    raise rec.error
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(
                        f"compiled-dag seq {self._seq} not ready after "
                        f"{timeout}s")
                sink.cond.wait(_WAIT_SLICE_S)
                self._dag._poison_dead_actors()
        values = [serialization.unpack(p) for p in payloads]
        self._result = values if self._dag._multi_output else values[0]
        sink.pop(self._seq)
        return self._result

    # ---- streaming consumption (single generator leaf)

    def __iter__(self):
        if not self._streaming:
            raise TypeError("this compiled DAG does not stream; call get()")
        return self

    def __next__(self):
        sink = self._dag._sink
        with sink.cond:
            while True:
                rec = sink.record(self._seq)
                if rec is None:
                    raise StopIteration
                if rec.items:
                    payload = rec.items.popleft()
                    break
                if rec.frames:
                    raise TypeError("the compiled leaf returned a plain "
                                    "value; call get() instead of "
                                    "iterating the ref")
                if rec.error is not None:
                    err = rec.error
                    sink._pending.pop(self._seq, None)
                    raise err
                if rec.stream_ended:
                    sink._pending.pop(self._seq, None)
                    raise StopIteration
                sink.cond.wait(_WAIT_SLICE_S)
                self._dag._poison_dead_actors()
        return serialization.unpack(payload)

    def __repr__(self):
        return f"CompiledDAGRef(seq={self._seq})"


class CompiledDAG:
    """A bound static DAG compiled onto standing channels. Obtain via
    `dag_node.experimental_compile()`."""

    def __init__(self, root: DAGNode, *,
                 resolve_timeout: Optional[float] = 60.0):
        self._rt = get_runtime()
        self._root = root
        self._lock = threading.Lock()
        self._next_seq = 0
        self._torn_down = False
        self._sink_id = uuid.uuid4().hex
        self._multi_output = isinstance(root, MultiOutputNode)
        self._streaming = False
        self._has_input = False
        self._owned: List[Tuple[ClassNode, Any]] = []   # kill at teardown
        self._actor_ids: List[Any] = []
        self._specs: List[Tuple[ChannelSpec, Tuple[str, int]]] = []
        self._entries: List[Tuple[Tuple[str, int], str, int, str]] = []
        self._tick = pack_value(None)
        self._compile(resolve_timeout)

    # ------------------------------------------------------------- compile

    def _compile(self, resolve_timeout: Optional[float]) -> None:
        rt = self._rt
        if rt.address is None:
            raise RuntimeError("ray_tpu_torch.init() must run before "
                               "experimental_compile()")
        order = self._root._topo_order()

        input_node: Optional[InputNode] = None
        for n in order:
            if isinstance(n, FunctionNode):
                raise TypeError(
                    "experimental_compile supports actor-method DAGs only; "
                    f"found {n!r} (FunctionNode)")
            if isinstance(n, InputNode):
                if input_node is not None and n is not input_node:
                    raise TypeError("compiled DAGs accept at most one "
                                    "InputNode")
                input_node = n
            if isinstance(n, MultiOutputNode) and n is not self._root:
                raise TypeError("MultiOutputNode is only legal at the DAG "
                                "root")
        self._has_input = input_node is not None

        if self._multi_output:
            leaves = list(self._root._bound_args[0])
            if not leaves or not all(isinstance(x, ClassMethodNode)
                                     for x in leaves):
                raise TypeError("MultiOutputNode outputs must be "
                                "ClassMethodNodes")
        elif isinstance(self._root, ClassMethodNode):
            leaves = [self._root]
        else:
            raise TypeError(
                f"compiled DAG root must be a ClassMethodNode or "
                f"MultiOutputNode, not {type(self._root).__name__}")

        method_nodes = [n for n in order
                        if isinstance(n, ClassMethodNode)]

        # 1. instantiate every actor up front (lazy nodes become eager);
        #    constructor args must be static — there is no per-execute
        #    resolve pass to feed them
        def static_resolve(v):
            if isinstance(v, DAGNode):
                raise TypeError("ClassNode constructor args must be static "
                                "in compiled DAGs")
            return v

        handles: Dict[int, Any] = {}       # id(ClassNode) -> ActorHandle
        for node in method_nodes:
            cn = node._class_node
            if id(cn) in handles:
                continue
            owned = cn._handle is None and not cn._external
            handle = cn._get_handle(static_resolve)
            handles[id(cn)] = handle
            if owned:
                self._owned.append((cn, handle))

        # 2. pre-resolve actor routes once; subscribe so the GCS pushes
        #    DEAD transitions into the state cache the refs watch
        addr_of: Dict[int, Tuple[str, int]] = {}
        for cn_id, handle in handles.items():
            aid = handle._actor_id
            rt._subscribe_actor(aid)
            addr = rt._run(
                rt._resolve_actor(aid, resolve_timeout),
                timeout=None if resolve_timeout is None
                else resolve_timeout + 5.0)
            addr_of[cn_id] = tuple(addr)
            self._actor_ids.append(aid)

        # 3. build one ChannelSpec per method node, threading edges from
        #    producers to the consumer slots they feed
        states: Dict[int, dict] = {}
        for idx, node in enumerate(method_nodes):
            states[id(node)] = {
                "node": node,
                "channel_id": uuid.uuid4().hex,
                "addr": addr_of[id(node._class_node)],
                "actor_id": handles[id(node._class_node)]._actor_id,
                "args": [], "kwargs": [],
                "n_slots": 0, "input_slot": None,
                "downstream": [],
                "label": f"{node._method}@{idx}",
            }

        def contains_dag_node(v) -> bool:
            if isinstance(v, DAGNode):
                return True
            if isinstance(v, (list, tuple)):
                return any(contains_dag_node(x) for x in v)
            if isinstance(v, dict):
                return any(contains_dag_node(x) for x in v.values())
            return False

        def input_slot(st: dict) -> int:
            if st["input_slot"] is None:
                st["input_slot"] = st["n_slots"]
                st["n_slots"] += 1
            return st["input_slot"]

        def entry_of(st: dict, v) -> Tuple:
            if isinstance(v, ClassMethodNode):
                prod = states.get(id(v))
                if prod is None:
                    raise TypeError("a compiled node consumes a "
                                    "ClassMethodNode outside this DAG")
                slot = st["n_slots"]
                st["n_slots"] += 1
                prod["downstream"].append(ChannelEdge(
                    "push", st["addr"], st["channel_id"], slot,
                    label=st["label"]))
                return ("slot", slot)
            if isinstance(v, InputNode):
                return ("slot", input_slot(st))
            if isinstance(v, InputAttributeNode):
                return ("slot_attr", input_slot(st), v._key)
            if isinstance(v, ClassNode):
                h = handles.get(id(v))
                if h is None:
                    h = v._get_handle(static_resolve)
                return ("const", serialization.pack(h))
            if isinstance(v, DAGNode):
                raise TypeError(f"cannot compile argument node {v!r}")
            if contains_dag_node(v):
                raise TypeError(
                    "compiled DAGs require DAG nodes as top-level "
                    "arguments, not nested inside containers")
            return ("const", serialization.pack(v))

        for node in method_nodes:
            st = states[id(node)]
            for a in node._bound_args:
                st["args"].append(entry_of(st, a))
            for k, v in node._bound_kwargs.items():
                st["kwargs"].append((k, entry_of(st, v)))

        # 4. leaf edges into the driver sink
        driver_addr = rt.address.addr
        for i, leaf in enumerate(leaves):
            states[id(leaf)]["downstream"].append(ChannelEdge(
                "result", driver_addr, self._sink_id, i, label="driver"))
        self._streaming = len(leaves) == 1

        self._sink = _ChannelSink(self._sink_id, n_slots=len(leaves))
        # driver-side span per execute: expect() stamps t0 at execute
        # time, the sink fires once when the seq's output is determined.
        # Unconditional (unlike worker-side dag:: spans, which are
        # tracing-gated): one event per execute is the observability
        # floor compiled graphs otherwise lack.
        self._label = "|".join(f"{leaf._method}" for leaf in leaves)
        self._sink.on_complete = self._record_execute_span
        rt.register_channel_sink(self._sink_id, self._sink)

        # 5. channels with no inbound slots still need one frame per seq
        #    to know when to fire: the driver pushes a tick
        for st in states.values():
            if st["n_slots"] == 0:
                st["tick_slot"] = 0
                st["n_slots"] = 1
            else:
                st["tick_slot"] = None

        specs = []
        for node in method_nodes:
            st = states[id(node)]
            spec = ChannelSpec(
                channel_id=st["channel_id"],
                actor_id=st["actor_id"],
                method=node._method,
                args_template=tuple(st["args"]),
                kwargs_template=tuple(st["kwargs"]),
                n_slots=st["n_slots"],
                downstream=tuple(st["downstream"]),
                streaming_ok=self._streaming and node is leaves[0],
                label=st["label"],
            )
            specs.append((spec, st["addr"]))
            if st["input_slot"] is not None:
                self._entries.append((st["addr"], st["channel_id"],
                                      st["input_slot"], "input"))
            if st["tick_slot"] is not None:
                self._entries.append((st["addr"], st["channel_id"],
                                      st["tick_slot"], "tick"))
        self._specs = specs

        # 6. negotiate: open consumers before their producers so a frame
        #    can never race ahead of its destination channel
        try:
            for spec, addr in reversed(specs):
                r = rt._run(rt.pool.get(addr).call(
                    "channel_open", spec=spec, timeout=30.0), timeout=35.0)
                if not r.get("ok"):
                    raise RuntimeError(
                        f"channel_open for {spec.label} failed: "
                        f"{r.get('error')}")
        except BaseException:
            self.teardown(kill_actors=True)
            raise

    # ------------------------------------------------------------- execute

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        """One raw enqueue onto the standing channels. Mirrors the lazy
        InputNode calling convention exactly."""
        if self._torn_down:
            raise RuntimeError("CompiledDAG has been torn down")
        if args and kwargs:
            raise TypeError(
                "DAG execute() accepts positional OR keyword inputs, not "
                "both (an InputAttributeNode cannot address a mixed input)")
        if self._has_input:
            if len(args) == 1 and not kwargs:
                value = args[0]
            elif kwargs:
                value = kwargs
            else:
                value = args
            payload = pack_value(value)
        else:
            if args or kwargs:
                raise TypeError("this compiled DAG binds no InputNode; "
                                "execute() takes no arguments")
            payload = self._tick
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._sink.expect(seq)
        # the enqueue itself is fire-and-forget on the runtime loop: the
        # caller's thread never blocks, frames ride one-way RPC (no reply
        # round-trip), and loop submission order keeps same-thread
        # executes FIFO on the wire
        self._rt._spawn(self._push_all(seq, payload))
        return CompiledDAGRef(self, seq, streaming=self._streaming)

    async def _push_all(self, seq: int, payload: bytes) -> None:
        rt = self._rt
        for addr, channel_id, slot, kind in self._entries:
            try:
                await rt.pool.get(tuple(addr)).oneway(
                    "channel_push", channel_id=channel_id, seq=seq,
                    slot=slot, kind=F_DATA,
                    payload=payload if kind == "input" else self._tick)
            except Exception as e:
                self._sink.poison(seq, RayTpuError(
                    f"compiled-dag input push failed for seq {seq}: "
                    f"{e!r}"))

    def _record_execute_span(self, seq: int, rec: _PendingExec) -> None:
        """Runs under the sink condition on the runtime loop — must stay
        non-blocking (record_event is lock+append)."""
        self._rt.record_span({
            "kind": "span", "name": f"dag::{self._label}",
            "trace_id": f"dag:{self._sink_id[:8]}",
            "span_id": f"{self._sink_id[:8]}:{seq}", "parent_id": None,
            "ts": rec.t0, "dur": max(time.time() - rec.t0, 0.0),
            "attrs": {"seq": seq, "ok": rec.error is None,
                      "streaming": self._streaming}})

    # ------------------------------------------------------------ liveness

    def _poison_dead_actors(self) -> None:
        """Fallback for frames lost with a crashed worker: the GCS DEAD
        notification poisons every seq that can no longer complete."""
        for aid in self._actor_ids:
            st = self._rt._actor_state.get(aid)
            if st is not None and st.get("state") == "DEAD":
                self._sink.poison_all(ActorDiedError(
                    f"compiled-dag actor {aid.hex()[:12]} died: "
                    f"{st.get('death_cause')}", actor_id=aid.hex()))
                return

    def num_inflight(self) -> int:
        return self._sink.inflight()

    # ------------------------------------------------------------ teardown

    def teardown(self, kill_actors: bool = True) -> None:
        """Release the standing channels and (owned) actors. In-flight
        refs fail with a teardown error."""
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        rt = self._rt
        for spec, addr in self._specs:
            try:
                rt._run(rt.pool.get(addr).call(
                    "channel_close", channel_id=spec.channel_id,
                    timeout=5.0), timeout=10.0)
            except Exception:
                pass
        rt.unregister_channel_sink(self._sink_id)
        if getattr(self, "_sink", None) is not None:
            self._sink.poison_all(RuntimeError("CompiledDAG torn down"))
        if kill_actors:
            for cn, handle in self._owned:
                try:
                    rt.kill_actor(handle._actor_id)
                except Exception:
                    pass
                with cn._lock:
                    cn._handle = None   # lazy execute() can re-create
        self._owned = []

    def __del__(self):
        try:
            if not getattr(self, "_torn_down", True):
                self.teardown()
        except Exception:
            pass

    def __repr__(self):
        return (f"CompiledDAG(channels={len(self._specs)}, "
                f"actors={len(self._actor_ids)}, "
                f"streaming={self._streaming})")
