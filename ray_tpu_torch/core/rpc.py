"""Asyncio message layer used by all ray_tpu_torch daemons and workers.

Reference: src/ray/rpc/ (GrpcServer / ClientCallManager). The reference wraps
gRPC; here the control plane is a compact asyncio TCP protocol with
length-prefixed pickled frames. The wire layer is isolated behind
`RpcServer`/`RpcClient` so it can be swapped for gRPC (grpcio is available)
without touching callers; for the target deployment shape — one daemon pair
per TPU VM host, tens of hosts — connection counts are small and the pickle
frame path is faster than protobuf ser/des for numpy-bearing payloads.

Frames:  [u32 len][pickle((kind, msg_id, method, payload))]
  kind: 0 = request, 1 = response-ok, 2 = response-error, 3 = one-way,
        4 = keepalive ping, 5 = keepalive pong

Partition tolerance: TCP alone cannot distinguish a black-holed link from
a slow peer — writes buffer locally for minutes before erroring (the gray
failure mode of Huang et al., HotOS'17). Two defenses live here:

- every ``RpcClient.call`` carries a transport deadline by default
  (``configure()`` binds it to Config.rpc_call_timeout_s); expiry raises
  the typed ``RpcTimeout`` and feeds a per-peer suspicion counter the
  telemetry agent drains into the health plane.
- each client connection runs an application-level keepalive: PING every
  ``rpc_keepalive_interval_s``; a connection that stays rx-silent past
  ``rpc_keepalive_timeout_s`` is aborted, converting the black hole into
  ``ConnectionLost`` for every pending caller.

The devtools.chaos interposer (``set_chaos``) sits on the four frame
edges — client egress/ingress, server ingress/egress — so a seeded
FaultPlan can drop/delay/duplicate/reorder/black-hole/reset any link.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as _futures
import itertools
import pickle
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

_LEN = struct.Struct("<I")
REQUEST, RESPONSE_OK, RESPONSE_ERR, ONEWAY, PING, PONG = 0, 1, 2, 3, 4, 5
MAX_FRAME = 1 << 31

# Module defaults; configure(cfg) rebinds them from Config in every
# process entrypoint (runtime/gcs/nodelet/worker). A sentinel — not None —
# marks "caller passed nothing", because explicit timeout=None must keep
# meaning "unbounded" for the reviewed allowlist (push_task).
_UNSET_TIMEOUT: Any = object()
_call_timeout_s: float = 60.0
_keepalive_interval_s: float = 5.0
_keepalive_timeout_s: float = 20.0

# devtools.chaos.Interposer | None — consulted (never imported) here, so
# core stays import-free of devtools.
_chaos: Optional[Any] = None


def configure(cfg) -> None:
    """Bind module-level transport defaults from a core.config.Config."""
    global _call_timeout_s, _keepalive_interval_s, _keepalive_timeout_s
    _call_timeout_s = cfg.rpc_call_timeout_s
    _keepalive_interval_s = cfg.rpc_keepalive_interval_s
    _keepalive_timeout_s = cfg.rpc_keepalive_timeout_s


def set_chaos(interposer: Optional[Any]) -> None:
    global _chaos
    _chaos = interposer


def get_chaos() -> Optional[Any]:
    return _chaos


class RpcError(Exception):
    pass


class RemoteError(RpcError):
    """Handler raised on the other side; message carries remote traceback."""


class ConnectionLost(RpcError):
    """The connection broke. ``dispatched`` tells a call whose frame
    provably never left this process (False: the connection was already
    known closed before anything was written) from one whose frame may
    have reached the peer (True, the default)."""

    def __init__(self, *args, dispatched: bool = True):
        super().__init__(*args)
        self.dispatched = dispatched


# From Python 3.11 on, asyncio.TimeoutError IS the builtin TimeoutError,
# and naming it twice among the bases raises "duplicate base class".
_TIMEOUT_BASES = ((TimeoutError,) if asyncio.TimeoutError is TimeoutError
                  else (asyncio.TimeoutError, TimeoutError))


class RpcTimeout(RpcError, *_TIMEOUT_BASES):
    """Transport deadline expired with no response.

    Subclasses BOTH timeout spellings (pre-3.11 asyncio.TimeoutError is
    not the builtin; from 3.11 they are one class, listed once) so every
    existing wait_for/OSError-family handler
    keeps working — retry loops that treat OSError as "peer unreachable,
    retry" absorb timeouts the same way. Distinct from ConnectionLost
    because the link may be fine and the *peer* gray-failed — the health
    plane treats repeated RpcTimeouts as a peer-suspicion signal."""


# Per-peer timeout suspicions: {(host, port, method): count}, drained by
# the telemetry agent into the GCS health aggregator (a black-holed or
# wedged peer shows up here long before any crash-stop signal).
_suspicion_lock = threading.Lock()
_suspicions: Dict[Tuple[str, int, str], int] = {}


def _note_timeout(host: str, port: int, method: str) -> None:
    with _suspicion_lock:
        key = (host, port, method)
        _suspicions[key] = _suspicions.get(key, 0) + 1
        while len(_suspicions) > 256:
            _suspicions.pop(next(iter(_suspicions)))


def drain_timeout_suspicions() -> List[dict]:
    """Pop-and-return accumulated RpcTimeout counts (telemetry agent)."""
    with _suspicion_lock:
        if not _suspicions:
            return []
        out = [{"peer": f"{h}:{p}", "method": m, "count": c}
               for (h, p, m), c in _suspicions.items()]
        _suspicions.clear()
        return out


async def _read_frame(reader: asyncio.StreamReader):
    hdr = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(hdr)
    data = await reader.readexactly(n)
    return pickle.loads(data)


def _frame(msg) -> bytes:
    data = pickle.dumps(msg, protocol=5)
    return _LEN.pack(len(data)) + data


class RpcServer:
    """Serves methods of a handler object. Any coroutine or plain method named
    ``rpc_<method>`` is callable remotely with a single dict payload."""

    def __init__(self, handler: Any, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        # Per-method handler stats (ref: src/ray/common/event_stats.h —
        # every asio handler is timed; surfaced via `internal_stats`).
        self._stats: Dict[str, Dict[str, float]] = {}
        self._started_at = time.time()
        self._loop_lag_s = 0.0
        self._loop_lag_max_s = 0.0
        self._lag_task: Optional[asyncio.Task] = None
        self._conns: set = set()          # live connection writers
        self._dispatches: set = set()     # in-flight handler tasks

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._lag_task = asyncio.get_running_loop().create_task(
            self._measure_loop_lag())
        return self.host, self.port

    async def _measure_loop_lag(self):
        """Event-loop responsiveness probe: how late a 100ms sleep wakes
        up (ref: event-loop lag surfaced by RAY_CONFIG(event_stats ...)).
        Tracks the max as well — a one-cycle spike would otherwise be
        overwritten before anyone reads it."""
        while True:
            t0 = time.monotonic()
            try:
                await asyncio.sleep(0.1)
            except asyncio.CancelledError:
                return
            lag = max(time.monotonic() - t0 - 0.1, 0.0)
            self._loop_lag_s = lag
            if lag > self._loop_lag_max_s:
                self._loop_lag_max_s = lag

    def _stat(self, method: str) -> Dict[str, float]:
        return self._stats.setdefault(
            method, {"count": 0, "errors": 0, "total_s": 0.0, "max_s": 0.0})

    def internal_stats(self) -> dict:
        """Per-method handler counts/latency + loop lag, for every daemon
        (ref: per-daemon OpenCensus stats, src/ray/stats/metric_defs.h)."""
        return {
            "uptime_s": time.time() - self._started_at,
            "event_loop_lag_s": self._loop_lag_s,
            "event_loop_lag_max_s": self._loop_lag_max_s,
            "handlers": {m: dict(s) for m, s in self._stats.items()},
        }

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    async def stop(self):
        if self._lag_task is not None:
            self._lag_task.cancel()
            self._lag_task = None
        if self._server:
            self._server.close()
        # Grace first, with writers still open, so in-flight handlers can
        # deliver their responses; then close connections to unblock
        # handlers parked in _read_frame; then cancel stragglers — looping,
        # because buffered frames can spawn new dispatches after any
        # one-shot snapshot. Un-awaited tasks at loop teardown are
        # destroyed pending, which is the noise this exists to prevent.
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 1.0
        while self._dispatches and loop.time() < deadline:
            await asyncio.wait(set(self._dispatches),
                               timeout=deadline - loop.time())
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass
        cancel_deadline = loop.time() + 1.0
        while self._dispatches and loop.time() < cancel_deadline:
            stragglers = set(self._dispatches)
            for t in stragglers:
                t.cancel()
            await asyncio.wait(stragglers,
                               timeout=cancel_deadline - loop.time())
        if self._server:
            try:
                await self._server.wait_closed()
            except Exception:
                pass

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        # Sender role for chaos rule matching: the client announces it in
        # a __hello__ oneway right after connect (only when a plan is
        # installed); "*" until/unless one arrives.
        conn_role = "*"
        try:
            while True:
                try:
                    kind, msg_id, method, payload = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                if kind == ONEWAY and method == "__hello__":
                    conn_role = payload.get("role", "*")
                    continue
                if kind == PING:
                    # keepalive probe: answer inline unless an installed
                    # fault plan black-holes this link (a dropped PONG is
                    # exactly how a black hole converts to ConnectionLost
                    # on the other side)
                    if _chaos is None or _chaos.on_frame(
                            "recv", "__ping__", PING,
                            peer_role=conn_role).action == "pass":
                        writer.write(_frame((PONG, msg_id, "", None)))
                        await writer.drain()
                    continue
                delay_s = 0.0
                copies = 1
                if _chaos is not None:
                    v = _chaos.on_frame("recv", method, kind,
                                        peer_role=conn_role)
                    if v.action == "drop":
                        continue
                    if v.action == "reset":
                        try:
                            writer.transport.abort()
                        except Exception:
                            pass
                        return
                    if v.action == "delay":
                        delay_s = v.delay_s
                    elif v.action == "duplicate":
                        copies = 2
                if kind == ONEWAY and not delay_s and copies == 1:
                    # inline fast path for handlers that opt in (standing
                    # channel frames): a synchronous, non-blocking handler
                    # runs right here, skipping a dispatch-task round on
                    # the loop — the per-hop hot path of compiled DAGs
                    fn = getattr(self.handler, f"rpc_{method}", None)
                    if fn is not None and getattr(fn, "_rpc_inline", False):
                        try:
                            fn(**payload)
                        except Exception:
                            self._stat(method)["errors"] += 1
                        continue
                for _ in range(copies):
                    t = asyncio.get_running_loop().create_task(
                        self._dispatch(writer, kind, msg_id, method, payload,
                                       conn_role=conn_role, delay_s=delay_s))
                    self._dispatches.add(t)
                    t.add_done_callback(self._dispatches.discard)
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, writer, kind, msg_id, method, payload,
                        conn_role: str = "*", delay_s: float = 0.0):
        if delay_s:
            # injected ingress delay: later frames overtake this dispatch
            # (reordering), which is the point
            await asyncio.sleep(delay_s)
        t0 = time.monotonic()
        known = True
        try:
            if method == "internal_stats":
                res = self.internal_stats()
            else:
                fn = getattr(self.handler, f"rpc_{method}", None)
                if fn is None:
                    # don't let client-supplied garbage names grow _stats
                    known = False
                    raise RpcError(f"no such method: {method}")
                res = fn(**payload)
                if asyncio.iscoroutine(res):
                    res = await res
            el = time.monotonic() - t0
            s = self._stat(method)
            s["count"] += 1
            s["total_s"] += el
            if el > s["max_s"]:
                s["max_s"] = el
            if kind == REQUEST:
                await self._send_response(
                    writer, (RESPONSE_OK, msg_id, method, res), conn_role)
        except BaseException:
            # BaseException: a handler awaiting a cancelled executor
            # future raises CancelledError — the caller must still get a
            # RESPONSE_ERR, or its pending future hangs forever. (During
            # server stop the writer is already closed, so the write
            # below fails silently and cancellation proceeds.)
            if known:
                self._stat(method)["errors"] += 1
            if kind == REQUEST:
                try:
                    await self._send_response(
                        writer,
                        (RESPONSE_ERR, msg_id, method, traceback.format_exc()),
                        conn_role)
                except Exception:
                    pass

    async def _send_response(self, writer, msg, conn_role: str):
        """Response egress — the server-side chaos edge for reply frames."""
        if _chaos is not None:
            v = _chaos.on_frame("send", msg[2], msg[0], peer_role=conn_role)
            if v.action == "drop":
                return
            if v.action == "reset":
                try:
                    writer.transport.abort()
                except Exception:
                    pass
                return
            if v.action == "delay":
                await asyncio.sleep(v.delay_s)
            elif v.action == "duplicate":
                writer.write(_frame(msg))
        writer.write(_frame(msg))
        await writer.drain()


class RpcClient:
    """One connection to one server; safe for concurrent calls from one loop."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._ids = itertools.count()
        self._conn_lock: Optional[asyncio.Lock] = None
        self._read_task: Optional[asyncio.Task] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._last_rx = 0.0
        self._chaos_tasks: set = set()   # injected delayed-send tasks
        # bumps on every (re)connect — lets callers notice a silent
        # server restart (e.g. to re-register pubsub subscriptions)
        self.generation = 0

    async def _ensure(self):
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
            self.generation += 1
            self._last_rx = time.monotonic()
            loop = asyncio.get_running_loop()
            self._read_task = loop.create_task(self._read_loop())
            if _chaos is not None:
                # announce our role so the server side can match
                # src-role rules on this connection
                self._writer.write(_frame(
                    (ONEWAY, 0, "__hello__", {"role": _chaos.role})))
            if _keepalive_interval_s > 0:
                if self._keepalive_task is not None:
                    self._keepalive_task.cancel()
                self._keepalive_task = loop.create_task(
                    self._keepalive(self._writer))

    async def _keepalive(self, writer):
        """PING the server every interval; abort the connection when no
        frame (response OR pong) has arrived within the keepalive
        timeout — a black-holed link becomes ConnectionLost for every
        pending caller instead of an indefinite hang."""
        interval = _keepalive_interval_s
        try:
            while True:
                await asyncio.sleep(interval)
                if self._writer is not writer or writer.is_closing():
                    return
                if time.monotonic() - self._last_rx > _keepalive_timeout_s:
                    try:
                        writer.transport.abort()
                    except Exception:
                        pass
                    return
                try:
                    if _chaos is None or _chaos.on_frame(
                            "send", "__ping__", PING,
                            peer=(self.host, self.port)).action == "pass":
                        writer.write(_frame((PING, 0, "", None)))
                        await writer.drain()
                except Exception:
                    return
        except asyncio.CancelledError:
            return

    async def _read_loop(self):
        try:
            while True:
                kind, msg_id, method, payload = await _read_frame(self._reader)
                self._last_rx = time.monotonic()
                if kind == PONG:
                    continue
                if _chaos is not None:
                    v = _chaos.on_frame("recv", method, kind,
                                        peer=(self.host, self.port))
                    if v.action == "drop":
                        continue
                    if v.action == "reset":
                        try:
                            self._writer.transport.abort()
                        except Exception:
                            pass
                        break
                    if v.action == "delay":
                        fut = self._pending.pop(msg_id, None)
                        if fut is not None:
                            self._spawn_chaos(self._deliver_late(
                                fut, kind, method, payload, v.delay_s))
                        continue
                fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue
                if kind == RESPONSE_OK:
                    fut.set_result(payload)
                else:
                    fut.set_exception(RemoteError(f"{method} failed remotely:\n{payload}"))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            err = ConnectionLost(f"connection to {self.host}:{self.port} lost")
            for fut in self._pending.values():
                try:
                    if not fut.done():
                        fut.set_exception(err)
                except RuntimeError:
                    pass  # loop already closed during shutdown
            self._pending.clear()
            if self._keepalive_task is not None:
                self._keepalive_task.cancel()
                self._keepalive_task = None
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:
                    pass
            self._writer = None

    def _spawn_chaos(self, coro):
        t = asyncio.get_running_loop().create_task(coro)
        self._chaos_tasks.add(t)
        t.add_done_callback(self._chaos_tasks.discard)

    @staticmethod
    async def _deliver_late(fut, kind, method, payload, delay_s: float):
        await asyncio.sleep(delay_s)
        if fut.done():
            return
        if kind == RESPONSE_OK:
            fut.set_result(payload)
        else:
            fut.set_exception(RemoteError(f"{method} failed remotely:\n{payload}"))

    async def connect(self) -> None:
        """Ensure the connection is open without sending anything — lets
        callers that need send-vs-connect failure attribution (actor task
        dispatch) establish the link as a separate, provably-unsent step."""
        await self._ensure()

    async def call(self, method: str, timeout: Optional[float] = _UNSET_TIMEOUT,
                   **payload) -> Any:
        """One request/response round-trip.

        ``timeout`` omitted ⇒ the module default deadline
        (Config.rpc_call_timeout_s) applies and expiry raises RpcTimeout.
        An *explicit* ``timeout=None`` means unbounded — reserved for the
        reviewed allowlist (raylint: unbounded-rpc-call)."""
        if timeout is _UNSET_TIMEOUT:
            timeout = _call_timeout_s
        fut = await self.start_call(method, **payload)
        if timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(fut, timeout)
        except (asyncio.TimeoutError, TimeoutError):
            if fut.done() and not fut.cancelled():
                # completed inside wait_for's cancellation window
                return fut.result()
            for mid, f in list(self._pending.items()):
                if f is fut:
                    self._pending.pop(mid, None)
                    break
            _note_timeout(self.host, self.port, method)
            raise RpcTimeout(
                f"rpc {method} to {self.host}:{self.port} exceeded its "
                f"{timeout}s deadline") from None

    async def _send(self, msg, method: str, kind: int) -> None:
        """Request/oneway egress — the client-side chaos edge."""
        if _chaos is not None:
            v = _chaos.on_frame("send", method, kind,
                                peer=(self.host, self.port))
            if v.action == "drop":
                # pretend written: the caller's deadline (or keepalive)
                # surfaces the loss as RpcTimeout/ConnectionLost
                return
            if v.action == "reset":
                try:
                    self._writer.transport.abort()
                except Exception:
                    pass
                raise ConnectionLost(
                    f"connection to {self.host}:{self.port} reset (injected)")
            if v.action == "delay":
                writer, frame = self._writer, _frame(msg)

                async def _later():
                    await asyncio.sleep(v.delay_s)
                    if self._writer is writer and not writer.is_closing():
                        writer.write(frame)

                self._spawn_chaos(_later())
                return
            if v.action == "duplicate":
                self._writer.write(_frame(msg))
        self._writer.write(_frame(msg))
        await self._writer.drain()

    async def start_call(self, method: str, **payload) -> asyncio.Future:
        """Write the request frame now; return the pending future.

        The frame is on the wire (FIFO per connection) when this returns, so
        callers that need ordered delivery (actor submit queues) serialize by
        awaiting start_call before issuing the next one."""
        await self._ensure()
        if self._reader.at_eof() or self._writer.is_closing():
            # the peer's EOF is already buffered (or the transport is
            # closing) but _read_loop has not run to close the connection
            # yet: write nothing, so the call provably never left us. Yield
            # once first, as a written call would: _read_loop then closes
            # the connection before a caller's retry reaches _ensure.
            await asyncio.sleep(0)
            raise ConnectionLost(
                f"connection to {self.host}:{self.port} already closed",
                dispatched=False)
        msg_id = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        await self._send((REQUEST, msg_id, method, payload), method, REQUEST)
        return fut

    async def oneway(self, method: str, **payload) -> None:
        await self._ensure()
        await self._send((ONEWAY, next(self._ids), method, payload),
                         method, ONEWAY)

    async def close(self):
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
            self._keepalive_task = None
        for t in list(self._chaos_tasks):
            t.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
        if self._read_task:
            self._read_task.cancel()
            await asyncio.wait([self._read_task], timeout=0.5)
            self._read_task = None


class ClientPool:
    """Caches RpcClients by address (ref: rpc::ClientCallManager pooling)."""

    def __init__(self):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}

    def get(self, addr: Tuple[str, int]) -> RpcClient:
        addr = tuple(addr)
        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = RpcClient(*addr)
        return c

    def drop(self, addr: Tuple[str, int]) -> None:
        self._clients.pop(tuple(addr), None)

    async def close_all(self):
        for c in self._clients.values():
            await c.close()
        self._clients.clear()


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread.

    Drivers and workers embed their networked runtime this way (the reference
    embeds an io_service thread inside CoreWorker). Synchronous public API
    calls bridge in via `run()`.
    """

    def __init__(self, name: str = "ray_tpu_torch-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._main, name=name, daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()

    def _main(self):
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(self._started.set)
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        """Run coroutine on the loop from another thread; blocks for result.

        Never blocks past loop death: if the loop stops (shutdown) while a
        caller waits, raise ConnectionLost instead of hanging — otherwise a
        non-daemon executor thread parked in fut.result(None) deadlocks
        interpreter exit (concurrent.futures joins its threads at exit)."""
        import time as _time

        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            step = 0.5
            if deadline is not None:
                step = min(step, max(deadline - _time.monotonic(), 0.0))
            try:
                return fut.result(step)
            except asyncio.CancelledError:
                # stop()'s drain cancelled the task under us; keep the
                # documented contract (CancelledError is a BaseException —
                # callers' `except Exception` handlers never see it)
                raise ConnectionLost("runtime event loop stopped") from None
            except (TimeoutError, _futures.TimeoutError):
                # both spellings: before 3.11 concurrent.futures'
                # TimeoutError is NOT the builtin, and fut.result raises
                # the futures one — catching only the builtin turns every
                # >0.5s coroutine into a spurious timeout
                if fut.done():
                    # Completed during the poll window: surface the real
                    # outcome (result, or the coroutine's own exception).
                    return fut.result()
                if not self.loop.is_running() or not self._thread.is_alive():
                    fut.cancel()
                    raise ConnectionLost("runtime event loop stopped") from None
                if deadline is not None and _time.monotonic() >= deadline:
                    fut.cancel()
                    # normalize to the builtin so callers need one spelling
                    raise TimeoutError(
                        f"coroutine did not finish within {timeout}s"
                    ) from None

    def spawn(self, coro):
        """Fire-and-forget from any thread."""
        def _create():
            self.loop.create_task(coro)
        self.loop.call_soon_threadsafe(_create)

    def stop(self):
        # Drain before stopping: a task still pending when the loop dies is
        # destroyed un-awaited and asyncio logs "Task was destroyed but it
        # is pending!" — in a long-lived daemon that noise is where real
        # leaks hide, so cancel and await everything first.
        async def _drain():
            # Iterate: cancelling one task can spawn another (a cancelled
            # caller's teardown may reconnect, creating a fresh _read_loop),
            # so a one-shot snapshot can leave brand-new tasks pending.
            cur = asyncio.current_task()
            deadline = asyncio.get_running_loop().time() + 2.0
            while True:
                tasks = [t for t in asyncio.all_tasks() if t is not cur]
                if not tasks:
                    break
                for t in tasks:
                    t.cancel()
                left = deadline - asyncio.get_running_loop().time()
                if left <= 0:
                    break
                await asyncio.wait(tasks, timeout=min(left, 1.0))

        if self._thread.is_alive() and self.loop.is_running():
            try:
                asyncio.run_coroutine_threadsafe(
                    _drain(), self.loop).result(3.0)
            except Exception:
                pass
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            pass  # loop already closed
        self._thread.join(timeout=2)
