"""Send-vs-connect attribution of the port's RPC client (ray_tpu_torch/
core/rpc.py) and the actor sender that reads it (core/runtime.py).

A push to an actor whose worker was killed must not count as dispatched
when the client already knew the connection was closed: the peer's EOF
is buffered in the reader, but ``_read_loop`` has not run yet to close
the connection, so ``_ensure`` hands back the dead one. ``start_call``
then writes nothing and raises ``ConnectionLost`` with ``dispatched``
False, and ``Runtime._actor_sender`` passes that on, so the serve proxy
may re-route a non-idempotent POST instead of answering 500. A frame
that was written and then lost still counts as dispatched. A worker
that outlives its killed actor (a lane host) refuses the push as "no
actor hosted here" before running it: that is not dispatched either.
"""

import asyncio
import types
from collections import deque

from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.rpc import ConnectionLost, RemoteError, RpcClient
from ray_tpu_torch.core.status import ActorDiedError


async def _server(on_conn):
    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


async def _until(pred, timeout_s=10.0):
    """Poll `pred` one loop iteration at a time (``sleep(0)``), so this
    coroutine runs right after the iteration whose I/O made it true."""
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout_s
    while not pred():
        assert loop.time() < end, "condition not reached in time"
        await asyncio.sleep(0)


def test_start_call_after_peer_eof_is_not_dispatched():
    async def main():
        received = []
        closed = asyncio.Event()

        async def on_conn(reader, writer):
            writer.close()                  # the worker dies: EOF, no reply
            received.append(await reader.read())
            closed.set()

        server, port = await _server(on_conn)
        client = RpcClient("127.0.0.1", port)
        await client.connect()
        # the client has read the EOF, but its read loop has not yet run to
        # close the connection: the writer still looks open
        await _until(lambda: client._reader.at_eof())
        assert not client._writer.is_closing()
        try:
            await client.start_call("push_actor_task", spec="s")
        except ConnectionLost as e:
            err = e
        else:
            raise AssertionError("start_call wrote into a closed connection")
        assert err.dispatched is False
        assert client._pending == {}
        await asyncio.wait_for(closed.wait(), 10)
        assert received == [b""], "a frame reached the closed peer"
        await client.close()
        server.close()
        await server.wait_closed()

    asyncio.run(main())


def test_written_frame_lost_after_write_counts_as_dispatched():
    async def main():
        async def on_conn(reader, writer):
            await reader.read(1)            # the request reached the peer
            writer.close()                  # ... which died before replying

        server, port = await _server(on_conn)
        client = RpcClient("127.0.0.1", port)
        fut = await client.start_call("push_actor_task", spec="s")
        try:
            await asyncio.wait_for(fut, 10)
        except ConnectionLost as e:
            err = e
        else:
            raise AssertionError("the call did not fail")
        assert err.dispatched is True
        await client.close()
        server.close()
        await server.wait_closed()

    asyncio.run(main())


def test_connection_lost_defaults_to_dispatched():
    assert ConnectionLost("x").dispatched is True
    assert ConnectionLost("x", dispatched=False).dispatched is False
    assert str(ConnectionLost("x", dispatched=False)) == "x"


class _FakeClient:
    def __init__(self, err):
        self.err = err

    async def connect(self):
        return None

    async def start_call(self, method, **payload):
        raise self.err


def _drive_sender(err):
    """Runtime._actor_sender over one queued push whose start_call raises
    `err`; the `dispatched` it hands to _on_actor_push_failure."""
    seen = []

    async def main():
        actor_id = "a1"
        queue = deque([("spec", 0)])

        async def resolve(aid):
            return ("127.0.0.1", 1)

        async def on_failure(spec, retries, addr, e, *, dispatched=True):
            seen.append(dispatched)

        fake = types.SimpleNamespace(
            _actor_sending={}, _actor_queue=lambda aid: queue,
            _resolve_actor=resolve,
            pool=types.SimpleNamespace(get=lambda addr: _FakeClient(err)),
            _on_actor_push_failure=on_failure,
            loop=asyncio.get_running_loop(), _spawn=lambda coro: coro.close())
        await runtime_mod.Runtime._actor_sender(fake, actor_id)

    asyncio.run(main())
    return seen


def test_actor_sender_passes_not_dispatched_on():
    assert _drive_sender(ConnectionLost("gone", dispatched=False)) == [False]


def test_actor_sender_keeps_a_written_push_dispatched():
    assert _drive_sender(ConnectionLost("reset")) == [True]
    assert _drive_sender(ConnectionResetError("reset")) == [True]


class _Gcs:
    def __init__(self, view):
        self.view = view

    async def call(self, method, **kw):
        assert method == "get_actor"
        return self.view


def _push_failure(err, state):
    """The error Runtime._on_actor_push_failure surfaces for a push that
    failed with `err` while the GCS holds the actor in `state`."""
    failed = []
    actor_id = ActorID.from_random()
    spec = types.SimpleNamespace(actor_id=actor_id)
    addr = ("127.0.0.1", 1)
    fake = types.SimpleNamespace(
        _actor_addr={actor_id: addr}, gcs_addr=("127.0.0.1", 2),
        pool=types.SimpleNamespace(
            drop=lambda a: None,
            get=lambda a: _Gcs({"state": state,
                                "death_cause": "killed via kill"})),
        _fail_task_returns=lambda spec, e: failed.append(e),
        flight=types.SimpleNamespace(dump=lambda *a: None))

    async def main():
        await runtime_mod.Runtime._on_actor_push_failure(
            fake, spec, 0, addr, err)

    asyncio.run(main())
    assert len(failed) == 1
    return failed[0]


def test_refused_push_to_a_dead_actor_is_not_dispatched():
    err = _push_failure(RemoteError(
        "push_actor_task failed remotely:\nRuntimeError: no actor hosted "
        "here"), "DEAD")
    assert isinstance(err, ActorDiedError) and err.dispatched is False


def test_push_lost_after_its_write_stays_dispatched():
    err = _push_failure(ConnectionLost("connection lost"), "DEAD")
    assert isinstance(err, ActorDiedError) and err.dispatched is True
