"""Client gateway: remote drivers over a language-neutral JSON protocol.

Port of ray_tpu/client_gateway.py over the port's runtime, on the same
wire, so the repo's C++ (cpp/), Perl and Java (clients/) clients work
against either package unchanged. A torch tensor reaches a JSON-only
client as the reference's numpy array does (nested lists; a 0-d tensor as
its number); torch is imported only where a value is a tensor.

Reference: Ray Client (python/ray/util/client/ARCHITECTURE.md) — a thin
client forwards API calls to a server-side driver that owns all objects
and actors (util/client/server/{server.py,proxier.py}); and the C++
worker API (cpp/include/ray/api.h) whose runtime speaks to the core from
another language.

Re-design: instead of a gRPC proto + per-language codegen, one gateway
process holds a real driver Runtime and serves newline-free
length-prefixed JSON frames:

    [u32 little-endian length][utf-8 JSON]
    request : {"id": N, "method": str, "params": {...}}
    response: {"id": N, "ok": true, "result": ...} | {"id": N, "ok":
               false, "error": str}

Values cross the wire as JSON, with two extension markers:
    {"__bytes__": base64}   raw bytes (any client)
    {"__pickle__": base64}  cloudpickle payload (python clients only —
                            this is how arbitrary functions/objects ship,
                            like Ray Client's pickled function protocol)
    {"__ref__": hex}        an ObjectRef owned by the gateway driver

The same protocol serves the Python thin client (ray_tpu_torch/client.py) and
the C++ API (cpp/) — one server, any language.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import importlib
import json
import logging
import struct
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.client_gateway")

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 30


def _called_by_name(path: str, *args, **kwargs):
    """Cluster-side trampoline for C++/named-function tasks: resolve
    "module:attr" on the executing worker and call it."""
    mod, _, name = path.partition(":")
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn(*args, **kwargs)


def _stream_by_name(path: str, *args, **kwargs):
    """Streaming twin of _called_by_name: the named callable's result is
    re-yielded item by item (a generator/iterable becomes a streaming
    generator task; a scalar streams as one item)."""
    out = _called_by_name(path, *args, **kwargs)
    if hasattr(out, "__iter__") and not isinstance(out, (str, bytes, dict)):
        yield from out
    else:
        yield out


class _Codec:
    """JSON <-> python values with the extension markers above."""

    def __init__(self, refs: Dict[str, Any]):
        self.refs = refs  # hex -> ObjectRef (gateway-owned)

    def decode(self, v):
        if isinstance(v, dict):
            if "__bytes__" in v and len(v) == 1:
                return base64.b64decode(v["__bytes__"])
            if "__pickle__" in v and len(v) == 1:
                import cloudpickle

                return cloudpickle.loads(base64.b64decode(v["__pickle__"]))
            if "__ref__" in v and len(v) == 1:
                ref = self.refs.get(v["__ref__"])
                if ref is None:
                    raise KeyError(f"unknown ref {v['__ref__']}")
                return ref
            if "__tuple__" in v and len(v) == 1:
                return tuple(self.decode(x) for x in v["__tuple__"])
            return {k: self.decode(x) for k, x in v.items()}
        if isinstance(v, list):
            return [self.decode(x) for x in v]
        return v

    def encode(self, v, *, pickle_fallback: bool):
        """Containers recurse (so nested ObjectRefs keep their __ref__
        markers in both directions); only non-container leaves fall back
        to pickle. A ref buried inside a custom OBJECT (not a dict/list/
        tuple) is still pickled opaquely — unsupported, as in Ray
        Client's value protocol."""
        import ray_tpu_torch

        if isinstance(v, ray_tpu_torch.ObjectRef):
            h = v.id.hex()
            self.refs[h] = v
            return {"__ref__": h}
        if isinstance(v, bytes):
            return {"__bytes__": base64.b64encode(v).decode()}
        if isinstance(v, dict):
            return {str(k): self.encode(x, pickle_fallback=pickle_fallback)
                    for k, x in v.items()}
        if isinstance(v, tuple) and pickle_fallback:
            return {"__tuple__": [self.encode(x,
                                              pickle_fallback=pickle_fallback)
                                  for x in v]}
        if isinstance(v, (list, tuple)):
            return [self.encode(x, pickle_fallback=pickle_fallback)
                    for x in v]
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        try:
            import numpy as np

            if isinstance(v, np.generic):
                return v.item()
        except ImportError:
            pass
        if pickle_fallback:
            import cloudpickle

            return {"__pickle__":
                    base64.b64encode(cloudpickle.dumps(v)).decode()}
        # numpy arrays for JSON-only clients
        try:
            import numpy as np

            if isinstance(v, np.ndarray):
                return [self.encode(x, pickle_fallback=pickle_fallback)
                        for x in v.tolist()]
        except ImportError:
            pass
        # torch tensors too: no tensor exists unless torch is loaded
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(v, torch.Tensor):
            if v.dim() == 0:
                return v.item()
            return [self.encode(x, pickle_fallback=pickle_fallback)
                    for x in v.tolist()]
        raise TypeError(f"value of type {type(v).__name__} is not "
                        "JSON-representable; use a python client")


class ClientGateway:
    """One driver Runtime serving many remote clients
    (ref: proxier.py — but sharing one driver, not one per client)."""

    def __init__(self, cluster_address: str, host: str = "0.0.0.0",
                 port: int = 0):
        self.cluster_address = cluster_address
        self.host, self.port = host, port
        self.refs: Dict[str, Any] = {}
        self.actors: Dict[str, Any] = {}
        self.pgs: Dict[str, Any] = {}      # hex -> PlacementGroup
        self.streams: Dict[str, Any] = {}  # id -> ObjectRefGenerator iter
        self._stream_ids = 0
        self.codec = _Codec(self.refs)
        # driver API calls block (ray_tpu_torch.get); keep them off the loop
        self.pool = ThreadPoolExecutor(max_workers=16,
                                       thread_name_prefix="gateway")
        self._server: Optional[asyncio.AbstractServer] = None

    # --------------------------------------------------------------- methods

    def m_ping(self, _session=None, **_):
        return {"ok": True}

    def m_cluster_resources(self, _session=None, **_):
        import ray_tpu_torch

        return ray_tpu_torch.cluster_resources()

    def _track_refs(self, session, refs):
        for r in refs:
            h = r.id.hex()
            self.refs[h] = r
            if session is not None:
                session["refs"].add(h)
        return [r.id.hex() for r in refs]

    def m_put(self, value=None, _session=None):
        import ray_tpu_torch

        ref = ray_tpu_torch.put(self.codec.decode(value))
        return {"ref": self._track_refs(_session, [ref])[0]}

    def m_get(self, refs=None, timeout: float = 60.0, pickle_ok=False,
              _session=None):
        import ray_tpu_torch

        objs = [self.refs[h] for h in refs]
        vals = ray_tpu_torch.get(objs, timeout=timeout)
        return {"values": [self.codec.encode(v, pickle_fallback=pickle_ok)
                           for v in vals]}

    def m_wait(self, refs=None, num_returns: int = 1,
               timeout: Optional[float] = None, _session=None):
        import ray_tpu_torch

        objs = [self.refs[h] for h in refs]
        ready, pending = ray_tpu_torch.wait(objs, num_returns=num_returns,
                                      timeout=timeout)
        return {"ready": [r.id.hex() for r in ready],
                "pending": [p.id.hex() for p in pending]}

    def _options(self, opts):
        out = {}
        for k in ("num_returns", "num_cpus", "resources", "max_retries",
                  "runtime_env", "name", "namespace", "lifetime",
                  "max_restarts", "max_task_retries", "max_concurrency"):
            if opts and k in opts:
                out[k] = opts[k]
        if opts and "placement_group" in opts:
            # PG-aware scheduling over the wire (ref: Ray Client proxies
            # PlacementGroupSchedulingStrategy the same way)
            from ray_tpu_torch.util.scheduling_strategies import (
                                                                  PlacementGroupSchedulingStrategy)

            pg = self.pgs[opts["placement_group"]]
            out["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                pg, opts.get("placement_group_bundle_index", -1))
        return out

    def _track_result(self, refs, _session):
        """Task/actor-call result: plain refs or a streaming generator."""
        import ray_tpu_torch

        if isinstance(refs, ray_tpu_torch.ObjectRefGenerator):
            self._stream_ids += 1
            sid = f"s{self._stream_ids}"
            # generator + explicit cursor (NOT a bare iterator): item
            # fetches go through next_stream_ref with a bounded timeout,
            # and the cursor advances only after a successful delivery —
            # a timed-out pull can be retried without losing the item
            self.streams[sid] = {"gen": refs, "index": 0}
            if _session is not None:
                _session["streams"].add(sid)
            return {"stream": sid}
        refs = refs if isinstance(refs, list) else [refs]
        return {"refs": self._track_refs(_session, refs)}

    def m_task(self, func: str = None, args=None, kwargs=None, opts=None,
               _session=None):
        """Named-function task: any-language clients submit
        "module:function"; execution resolves it on the worker."""
        import ray_tpu_torch

        args = [self.codec.decode(a) for a in (args or [])]
        kwargs = {k: self.codec.decode(v) for k, v in (kwargs or {}).items()}
        streaming = (opts or {}).get("num_returns") == "streaming"
        rf = ray_tpu_torch.remote(_stream_by_name if streaming
                            else _called_by_name)
        o = self._options(opts)
        if o:
            rf = rf.options(**o)
        return self._track_result(rf.remote(func, *args, **kwargs),
                                  _session)

    def m_task_pickled(self, func=None, args=None, kwargs=None, opts=None,
                       _session=None):
        """Python clients ship the function itself (ref: Ray Client's
        pickled-function protocol)."""
        import ray_tpu_torch

        fn = self.codec.decode(func)
        args = [self.codec.decode(a) for a in (args or [])]
        kwargs = {k: self.codec.decode(v) for k, v in (kwargs or {}).items()}
        rf = ray_tpu_torch.remote(fn)
        o = self._options(opts)
        if o:
            rf = rf.options(**o)
        return self._track_result(rf.remote(*args, **kwargs), _session)

    def _register_actor(self, handle, session=None, owned=False):
        h = handle._actor_id.hex()
        self.actors[h] = handle
        if session is not None and owned:
            session["actors"].add(h)
        return {"actor": h}

    def m_actor_create(self, cls: str = None, pickled=None, args=None,
                       kwargs=None, opts=None, _session=None):
        import ray_tpu_torch

        if pickled is not None:
            klass = self.codec.decode(pickled)
        else:
            mod, _, name = cls.partition(":")
            klass = getattr(importlib.import_module(mod), name)
        args = [self.codec.decode(a) for a in (args or [])]
        kwargs = {k: self.codec.decode(v) for k, v in (kwargs or {}).items()}
        ac = ray_tpu_torch.remote(klass)
        o = self._options(opts)
        if o:
            ac = ac.options(**o)
        # unnamed actors die with their session; named ones are
        # detached-like and survive (ref: Ray Client lifetime rules)
        owned = not (opts or {}).get("name")
        return self._register_actor(ac.remote(*args, **kwargs), _session,
                                    owned=owned)

    def m_actor_call(self, actor: str = None, method: str = None, args=None,
                     kwargs=None, num_returns: int = 1, _session=None):
        handle = self.actors[actor]
        args = [self.codec.decode(a) for a in (args or [])]
        kwargs = {k: self.codec.decode(v) for k, v in (kwargs or {}).items()}
        m = getattr(handle, method)
        if num_returns != 1:
            m = m.options(num_returns=num_returns)
        return self._track_result(m.remote(*args, **kwargs), _session)

    def m_get_actor(self, name: str = None, namespace: str = "default",
                    _session=None):
        import ray_tpu_torch

        return self._register_actor(
            ray_tpu_torch.get_actor(name, namespace=namespace))

    def m_kill(self, actor: str = None, _session=None):
        import ray_tpu_torch

        ray_tpu_torch.kill(self.actors.pop(actor))
        if _session is not None:
            _session["actors"].discard(actor)
        return {"ok": True}

    def m_release(self, refs=None, _session=None):
        """Drop gateway-held refs so the cluster can reclaim the objects
        (the thin client's del hook, ref: client reference counting)."""
        for h in refs or []:
            self.refs.pop(h, None)
            if _session is not None:
                _session["refs"].discard(h)
        return {"ok": True}

    def m_stream_next(self, stream: str = None, timeout: float = 60.0,
                      pickle_ok=False, _session=None):
        """Pull the next item of a streaming-generator call (ref: Ray
        Client has no streaming surface — this closes that gap for all
        gateway languages). Returns {"done": true} at exhaustion."""
        import ray_tpu_torch

        st = self.streams.get(stream)
        if st is None:
            raise KeyError(f"unknown stream {stream!r}")
        from ray_tpu_torch.core import runtime as _rt
        from ray_tpu_torch.core.status import GetTimeoutError

        gen, idx = st["gen"], st["index"] + 1
        # bounded wait that does NOT consume on timeout: GetTimeoutError
        # propagates to the client, which may simply call again — unlike
        # next(it), the cursor only moves after a successful delivery,
        # and a slow stream can't park a pool thread forever
        try:
            ref = _rt.get_runtime().next_stream_ref(gen.task_id, idx,
                                                    timeout=timeout)
            ended = ref is None
            value = None if ended else ray_tpu_torch.get(ref)  # ready: no wait
        except GetTimeoutError:
            raise                          # retryable: cursor unmoved
        except Exception:
            self.streams.pop(stream, None)  # stream errored: surface it
            if _session is not None:
                _session["streams"].discard(stream)
            raise
        if ended:
            self.streams.pop(stream, None)
            if _session is not None:
                _session["streams"].discard(stream)
            return {"done": True}
        st["index"] = idx
        return {"done": False,
                "value": self.codec.encode(value, pickle_fallback=pickle_ok)}

    def m_stream_close(self, stream: str = None, _session=None):
        self.streams.pop(stream, None)
        if _session is not None:
            _session["streams"].discard(stream)
        return {"ok": True}

    def m_pg_create(self, bundles=None, strategy: str = "PACK",
                    _session=None):
        """Placement groups over the wire (ref: Ray Client proxies
        util.placement_group the same way)."""
        from ray_tpu_torch.util.placement_group import placement_group

        pg = placement_group(bundles, strategy=strategy)
        h = pg.id.hex()
        self.pgs[h] = pg
        if _session is not None:
            _session["pgs"].add(h)
        return {"pg": h}

    def m_pg_ready(self, pg: str = None, timeout: float = 30.0,
                   _session=None):
        return {"ready": bool(self.pgs[pg].ready(timeout=timeout))}

    def m_pg_table(self, pg: str = None, _session=None):
        def jsonable(v):
            if hasattr(v, "hex") and callable(getattr(v, "hex", None)) \
                    and not isinstance(v, (str, bytes, float)):
                return v.hex()          # BaseID subclasses
            if hasattr(v, "quantities"):
                return dict(v.quantities)   # ResourceSet
            if isinstance(v, dict):
                return {str(k): jsonable(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [jsonable(x) for x in v]
            if v is None or isinstance(v, (bool, int, float, str)):
                return v
            return repr(v)
        return {"table": jsonable(self.pgs[pg].table())}

    def m_pg_remove(self, pg: str = None, _session=None):
        from ray_tpu_torch.util.placement_group import remove_placement_group

        g = self.pgs.pop(pg, None)
        if _session is not None:
            _session["pgs"].discard(pg)
        if g is not None:
            remove_placement_group(g)
        return {"ok": True}

    def _close_session(self, session):
        """Connection teardown: release the session's refs and kill its
        unnamed actors (ref: Ray Client per-client driver teardown)."""
        import ray_tpu_torch

        for h in session["refs"]:
            self.refs.pop(h, None)
        for h in session["actors"]:
            handle = self.actors.pop(h, None)
            if handle is not None:
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:
                    pass
        for sid in session["streams"]:
            self.streams.pop(sid, None)
        for h in session["pgs"]:
            g = self.pgs.pop(h, None)
            if g is not None:
                try:
                    from ray_tpu_torch.util.placement_group import (
                                                                    remove_placement_group)

                    remove_placement_group(g)
                except Exception:
                    pass

    # ----------------------------------------------------------------- serve

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        loop = asyncio.get_running_loop()
        session = {"refs": set(), "actors": set(), "streams": set(),
                   "pgs": set()}
        try:
            while True:
                try:
                    hdr = await reader.readexactly(4)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                (n,) = _LEN.unpack(hdr)
                if n > MAX_FRAME:
                    return
                body = await reader.readexactly(n)
                req = json.loads(body)
                mid = req.get("id")
                try:
                    fn = getattr(self, f"m_{req.get('method')}", None)
                    if fn is None:
                        raise ValueError(f"no method {req.get('method')!r}")
                    res = await loop.run_in_executor(
                        self.pool,
                        lambda: fn(**(req.get("params") or {}),
                                   _session=session))
                    out = {"id": mid, "ok": True, "result": res}
                except Exception as e:
                    logger.debug("gateway method failed", exc_info=True)
                    out = {"id": mid, "ok": False,
                           "error": f"{type(e).__name__}: {e}"}
                try:
                    data = json.dumps(out).encode()
                except TypeError as e:
                    # a method returned something non-JSON: surface the
                    # error to the caller instead of killing the stream
                    out = {"id": mid, "ok": False,
                           "error": f"unserializable result: {e}"}
                    data = json.dumps(out).encode()
                writer.write(_LEN.pack(len(data)) + data)
                await writer.drain()
        finally:
            await loop.run_in_executor(self.pool,
                                       lambda: self._close_session(session))
            try:
                writer.close()
            except Exception:
                pass

    async def start(self):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            # init() drives its own asyncio plumbing with asyncio.run —
            # keep it off this (already running) loop
            await asyncio.get_running_loop().run_in_executor(
                self.pool,
                lambda: ray_tpu_torch.init(address=self.cluster_address))
        self._server = await asyncio.start_server(self._handle_conn,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self):
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
        self.pool.shutdown(wait=False)


async def serve(address: str, host: str = "0.0.0.0", port: int = 10001):
    """Run a gateway forever (shared by __main__ and `cli gateway`)."""
    gw = ClientGateway(address, host, port)
    host, port = await gw.start()
    print(f"gateway listening on {host}:{port}", flush=True)
    while True:
        await asyncio.sleep(3600)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True, help="cluster GCS host:port")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10001)
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(args.address, args.host, args.port))


if __name__ == "__main__":
    main()
