"""Thin remote-driver client (Ray Client equivalent).

Port of ray_tpu/client.py, for the port's gateway (the wire is the same).
Reference: python/ray/util/client/ (ARCHITECTURE.md, worker.py) — the
client mirrors the core API; every call forwards to a server-side driver
that owns objects/actors. Here the transport is the gateway's JSON frame
protocol (ray_tpu_torch/client_gateway.py) instead of gRPC, and arbitrary
Python functions/objects ride the __pickle__ marker.

    from ray_tpu_torch import client
    c = client.connect("gw-host:10001")
    ref = c.put(41)
    out = c.get(c.task(lambda x: x + 1, ref))
    c.disconnect()
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

_LEN = struct.Struct("<I")


class ClientObjectRef:
    """A handle to an object owned by the gateway driver."""

    __slots__ = ("hex", "_client")

    def __init__(self, hex_id: str, client: "GatewayClient"):
        self.hex = hex_id
        self._client = client

    def __repr__(self):
        return f"ClientObjectRef({self.hex[:16]})"

    def __del__(self):
        c = self._client
        if c is not None and not c._closed:
            c._pending_release.append(self.hex)


class ClientActorHandle:
    __slots__ = ("hex", "_client")

    def __init__(self, hex_id: str, client: "GatewayClient"):
        self.hex = hex_id
        self._client = client

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, num_returns=1, **kwargs):
            return self._client.actor_call(self, method, *args,
                                           num_returns=num_returns, **kwargs)
        return call


class ClientStream:
    """Iterator over a server-side streaming-generator call: each
    __next__ pulls one yielded item over the wire (the gateway holds the
    ObjectRefGenerator; values arrive already materialized)."""

    def __init__(self, stream_id: str, client: "GatewayClient",
                 timeout: float = 60.0):
        self.stream_id = stream_id
        self._client = client
        self._timeout = timeout
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        r = self._client.call_raw("stream_next", stream=self.stream_id,
                                  timeout=self._timeout, pickle_ok=True)
        if r.get("done"):
            self._done = True
            raise StopIteration
        return self._client._dec(r["value"])

    def close(self):
        if not self._done:
            self._done = True
            try:
                self._client.call_raw("stream_close", stream=self.stream_id)
            except Exception:
                pass


class ClientPlacementGroup:
    """Client-side placement group (ref: Ray Client proxies
    util.placement_group). Pass as opts={"placement_group": pg.hex} — or
    use the GatewayClient helpers."""

    __slots__ = ("hex", "_client")

    def __init__(self, hex_id: str, client: "GatewayClient"):
        self.hex = hex_id
        self._client = client

    def ready(self, timeout: float = 30.0) -> bool:
        return self._client.call_raw("pg_ready", pg=self.hex,
                                     timeout=timeout)["ready"]

    def table(self):
        return self._client.call_raw("pg_table", pg=self.hex)["table"]


def _pickled(obj) -> dict:
    import cloudpickle

    return {"__pickle__": base64.b64encode(cloudpickle.dumps(obj)).decode()}


class GatewayClient:
    def __init__(self, address: Union[str, Tuple[str, int]],
                 timeout: float = 30.0):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host, int(port))
        self.address = address
        self._sock = socket.create_connection(address, timeout=timeout)
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        self._ids = 0
        self._closed = False
        self._pending_release: List[str] = []
        self.call_raw("ping")

    # ------------------------------------------------------------- transport

    def call_raw(self, rpc_method: str, **params) -> dict:
        with self._lock:
            self._ids += 1
            req = json.dumps({"id": self._ids, "method": rpc_method,
                              "params": params}).encode()
            self._sock.sendall(_LEN.pack(len(req)) + req)
            hdr = self._recvn(4)
            (n,) = _LEN.unpack(hdr)
            resp = json.loads(self._recvn(n))
        if not resp.get("ok"):
            raise RuntimeError(f"gateway error: {resp.get('error')}")
        return resp["result"]

    def _recvn(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("gateway connection closed")
            buf += chunk
        return buf

    def _flush_releases(self):
        if self._pending_release:
            refs, self._pending_release = self._pending_release, []
            try:
                self.call_raw("release", refs=refs)
            except Exception:
                pass

    # ------------------------------------------------------------------- api

    def _enc(self, v):
        # containers recurse so ClientObjectRefs nested in dict/list/tuple
        # args become __ref__ markers (a socket-holding ref must never hit
        # the pickler); non-container leaves ship pickled
        if isinstance(v, ClientObjectRef):
            return {"__ref__": v.hex}
        if isinstance(v, dict):
            return {str(k): self._enc(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return {"__tuple__": [self._enc(x) for x in v]}
        if isinstance(v, list):
            return [self._enc(x) for x in v]
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, bytes):
            return {"__bytes__": base64.b64encode(v).decode()}
        return _pickled(v)

    def _dec(self, v):
        if isinstance(v, dict):
            if set(v) == {"__ref__"}:
                return ClientObjectRef(v["__ref__"], self)
            if set(v) == {"__pickle__"}:
                import cloudpickle

                return cloudpickle.loads(base64.b64decode(v["__pickle__"]))
            if set(v) == {"__bytes__"}:
                return base64.b64decode(v["__bytes__"])
            if set(v) == {"__tuple__"}:
                return tuple(self._dec(x) for x in v["__tuple__"])
            return {k: self._dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [self._dec(x) for x in v]
        return v

    def put(self, value) -> ClientObjectRef:
        self._flush_releases()
        r = self.call_raw("put", value=self._enc(value))
        return ClientObjectRef(r["ref"], self)

    def get(self, refs, timeout: float = 60.0):
        self._flush_releases()
        one = not isinstance(refs, list)
        if one:
            refs = [refs]
        r = self.call_raw("get", refs=[x.hex for x in refs], timeout=timeout,
                          pickle_ok=True)
        vals = [self._dec(v) for v in r["values"]]
        return vals[0] if one else vals

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None):
        r = self.call_raw("wait", refs=[x.hex for x in refs],
                          num_returns=num_returns, timeout=timeout)
        by_hex = {x.hex: x for x in refs}
        return ([by_hex[h] for h in r["ready"]],
                [by_hex[h] for h in r["pending"]])

    def _norm_opts(self, opts):
        if not opts:
            return {}
        o = dict(opts)
        if isinstance(o.get("placement_group"), ClientPlacementGroup):
            o["placement_group"] = o["placement_group"].hex
        return o

    def task(self, fn, *args, opts: Optional[dict] = None, **kwargs):
        """Run a function on the cluster; fn may be any picklable callable
        or a "module:function" path string."""
        self._flush_releases()
        params = dict(args=[self._enc(a) for a in args],
                      kwargs={k: self._enc(v) for k, v in kwargs.items()},
                      opts=self._norm_opts(opts))
        if isinstance(fn, str):
            r = self.call_raw("task", func=fn, **params)
        else:
            r = self.call_raw("task_pickled", func=_pickled(fn), **params)
        if "stream" in r:
            return ClientStream(r["stream"], self)
        refs = [ClientObjectRef(h, self) for h in r["refs"]]
        return refs[0] if len(refs) == 1 else refs

    def actor(self, cls, *args, opts: Optional[dict] = None, **kwargs):
        self._flush_releases()
        params = dict(args=[self._enc(a) for a in args],
                      kwargs={k: self._enc(v) for k, v in kwargs.items()},
                      opts=self._norm_opts(opts))
        if isinstance(cls, str):
            r = self.call_raw("actor_create", cls=cls, **params)
        else:
            r = self.call_raw("actor_create", pickled=_pickled(cls), **params)
        return ClientActorHandle(r["actor"], self)

    def actor_call(self, handle: ClientActorHandle, method: str, *args,
                   num_returns: int = 1, **kwargs):
        r = self.call_raw(
            "actor_call", actor=handle.hex, method=method,
            args=[self._enc(a) for a in args],
            kwargs={k: self._enc(v) for k, v in kwargs.items()},
            num_returns=num_returns)
        if "stream" in r:
            return ClientStream(r["stream"], self)
        refs = [ClientObjectRef(h, self) for h in r["refs"]]
        return refs[0] if len(refs) == 1 else refs

    def get_actor(self, name: str, namespace: str = "default"):
        r = self.call_raw("get_actor", name=name, namespace=namespace)
        return ClientActorHandle(r["actor"], self)

    def kill(self, handle: ClientActorHandle):
        self.call_raw("kill", actor=handle.hex)

    def placement_group(self, bundles: List[Dict[str, float]],
                        strategy: str = "PACK") -> ClientPlacementGroup:
        r = self.call_raw("pg_create", bundles=bundles, strategy=strategy)
        return ClientPlacementGroup(r["pg"], self)

    def remove_placement_group(self, pg: ClientPlacementGroup):
        self.call_raw("pg_remove", pg=pg.hex)

    def cluster_resources(self) -> Dict[str, float]:
        return self.call_raw("cluster_resources")

    def disconnect(self):
        self._flush_releases()
        self._closed = True
        try:
            self._sock.close()
        except Exception:
            pass


def connect(address: Union[str, Tuple[str, int]], **kw) -> GatewayClient:
    """ref: ray.init("ray://host:10001") — the remote-driver entry."""
    return GatewayClient(address, **kw)
