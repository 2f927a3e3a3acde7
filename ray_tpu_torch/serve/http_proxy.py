"""HTTP ingress proxy.

Reference: python/ray/serve/_private/http_proxy.py:11 — per-node HTTPProxy
actors (uvicorn/starlette ASGI) that resolve a route table pushed from the
controller and forward requests to replicas via the router. Here the proxy
is an actor running a stdlib ThreadingHTTPServer (no ASGI dependency); each
handler thread forwards through a DeploymentHandle (P2C router) and maps
Python results to HTTP responses.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import ray_tpu_torch

logger = logging.getLogger("ray_tpu_torch.serve.http_proxy")

PROXY_NAME = "_serve_http_proxy"
_NAMESPACE = "serve"


class Request:
    """What an ingress deployment receives for an HTTP call (the moral
    equivalent of the reference's starlette.requests.Request)."""

    def __init__(self, method: str, path: str, query: Dict[str, list],
                 headers: Dict[str, str], body: bytes,
                 route_prefix: str = "/"):
        self.method = method
        self.path = path
        self.query_params = {k: v[0] if len(v) == 1 else v
                             for k, v in query.items()}
        self.headers = headers
        self.body = body
        self.route_prefix = route_prefix

    def json(self) -> Any:
        return json.loads(self.body.decode() or "null")

    def text(self) -> str:
        return self.body.decode()

    def __repr__(self):
        return f"Request({self.method} {self.path})"


class Response:
    """Explicit response wrapper (status/headers control)."""

    def __init__(self, content: Any = "", status_code: int = 200,
                 media_type: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        self.content = content
        self.status_code = status_code
        self.media_type = media_type
        self.headers = headers or {}


def _encode_result(result: Any) -> tuple:
    """(status, content_type, payload_bytes)"""
    if isinstance(result, Response):
        status = result.status_code
        body = result.content
        ctype = result.media_type
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
            ctype = ctype or "application/json"
        elif isinstance(body, str):
            body = body.encode()
            ctype = ctype or "text/plain; charset=utf-8"
        elif not isinstance(body, (bytes, bytearray)):
            body = str(body).encode()
            ctype = ctype or "text/plain; charset=utf-8"
        return status, ctype, bytes(body), result.headers
    if isinstance(result, (dict, list)) or result is None:
        return 200, "application/json", json.dumps(result).encode(), {}
    if isinstance(result, (bytes, bytearray)):
        return 200, "application/octet-stream", bytes(result), {}
    if isinstance(result, str):
        return 200, "text/plain; charset=utf-8", result.encode(), {}
    return 200, "text/plain; charset=utf-8", str(result).encode(), {}


@ray_tpu_torch.remote
class HTTPProxy:
    """One per node in the reference (http_state.py); here one per cluster,
    started by serve.start()."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 controller_name: str = "_serve_controller"):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        self._controller_name = controller_name
        self._routes: Dict[str, str] = {}   # route_prefix -> deployment
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes_lock = threading.Lock()
        self._refresh_routes()
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _dispatch(self):
                try:
                    out = proxy._handle(self)
                    if out[0] == "stream":
                        self._stream_out(out[1], out[2])
                        return
                    status, ctype, body, extra = out
                except Exception as e:  # noqa: BLE001 — proxy must not die
                    import traceback

                    body = json.dumps({"error": str(e),
                                       "traceback": traceback.format_exc()
                                       }).encode()
                    status, ctype, extra = 500, "application/json", {}
                self.send_response(status)
                self.send_header("Content-Type",
                                 ctype or "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _stream_out(self, ctype, chunks):
                """Chunked transfer encoding over the handler socket: each
                stream item flushes as its own chunk, so clients see
                tokens as they are generated. The first chunk is pulled
                BEFORE the headers commit, so an immediately-failing
                stream still gets a clean 500; later failures must not
                write a status line into the chunk framing — they emit an
                error chunk and terminate the stream instead."""
                it = iter(chunks)
                try:
                    first = next(it, None)
                except Exception:   # noqa: BLE001 — headers not sent yet
                    raise           # -> _dispatch's 500 path
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    try:
                        for data in itertools.chain(
                                [] if first is None else [first], it):
                            if not data:
                                continue
                            self.wfile.write(
                                f"{len(data):x}\r\n".encode() + data
                                + b"\r\n")
                            self.wfile.flush()
                    except Exception as e:  # noqa: BLE001 mid-stream error
                        err = json.dumps({"error": str(e)}).encode() + b"\n"
                        self.wfile.write(
                            f"{len(err):x}\r\n".encode() + err + b"\r\n")
                        self.close_connection = True   # stream cut short
                    self.wfile.write(b"0\r\n\r\n")
                except BrokenPipeError:
                    pass   # client went away; generator cleanup in chunks()

            do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _dispatch

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._refresher = threading.Thread(target=self._refresh_loop,
                                           daemon=True)
        self._refresher.start()

    # ---- routing table (ref: _private/long_poll.py push of route table) ----

    def _refresh_routes(self):
        try:
            controller = ray_tpu_torch.get_actor(self._controller_name,
                                                 namespace=_NAMESPACE)
            routes = ray_tpu_torch.get(controller.get_routes.remote(), timeout=5)
        except Exception:
            return
        with self._routes_lock:
            self._routes = routes

    def _refresh_loop(self):
        """Long-poll push: one pending controller call returns the new
        route table the moment it changes (ref: long_poll.py:187); the
        except path degrades to a 1 s retry while the controller is
        down/restarting."""
        gen = 0
        while True:
            try:
                controller = ray_tpu_torch.get_actor(self._controller_name,
                                                     namespace=_NAMESPACE)
                res = ray_tpu_torch.get(
                    controller.long_poll.remote("routes", gen, 10.0),
                    timeout=30)
                changed = res["gen"] != gen
                gen = res["gen"]
                if changed and res["value"] is not None:
                    with self._routes_lock:
                        self._routes = res["value"]
            except Exception:
                time.sleep(1.0)

    def _resolve(self, path: str) -> tuple:
        """Longest-prefix match over route table."""
        with self._routes_lock:
            routes = dict(self._routes)
        best = None
        for prefix, name in routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                    norm + "/") or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, name)
        return best

    # ---- request path (hot loop: parse → route → handle → encode) ----

    def _handle(self, h) -> tuple:
        parsed = urlparse(h.path)
        match = self._resolve(parsed.path)
        if match is None:
            # route table may be stale (deploy raced the refresh loop)
            self._refresh_routes()
            match = self._resolve(parsed.path)
        if match is None:
            return (404, "application/json",
                    json.dumps({"error": f"no route for {parsed.path}"
                                }).encode(), {})
        prefix, deployment = match
        length = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(length) if length else b""
        req = Request(h.command, parsed.path, parse_qs(parsed.query),
                      dict(h.headers.items()), body, prefix)
        handle = self._handles.get(deployment)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(deployment)
            self._handles[deployment] = handle
        if req.query_params.get("stream") == "1" or \
                "text/event-stream" in h.headers.get("Accept", ""):
            # Streaming contract: the deployment defines `stream_request`
            # (sync/async generator); items flush to the client as HTTP
            # chunks in yield order (ref: serve response streaming over
            # obj-ref generators). Clients accepting text/event-stream
            # get SSE framing (data: <json>\n\n per item).
            sse = "text/event-stream" in h.headers.get("Accept", "")
            gen = handle.options(stream=True).method(
                "stream_request").remote(req)
            # Pull the FIRST item here, before any status line commits:
            # a shed stream's typed first frame ({"status": 429, ...},
            # the LLMQueueFull contract) becomes a real 429 +
            # Retry-After instead of a 200 stream the client must parse.
            it = iter(gen)
            first = None
            try:
                ref = next(it, None)
                first = ray_tpu_torch.get(ref) if ref is not None else None
            except StopIteration:
                pass
            if isinstance(first, dict) and first.get("status") == 429:
                retry = first.get("retry_after_s", 1.0)
                return (429, "application/json",
                        json.dumps(first).encode(),
                        {"Retry-After": f"{retry:g}"})
            ctype = ("text/event-stream" if sse
                     else "text/plain; charset=utf-8")
            return ("stream", ctype, self._iter_chunks(it, first, sse))
        # Retry-on-dead-replica (ref: router.py assign-and-retry): a
        # request that raced a replica death re-routes through the handle
        # (whose router gets the replacement set pushed) instead of
        # surfacing a 500. The owner runtime stamps the error with whether
        # the call frame ever reached the replica's worker: an UNSENT
        # request (dispatched=False) is safe to re-dispatch for ANY verb —
        # it provably never started, so no side effects can duplicate
        # (ref: router.py re-dispatches queued-but-unsent requests on
        # replica death regardless of method). Only idempotent methods
        # (GET/HEAD) may additionally retry after an IN-FLIGHT death,
        # where "died mid-write" cannot be ruled out.
        last_err = None
        idempotent = h.command in ("GET", "HEAD")
        for attempt in range(3):
            t0 = time.time()
            ref = handle.remote(req)
            try:
                result = ray_tpu_torch.get(ref, timeout=60)
                return _encode_result(result)
            except (ray_tpu_torch.exceptions.ActorDiedError,
                    ray_tpu_torch.exceptions.ActorUnavailableError) as e:
                last_err = e
                # each retry's wait, so a slow re-route shows where it sat
                logger.warning("%s %s: attempt %d failed after %.3f s "
                               "(%s: %s)", h.command, h.path, attempt + 1,
                               time.time() - t0, type(e).__name__, e)
                router = handle._get_router()
                # evict the EXACT dead replica locally — the controller's
                # next health probe (and pushed update) may be up to a
                # second away, and re-picking from a stale set would burn
                # every retry on the same corpse. Evict even when about to
                # surface the error, so later requests don't re-pick it.
                router.evict(getattr(e, "actor_id", None))
                if not router._replicas:
                    router._refresh(force=True)
                if not idempotent and getattr(e, "dispatched", True):
                    raise   # may have executed: never duplicate a POST
        raise last_err

    @staticmethod
    def _iter_chunks(gen, first=None, sse=False):
        def encode(item):
            if isinstance(item, (bytes, bytearray)):
                data = bytes(item)
            elif isinstance(item, str):
                data = item.encode()
            else:
                data = json.dumps(item).encode()
            if sse:
                return b"data: " + data + b"\n\n"
            if not isinstance(item, (bytes, bytearray, str)):
                data += b"\n"
            return data

        if first is not None:
            yield encode(first)
        for ref in gen:
            yield encode(ray_tpu_torch.get(ref))

    def ready(self) -> int:
        return self.port

    def shutdown(self):
        self._server.shutdown()
        return True
