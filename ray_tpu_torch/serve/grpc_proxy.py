"""gRPC ingress proxy for serve.

Reference: the serve gRPC driver path (serve/drivers.py gRPCIngress +
src/ray/protobuf/serve.proto) — an alternative ingress speaking gRPC
instead of HTTP. Wire contract (generic, no codegen needed on either
side): service /ray_tpu_torch.serve.ServeAPI/Predict, request and response are
pickled python payloads:

    request  = pickle({"deployment": str, "method": str (default
                        __call__), "args": tuple, "kwargs": dict})
    response = pickle({"ok": True, "result": ...} |
                      {"ok": False, "error": str})

A typed .proto front-end can be layered on by any client; the generic
bytes contract keeps parity with the pickle-frame control plane
(ray_tpu_torch/protobuf/services.proto documents the same envelope decision).
"""

from __future__ import annotations

import pickle
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle

GRPC_PROXY_NAME = "_serve_grpc_proxy"
METHOD_PATH = "/ray_tpu_torch.serve.ServeAPI/Predict"


@ray_tpu_torch.remote
class GrpcProxy:
    """One gRPC server actor fronting all deployments (ref: per-node HTTP
    proxies in http_state.py; gRPC gets one until profiling says more)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        import grpc

        self._handles = {}

        proxy = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != METHOD_PATH:
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    proxy._predict,
                    request_deserializer=None,   # raw bytes through
                    response_serializer=None)

        self.server = grpc.server(ThreadPoolExecutor(max_workers=16))
        self.server.add_generic_rpc_handlers((_Handler(),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.server.start()

    def _handle(self, name: str) -> DeploymentHandle:
        if name not in self._handles:
            self._handles[name] = DeploymentHandle(name)
        return self._handles[name]

    def _predict(self, request: bytes, context) -> bytes:
        try:
            req = pickle.loads(request)
            h = self._handle(req["deployment"])
            method = req.get("method", "__call__")
            args = req.get("args", ())
            kwargs = req.get("kwargs", {})
            ref = h.remote(*args, **kwargs) if method == "__call__" \
                else h.method(method).remote(*args, **kwargs)
            result = ray_tpu_torch.get(ref, timeout=req.get("timeout", 60.0))
            return pickle.dumps({"ok": True, "result": result})
        except Exception as e:  # surfaced to the client, proxy stays up
            return pickle.dumps({"ok": False,
                                 "error": f"{type(e).__name__}: {e}"})

    def ready(self) -> int:
        return self.port

    def shutdown(self):
        self.server.stop(grace=0.5)
        return True


def start_grpc(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start (or find) the gRPC ingress; returns the bound port
    (ref: serve.start(grpc_options=...))."""
    try:
        proxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME, namespace="serve")
    except ValueError:
        try:
            proxy = GrpcProxy.options(
                name=GRPC_PROXY_NAME, namespace="serve",
                max_concurrency=64).remote(host, port)
        except ValueError:
            proxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME, namespace="serve")
    return ray_tpu_torch.get(proxy.ready.remote())


def shutdown_grpc():
    try:
        proxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME, namespace="serve")
    except ValueError:
        return
    try:
        ray_tpu_torch.get(proxy.shutdown.remote())
    finally:
        ray_tpu_torch.kill(proxy)


class GrpcServeClient:
    """Minimal typed client for the generic contract (what a
    cross-language client implements against METHOD_PATH)."""

    def __init__(self, address: str):
        import grpc

        self.channel = grpc.insecure_channel(address)
        self._call = self.channel.unary_unary(METHOD_PATH)

    def predict(self, deployment: str, *args, method: str = "__call__",
                timeout: Optional[float] = None, **kwargs):
        payload = pickle.dumps({"deployment": deployment, "method": method,
                                "args": args, "kwargs": kwargs,
                                **({"timeout": timeout}
                                   if timeout is not None else {})})
        out = pickle.loads(self._call(payload, timeout=timeout))
        if not out["ok"]:
            raise RuntimeError(out["error"])
        return out["result"]

    def close(self):
        self.channel.close()
