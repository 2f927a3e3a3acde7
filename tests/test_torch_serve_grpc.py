"""Serve gRPC ingress: generic Predict contract end-to-end.

Reference test model: serve gRPC driver tests — deploy, call over a real
gRPC channel, assert results and error surfacing.

Port of tests/test_serve_grpc.py, aimed at ray_tpu_torch.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.grpc_proxy import (GrpcServeClient,
                                            shutdown_grpc, start_grpc)
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def test_grpc_predict_roundtrip(ray_start_regular):
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Adder:
        def __call__(self, x, y=0):
            return x + y

        def tenfold(self, x):
            return x * 10

    serve.run(Adder.bind())
    port = start_grpc()
    client = GrpcServeClient(f"127.0.0.1:{port}")
    try:
        assert client.predict("Adder", 2, y=3) == 5
        assert client.predict("Adder", 7, method="tenfold") == 70
        with pytest.raises(RuntimeError, match="TypeError"):
            client.predict("Adder", 1, 2, 3)   # bad signature surfaces
    finally:
        client.close()
        shutdown_grpc()
        serve.shutdown()
