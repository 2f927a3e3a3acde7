"""ray_tpu_torch.serve: model serving on actor replicas, over the port's
runtime. A copy of ``ray_tpu/serve`` (deployments, the controller, the
HTTP and gRPC proxies, handles, ``@serve.batch``, deployment graphs, model
multiplexing, the LLM router and disaggregated prefill/decode) with the
PyTorch ``LLMEngine`` and ``LLMServer`` of ``serve/llm.py`` behind it.

Reference: python/ray/serve/ — @serve.deployment + serve.run (api.py:242,414)
→ detached ServeController actor (controller.py:74) reconciling replica
actors (deployment_state.py:1097), client-side Router with
power-of-two-choices (router.py:262), @serve.batch dynamic batching
(batching.py:65), queue-depth autoscaling (autoscaling_policy.py).

    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Model.bind())
    ref = handle.remote(21)

Importing this package loads no torch: ``serve/llm.py`` (the engine and
``LLMServer``) is reached lazily, from ``build_llm_app`` or by its own
import, so the controller, proxy and router processes never import torch
or touch CUDA for their own code.
"""

from ray_tpu_torch.serve.api import (Application, Deployment, deployment,
                                     get_deployment_handle, run, shutdown,
                                     start, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.disagg import DisaggRouter
from ray_tpu_torch.serve.kv_transfer import (HandoffAdopter, HandoffExporter,
                                             PrefixDirectory)
from ray_tpu_torch.serve.graph import DAGDriverImpl, InputNode, build_app
from ray_tpu_torch.serve.grpc_proxy import (GrpcServeClient, shutdown_grpc,
                                            start_grpc)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.http_proxy import Request, Response
from ray_tpu_torch.serve.llm_deployment import SimLLMServer, build_llm_app
from ray_tpu_torch.serve.llm_router import LLMRouter
from ray_tpu_torch.serve.multiplex import (ModelRegistry,
                                           get_multiplexed_model_id,
                                           get_request_tenant, multiplexed)

__all__ = [
    "deployment", "run", "shutdown", "start", "status",
    "get_deployment_handle", "batch", "Deployment", "Application",
    "DeploymentHandle", "Request", "Response", "multiplexed",
    "get_multiplexed_model_id", "get_request_tenant", "ModelRegistry",
    "build_app", "InputNode", "DAGDriverImpl",
    "start_grpc", "shutdown_grpc", "GrpcServeClient",
    "LLMRouter", "SimLLMServer", "build_llm_app",
    "DisaggRouter", "PrefixDirectory", "HandoffExporter", "HandoffAdopter",
]
