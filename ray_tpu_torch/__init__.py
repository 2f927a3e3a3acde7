"""ray_tpu_torch: the PyTorch + CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The port follows ``ray_tpu``'s layout file for file
(``ray_tpu_torch/models/llama.py`` ports ``ray_tpu/models/llama.py``), so
each module names the reference module it answers to. Every Pallas kernel
on a ported path becomes a CUDA C++ kernel under ``csrc/``, built for
``sm_90a`` on first use (``ops/_build.py``) and bound with ``ctypes``.

The runtime (tasks, actors, objects over a GCS, a nodelet per node and
a shared-memory store: ``core/``, ``native/``, ``observability/``,
``util/``, ``dag/``, ``collective/``) is a copy of ``ray_tpu``'s with
``torch.Tensor`` in place of ``jax.Array`` and a "GPU" resource in place
of "TPU". Its public API (``init``, ``remote``, ``get``, ``put``, ...) lives
in ``api.py`` and is reached here lazily.

Importing this package is import-light: it starts no runtime, builds no
kernel, touches no device and loads neither torch nor the runtime (the
API names and the subpackages load on first use, PEP 562). Entry points
take ``device=None`` (meaning ``"cuda"``) and raise when CUDA is absent
unless the caller passes ``device="cpu"``, where every kernel wrapper
takes its plain PyTorch version.
"""

import importlib
import sys

_SUBMODULES = frozenset((
    "api", "ops", "models", "serve", "parallel", "core", "native",
    "protobuf", "util", "observability", "dag", "collective", "dashboard",
    "devtools", "runtime_env", "cluster_utils", "train", "data", "rl",
    "tune", "autoscaler", "job", "workflow", "client"))
_API = ("init", "shutdown", "is_initialized", "remote", "put", "get",
        "wait", "kill", "cancel", "get_actor", "method",
        "get_runtime_context", "nodes", "cluster_resources",
        "available_resources", "timeline", "stack", "internal_stats",
        "ObjectRef", "ObjectRefGenerator", "ActorHandle", "exceptions",
        "__version__")

__all__ = ["ops", "models", "serve", "parallel", "train", "data", "rl",
           "tune", "autoscaler", "job", "workflow", "client",
           "resolve_device",
           "is_dtensor", *_API]


def __getattr__(name):
    """Load a subpackage, or a name of the runtime API (``api.py``), on
    first use. Any other name of ``api``'s namespace resolves too, as it
    does at ``ray_tpu``'s root (``Config``, ``ActorClass``, ``_rt``, the
    live ``_session``); nothing is cached here, so module state that
    ``api`` rebinds reads current."""
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name.startswith("__") and name != "__version__":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    api = importlib.import_module(f"{__name__}.api")
    try:
        return getattr(api, name)
    except AttributeError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None


def resolve_device(device=None):
    """``None`` means CUDA. Without CUDA, only an explicit ``"cpu"`` runs
    (the plain versions of the kernels); there is no silent fallback."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    return dev


def is_dtensor(x) -> bool:
    """Whether x is a ``torch.distributed.tensor.DTensor`` (a sharded
    param), without importing that module: no DTensor exists until
    something has imported it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)
