"""ray_tpu_torch: the PyTorch + CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The port follows ``ray_tpu``'s layout file for file
(``ray_tpu_torch/models/llama.py`` ports ``ray_tpu/models/llama.py``), so
each module names the reference module it answers to. Every Pallas kernel
on a ported path becomes a CUDA C++ kernel under ``csrc/``, built for
``sm_90a`` on first use (``ops/_build.py``) and bound with ``ctypes``.

Importing this package is import-light: it starts no runtime, builds no
kernel and touches no device. Entry points take ``device=None`` (meaning
``"cuda"``) and raise when CUDA is absent unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

import sys

__all__ = ["ops", "models", "serve", "parallel", "resolve_device",
           "is_dtensor"]


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
