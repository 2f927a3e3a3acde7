"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

``import ray_tpu`` fails on Python >= 3.11 (``RpcTimeout``'s duplicate
``TimeoutError`` base at ray_tpu/core/rpc.py:92), so the JAX reference is
loaded through stub parent packages: ``types.ModuleType`` objects with
``__path__`` set for ``ray_tpu``, ``ray_tpu.serve``, ``ray_tpu.util`` and
``ray_tpu.observability``, plus a no-op ``ray_tpu.util.metrics``. The
stubs live in ``sys.modules`` only inside ``jax_reference()``: on exit every
``ray_tpu*`` entry is put back as it was, because xdist's ``loadfile``
runs other test files in the same worker process and they must see the
real package. The loaded reference modules are kept between uses and
re-inserted on entry, so their lazy imports resolve to the same objects.

The tests in this file check that helper itself.
"""

from __future__ import annotations

import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
_STUB_PACKAGES = ("ray_tpu", "ray_tpu.serve", "ray_tpu.util",
                  "ray_tpu.observability")
_REFERENCE_MODULES = ("ray_tpu.models.llama", "ray_tpu.ops.paged_attention",
                      "ray_tpu.ops.flash_attention", "ray_tpu.serve.llm",
                      "ray_tpu.serve.paged_kv", "ray_tpu.parallel.train_step")
_loaded: dict = {}


def _is_ray_tpu(name: str) -> bool:
    return name == "ray_tpu" or name.startswith("ray_tpu.")


class _NoopInstrument:
    def __init__(self, *a, **k):
        pass

    def set_default_tags(self, tags):
        return self

    def observe(self, *a, **k):
        pass

    def inc(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass


def _install_stubs():
    for name in _STUB_PACKAGES:
        m = types.ModuleType(name)
        m.__path__ = [str(REPO / name.replace(".", "/"))]
        sys.modules[name] = m
    metrics = types.ModuleType("ray_tpu.util.metrics")
    metrics.Histogram = metrics.Counter = metrics.Gauge = _NoopInstrument
    sys.modules["ray_tpu.util.metrics"] = metrics


class _Reference(types.SimpleNamespace):
    """The JAX reference modules: llama, paged_attention, flash_attention,
    llm, paged_kv, train_step, mesh, sharding."""


@contextlib.contextmanager
def jax_reference():
    """Yield the JAX reference modules with their packages importable;
    restore every ``ray_tpu*`` entry of sys.modules on exit. Make every
    reference call inside the block (their lazy imports need it)."""
    saved = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    for k in saved:
        del sys.modules[k]
    try:
        if _loaded:
            sys.modules.update(_loaded)
        else:
            import importlib

            _install_stubs()
            for name in _REFERENCE_MODULES:
                importlib.import_module(name)
            _loaded.update({k: v for k, v in sys.modules.items()
                            if _is_ray_tpu(k)})
        yield _Reference(
            llama=sys.modules["ray_tpu.models.llama"],
            paged_attention=sys.modules["ray_tpu.ops.paged_attention"],
            # ray_tpu/ops/__init__.py rebinds the attribute to the function
            flash_attention=sys.modules["ray_tpu.ops.flash_attention"],
            llm=sys.modules["ray_tpu.serve.llm"],
            paged_kv=sys.modules["ray_tpu.serve.paged_kv"],
            train_step=sys.modules["ray_tpu.parallel.train_step"],
            mesh=sys.modules["ray_tpu.parallel.mesh"],
            sharding=sys.modules["ray_tpu.parallel.sharding"])
    finally:
        for k in [k for k in sys.modules if _is_ray_tpu(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def require_cuda():
    """Skip the calling test (marked ``cuda``) when there is no card. Called
    inside the test, never at import, so every xdist worker collects the
    same tests."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernel has no CPU or interpret mode")


def jax_tree_to_np(tree):
    """A JAX param pytree (nested dicts) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def to_np(x):
    """A JAX array or torch tensor as a float64/int numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.double()
        return x.numpy()
    return np.asarray(x)


def test_reference_stubs_are_removed_after_use():
    pytest.importorskip("jax")
    before = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    with jax_reference() as ref:
        assert ref.llama.PRESETS["tiny"].d_model == 64
        assert callable(ref.flash_attention._flash_fwd_loop)
    after = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    assert after == before


def test_reference_reentry_reuses_loaded_modules():
    pytest.importorskip("jax")
    with jax_reference() as a:
        first = a.llama
    with jax_reference() as b:
        assert b.llama is first
        assert sys.modules["ray_tpu.models.llama"] is first
