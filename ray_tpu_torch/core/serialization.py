"""Object serialization: cloudpickle + pickle5 out-of-band buffers.

Reference: python/ray/_private/serialization.py:108 (SerializationContext) —
cloudpickle metadata with pickle-protocol-5 out-of-band buffers enabling
zero-copy numpy/Arrow reads straight from the plasma segment. We reproduce
that layout and add torch.Tensor awareness (port of ray_tpu/core/
serialization.py, where jax.Array takes this place): a CUDA tensor is
pulled to the host on serialize — the device tier keeps device tensors
per-process, the shared store holds only host bytes.

Wire layout of a stored object:
    [u32 n_buffers][u64 meta_len][meta (cloudpickle, with PickleBuffer
    placeholders)] then for each buffer: pad-to-64 [u64 len][payload]
Deserialization maps each payload as a zero-copy memoryview into the shm
segment, so numpy arrays returned by `get` alias store memory (read-only).

Tensors: a tensor's bytes travel out of band as one ``uint8`` buffer, with
its dtype and shape in the meta (a numpy view cannot carry ``bfloat16``,
and torch's own pickle would put the bytes in-band). It deserializes as a
CPU tensor of the same dtype and shape: placement is never implicit across
processes, as a jax.Array deserializes as numpy in the reference.

Read-only rule: torch has no read-only tensor, so a tensor that aliased the
store's read-only mapping could corrupt the object or fault on an in-place
write. A tensor is therefore CLONED ONCE at ``get`` (one host copy out of
the segment) and the caller owns it. Numpy values keep their zero-copy,
read-only path unchanged.

Tensors are detected without importing torch (``type(x).__module__``, as
the reference detects jax arrays), so daemons and CPU-only workers that
never see a tensor never load torch.
"""

from __future__ import annotations

import pickle
import struct
import threading
from typing import Any, List, Tuple

import cloudpickle
import numpy as np

_ALIGN = 64

# Unpickling imports the module that each class and function it names lives
# in. Two threads of one process that import one package at once (one runs
# its ``__init__``, the other enters a submodule directly) can each hold a
# module lock the other needs, and CPython breaks that cycle by handing one
# of them a partially initialised module: ImportError. A worker starts
# several actors' lanes at once, so the unpickles that start a task or an
# actor (its function or class, its inline arguments) hold this lock, and
# their imports run one at a time. Reentrant: an embedded function is
# unpickled inside the unpickle of its value.
IMPORT_LOCK = threading.RLock()
_HDR = struct.Struct("<IQ")
_LEN = struct.Struct("<Q")


def _is_torch_tensor(x) -> bool:
    mod = type(x).__module__
    if not (mod == "torch" or mod.startswith("torch.")):
        return False
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _tensor_bytes(t) -> Tuple[str, tuple, np.ndarray]:
    """(dtype name, shape, the bytes as a uint8 numpy array) of a dense
    tensor, device -> host when it lives on a card."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return str(t.dtype).rsplit(".", 1)[-1], tuple(t.shape), raw


def _rebuild_tensor(dtype: str, shape: tuple, raw) -> Any:
    """A CPU tensor that owns its bytes (the read-only rule above)."""
    import torch

    data = np.frombuffer(raw, dtype=np.uint8)
    out = torch.empty(data.size, dtype=torch.uint8)
    out.numpy()[:] = data
    return out.view(getattr(torch, dtype)).reshape(shape)


def _pre_dump(obj: Any) -> Any:
    return obj


def serialize(obj: Any) -> Tuple[bytes, List[memoryview]]:
    """Returns (meta, out_of_band_buffers)."""
    buffers: List[pickle.PickleBuffer] = []

    def buffer_cb(buf: pickle.PickleBuffer) -> bool:
        buffers.append(buf)
        return False  # serialize out-of-band

    import copyreg

    # cloudpickle honours dispatch via the Pickler subclass; simplest robust
    # route: map tensors to (dtype, shape, uint8 bytes) via a custom pickler.
    class _P(cloudpickle.Pickler):
        def persistent_id(self, o):
            return None

        def reducer_override(self, o):
            if _is_torch_tensor(o):
                return (_rebuild_tensor, _tensor_bytes(o))
            import types

            if isinstance(o, (types.FunctionType, type)):
                from ray_tpu_torch.core.runtime import (_dumps_function,
                                                  _module_is_installed)
                import inspect

                mod = inspect.getmodule(o)
                if (mod is not None and mod.__name__ != "__main__"
                        and not _module_is_installed(mod)):
                    # functions/classes from user scripts the executing
                    # worker cannot import: embed by value
                    return (cloudpickle.loads, (_dumps_function(o),))
            # chain to cloudpickle's own reducer_override (it handles
            # __main__ functions/classes by value) — returning
            # NotImplemented here would bypass it entirely
            return super().reducer_override(o)

    import io

    f = io.BytesIO()
    p = _P(f, protocol=5, buffer_callback=buffer_cb)
    p.dump(obj)
    meta = f.getvalue()
    return meta, [b.raw() for b in buffers]


def serialized_size(meta: bytes, buffers: List[memoryview]) -> int:
    n = _HDR.size + len(meta)
    for b in buffers:
        n = _aligned(n) + _LEN.size + b.nbytes
    return n


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def write_to(view: memoryview, meta: bytes, buffers: List[memoryview]) -> int:
    """Writes the wire layout into `view`; returns bytes written."""
    _HDR.pack_into(view, 0, len(buffers), len(meta))
    off = _HDR.size
    view[off:off + len(meta)] = meta
    off += len(meta)
    for b in buffers:
        off = _aligned(off)
        _LEN.pack_into(view, off, b.nbytes)
        off += _LEN.size
        view[off:off + b.nbytes] = b.cast("B")
        off += b.nbytes
    return off


def pack(obj: Any) -> bytes:
    meta, bufs = serialize(obj)
    out = bytearray(serialized_size(meta, bufs))
    write_to(memoryview(out), meta, bufs)
    return bytes(out)


def read_from(view: memoryview) -> Any:
    """Zero-copy deserialize from a stored object's memory."""
    n_buffers, meta_len = _HDR.unpack_from(view, 0)
    off = _HDR.size
    meta = view[off:off + meta_len]
    off += meta_len
    bufs = []
    for _ in range(n_buffers):
        off = _aligned(off)
        (blen,) = _LEN.unpack_from(view, off)
        off += _LEN.size
        bufs.append(view[off:off + blen])
        off += blen
    return pickle.loads(meta, buffers=bufs)


def unpack(data: bytes) -> Any:
    return read_from(memoryview(data))


# --- exception transport ----------------------------------------------------


class SerializedException:
    """Wrapper so exceptions raised in workers re-raise at the caller.

    Reference: python/ray/exceptions.py RayTaskError — the remote traceback
    string travels with the exception and is appended to the local one.
    """

    def __init__(self, exc: BaseException, tb_str: str, wrap: bool = True):
        """wrap=True: user-code exception, re-raised wrapped in TaskError with
        the remote traceback. wrap=False: framework/system exception
        (ActorDiedError, WorkerCrashedError, ...) re-raised as itself."""
        try:
            self.payload = pack(exc)
            self.unpicklable = False
        except Exception:
            self.payload = pack(RuntimeError(f"{type(exc).__name__}: {exc}"))
            self.unpicklable = True
        self.tb_str = tb_str
        self.wrap = wrap

    def to_exception(self) -> BaseException:
        from ray_tpu_torch.core.status import TaskError

        try:
            cause = unpack(self.payload)
        except Exception as e:  # cause class not importable at caller
            cause = RuntimeError(f"(undeserializable task error: {e})")
        if not self.wrap:
            return cause
        return TaskError(cause, self.tb_str)
