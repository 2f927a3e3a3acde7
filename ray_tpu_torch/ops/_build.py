"""Build the port's CUDA kernels from ``ray_tpu_torch/csrc`` on first use.

Route: ``nvcc`` by hand into one shared library per source, with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds rather than minutes). Each library is keyed by a hash of its
source, of the shared headers and of the flags, and lands under
``build/kernels/`` at the repository root (listed in ``.gitignore``).
Nothing is downloaded or prebuilt: the first launch of a kernel builds it,
and ``build()`` builds several sources at once, one ``nvcc`` each, all
started together.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check()`` turns a non-zero code into an exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --split-compile=0: the compiler optimizes a source's parts on every core
# at once (the backward's source builds in ~19 s against ~35 on the card's
# host)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")
KERNEL_SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or ``nvcc`` on PATH. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from ray_tpu_torch/csrc with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source whose library is missing, all nvcc
    processes in parallel. Returns {name: seconds} for the ones built
    (the compiler's ``-Xptxas -v`` report goes to ``<name>.log`` beside
    the library). Raises with the compiler's output on failure."""
    names = list(names or KERNEL_SOURCES)
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    try:
        for n, p in todo:
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs.append((n, p, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        took, failed = {}, []
        for n, p, tmp, t0, proc in procs:
            out, _ = proc.communicate()
            took[n] = time.perf_counter() - t0
            text = out.decode(errors="replace")
            (BUILD_DIR / f"{n}.log").write_text(text)
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n"
                              f"{text}")
                continue
            os.replace(tmp, p)
    finally:
        for _, _, tmp, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib.rt_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def reject_dtensor(what: str, *tensors) -> None:
    """A kernel reads its inputs through ``data_ptr()``; a DTensor's storage
    is only this rank's shard, so a wrapper that took one would compute on
    part of the tensor as if it were the whole. Raise instead, on any
    device: the caller passes local tensors (``DTensor.to_local()``, or
    inside ``local_map``)."""
    from ray_tpu_torch import is_dtensor

    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{what}: got a DTensor; kernel wrappers take local tensors "
            f"(pass DTensor.to_local(), or call inside local_map)")
