"""Native (C++) components of ray_tpu_torch.

Currently: the shared-memory object store (objstore.cc — the host tier of
the object plane, reference: src/ray/object_manager/plasma/) and the
zero-staging TCP transfer plane (xfer.cc — reference:
src/ray/object_manager/object_manager.cc push/pull). Compiled on first use
from the sources beside this file, so a fresh checkout needs no separate
build step.

The library lands in ``build/native/`` at the repository root (listed in
``.gitignore``), never in the package directory. It is rebuilt when it is
missing or older than a source. Each build writes a file of its own and
renames it into place, so processes that start together (the GCS, the
nodelet, workers) never load a half-written library. A failed build raises
with the compiler's output; there is no fallback.
"""

import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
OBJSTORE_SO = os.path.join(BUILD_DIR, "libraytpu_objstore.so")
SOURCES = ("objstore.cc", "xfer.cc")


def ensure_built() -> str:
    """Compile the native library if missing or older than its sources."""
    srcs = [os.path.join(_HERE, s) for s in SOURCES]
    if (os.path.exists(OBJSTORE_SO)
            and os.path.getmtime(OBJSTORE_SO) >= max(
                os.path.getmtime(s) for s in srcs)):
        return OBJSTORE_SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{OBJSTORE_SO}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["make", "-s", "-C", _HERE, "all", f"OUT={tmp}"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if r.returncode != 0:
            raise RuntimeError(
                f"native store build failed (make exit {r.returncode}):\n"
                + r.stdout.decode(errors="replace"))
        os.replace(tmp, OBJSTORE_SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return OBJSTORE_SO
