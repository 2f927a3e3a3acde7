"""Remote checkpoint/artifact storage over fsspec URIs.

A copy of ``ray_tpu/train/storage.py`` (it touches no JAX); only the local
staging root is the port's own (``~/.cache/ray_tpu_torch/staging``).

Reference: python/ray/air/_internal/remote_storage.py (get_fs_and_path,
upload_to_uri, download_from_uri, list_at_uri, delete_at_uri over pyarrow
fs). Here the implementation rides fsspec instead of pyarrow.fs — fsspec is
in the image, covers file:// and memory:// natively, and loads gs://"s3://
drivers (gcsfs/s3fs) lazily when installed. memory:// makes the cloud path
testable without cloud credentials.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple


def is_uri(path: Optional[str]) -> bool:
    """True for scheme://... paths (but plain local paths and Windows
    drive letters are not URIs)."""
    if not path:
        return False
    idx = path.find("://")
    return idx > 1  # at least 2 scheme chars; excludes C:/ style


def get_fs_and_path(uri: str) -> Tuple["object", str]:
    """fsspec filesystem + in-fs path for a URI.

    ref: remote_storage.py get_fs_and_path — same contract, fsspec engine.
    Raises a helpful error when a cloud driver (gcsfs/s3fs/...) is not
    installed in the image.
    """
    import fsspec

    scheme, _, rest = uri.partition("://")
    try:
        fs = fsspec.filesystem(scheme)
    except (ImportError, ValueError) as e:
        raise RuntimeError(
            f"no fsspec driver for {scheme}:// ({e}); install the driver "
            f"(e.g. gcsfs for gs://, s3fs for s3://) or use file:// / "
            f"memory:// / a plain local path") from e
    if scheme == "file":
        return fs, rest if rest.startswith("/") else "/" + rest
    return fs, rest


def upload_to_uri(local_dir: str, uri: str) -> None:
    """Recursively copy a local directory's contents to the URI."""
    fs, path = get_fs_and_path(uri)
    fs.makedirs(path, exist_ok=True)
    # trailing slashes select contents-into-dir semantics in fsspec
    fs.put(local_dir.rstrip("/") + "/", path.rstrip("/") + "/",
           recursive=True)


def download_from_uri(uri: str, local_dir: str) -> str:
    """Recursively copy the URI directory into local_dir; returns local_dir.

    The download lands in a temp sibling and renames into place, so a
    crash mid-download never leaves a half-populated local_dir (which a
    resuming CheckpointManager could mistake for a real checkpoint).
    """
    import shutil

    fs, path = get_fs_and_path(uri)
    local_dir = local_dir.rstrip("/")
    # Temp name starts with "." so a crashed download can never be
    # mistaken for a real checkpoint_NNNNNN dir by a resuming manager.
    parent = os.path.dirname(local_dir) or "."
    tmp = os.path.join(parent,
                       f".dl-{os.path.basename(local_dir)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    fs.get(path.rstrip("/") + "/", tmp + "/", recursive=True)
    shutil.rmtree(local_dir, ignore_errors=True)
    os.rename(tmp, local_dir)
    return local_dir


def list_at_uri(uri: str) -> List[str]:
    """Immediate child names at the URI (empty when absent)."""
    fs, path = get_fs_and_path(uri)
    if not fs.exists(path):
        return []
    out = []
    for entry in fs.ls(path, detail=False):
        name = entry.rstrip("/").rsplit("/", 1)[-1]
        if name:
            out.append(name)
    return sorted(out)


def exists_at_uri(uri: str) -> bool:
    fs, path = get_fs_and_path(uri)
    return bool(fs.exists(path))


def touch_at_uri(uri: str) -> None:
    """Create an empty file at the URI (commit markers)."""
    fs, path = get_fs_and_path(uri)
    parent = path.rstrip("/").rsplit("/", 1)[0]
    if parent:
        fs.makedirs(parent, exist_ok=True)
    fs.pipe_file(path, b"")


def delete_at_uri(uri: str) -> None:
    fs, path = get_fs_and_path(uri)
    if fs.exists(path):
        fs.rm(path, recursive=True)


def join_uri(uri: str, *parts: str) -> str:
    return uri.rstrip("/") + "/" + "/".join(p.strip("/") for p in parts)


def local_staging_dir(uri: str) -> str:
    """Deterministic local staging directory for a remote URI (so a
    restarted process re-finds its own staging)."""
    import hashlib

    h = hashlib.sha1(uri.encode()).hexdigest()[:12]
    d = os.path.join(os.path.expanduser("~/.cache/ray_tpu_torch/staging"), h)
    os.makedirs(d, exist_ok=True)
    return d
