"""Runtime environments: per-task/actor env vars, working_dir, py_modules.

Reference: python/ray/runtime_env/runtime_env.py (spec + validation),
python/ray/_private/runtime_env/packaging.py (directory → content-addressed
zip in GCS KV, `get_uri_for_directory`/`upload_package_if_needed`), and the
per-node agent's URI cache (python/ray/_private/runtime_env/agent/).

TPU-first simplifications kept deliberate:
- Packages ride the GCS KV (ns="packages") like the reference's GCS-backed
  packaging; conda/pip/container plugins are out of scope for a
  single-image TPU fleet (the image is the environment) and are rejected
  with a clear error instead of silently ignored.
- Workers apply env specs at task boundaries (env_vars save/restore around
  execution; working_dir/py_modules installed idempotently into a
  session-scoped cache). The exception is `process_env_vars`: variables
  that must exist BEFORE the worker interpreter imports anything (e.g.
  JAX_PLATFORMS, XLA_FLAGS, LIBTPU_INIT_ARGS). Those key dedicated worker
  pools in the nodelet — the TPU-shaped slice of the reference's
  runtime-env-keyed pools (worker_pool.h:156).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import threading
import zipfile
from typing import Any, Dict, List, Optional

_SUPPORTED = {"env_vars", "process_env_vars", "working_dir", "py_modules",
              "config"}
_UNSUPPORTED = {"conda", "pip", "container", "image_uri", "java_jars"}

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_PACKAGE_BYTES = 256 * 1024 * 1024


def validate(env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """ref: RuntimeEnv.__init__ validation."""
    if not env:
        return {}
    bad = set(env) & _UNSUPPORTED
    if bad:
        raise ValueError(
            f"runtime_env fields {sorted(bad)} are not supported on the "
            "single-image TPU fleet (the machine image is the environment); "
            f"supported: {sorted(_SUPPORTED)}")
    unknown = set(env) - _SUPPORTED
    if unknown:
        raise ValueError(f"unknown runtime_env fields: {sorted(unknown)}")
    for field in ("env_vars", "process_env_vars"):
        ev = env.get(field, {})
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in ev.items()):
            raise TypeError(f"runtime_env.{field} must be Dict[str, str]")
    return dict(env)


def process_env(env: Optional[Dict[str, Any]]) -> Dict[str, str]:
    """Vars that must be set before worker start (keys the worker pool)."""
    return (env or {}).get("process_env_vars", {})


# --- packaging (driver side) -------------------------------------------------


def _zip_directory(path: str) -> bytes:
    buf = io.BytesIO()
    base = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(base):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for f in sorted(files):
                full = os.path.join(root, f)
                rel = os.path.relpath(full, base)
                z.write(full, rel)
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(
            f"packaged {path!r} is {len(data)} bytes "
            f"(limit {_MAX_PACKAGE_BYTES}); add excludes or trim the dir")
    return data


def uri_for_directory(path: str) -> str:
    """Content-addressed package URI (ref: get_uri_for_directory —
    hash of file paths + contents, so unchanged dirs re-use the cache)."""
    h = hashlib.sha1()
    base = os.path.abspath(path)
    for root, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
        for f in sorted(files):
            full = os.path.join(root, f)
            h.update(os.path.relpath(full, base).encode())
            with open(full, "rb") as fh:
                h.update(fh.read())
    return f"gcs://pkg_{h.hexdigest()}.zip"


def upload_package_if_needed(runtime, path: str) -> str:
    """Zip + store in GCS KV unless already there
    (ref: upload_package_if_needed packaging.py)."""
    uri = uri_for_directory(path)
    key = uri.encode()
    if not runtime.gcs_call("kv_exists", ns="packages", key=key):
        runtime.kv_put("packages", key, _zip_directory(path))
    return uri


def resolve_uris(runtime, env: Dict[str, Any]) -> Dict[str, Any]:
    """Replace local directory paths with uploaded package URIs in
    working_dir / py_modules. Idempotent (URIs pass through)."""
    env = validate(env)
    out = dict(env)
    wd = env.get("working_dir")
    if wd and not wd.startswith("gcs://"):
        if not os.path.isdir(wd):
            raise ValueError(f"working_dir {wd!r} is not a directory")
        out["working_dir"] = upload_package_if_needed(runtime, wd)
    mods: List[str] = []
    for m in env.get("py_modules", []):
        if m.startswith("gcs://"):
            mods.append(m)
        elif os.path.isdir(m):
            mods.append(upload_package_if_needed(runtime, m))
        else:
            raise ValueError(f"py_modules entry {m!r} is not a directory")
    if mods:
        out["py_modules"] = mods
    return out


# --- worker-side setup -------------------------------------------------------

_cache_lock = threading.Lock()
_installed: Dict[str, str] = {}       # uri -> local dir


def _cache_root() -> str:
    from ray_tpu_torch.core.node import session_root

    session = os.environ.get("RAY_TPU_SESSION_DIR") or session_root()
    return os.path.join(session, "runtime_resources")


def ensure_package(runtime, uri: str) -> str:
    """Download + extract a package URI into the session cache, once
    (ref: the runtime-env agent's URI cache with delete-on-unused; we keep
    packages for the session lifetime)."""
    with _cache_lock:
        got = _installed.get(uri)
        if got:
            return got
    name = uri[len("gcs://"):]
    dest = os.path.join(_cache_root(), name[:-len(".zip")])
    if not os.path.isdir(dest):
        data = runtime.kv_get("packages", uri.encode())
        if data is None:
            raise FileNotFoundError(f"package {uri} not in GCS KV")
        tmp = dest + f".tmp{os.getpid()}"
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            z.extractall(tmp)
        try:
            os.replace(tmp, dest)        # atomic; concurrent extractors race
        except OSError:                  # benignly (same content)
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    with _cache_lock:
        _installed[uri] = dest
    return dest


class TaskEnvContext:
    """Applies a runtime env around one task execution; restores env_vars
    after. working_dir/py_modules installation is additive + idempotent."""

    def __init__(self, runtime, env: Optional[Dict[str, Any]]):
        self.runtime = runtime
        self.env = env or {}
        self._saved: Dict[str, Optional[str]] = {}

    def __enter__(self):
        env = self.env
        if not env:
            return self
        for k, v in env.get("env_vars", {}).items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = v
        wd = env.get("working_dir")
        if wd:
            path = ensure_package(self.runtime, wd)
            if path not in sys.path:
                sys.path.insert(0, path)
        for m in env.get("py_modules", []):
            path = ensure_package(self.runtime, m)
            if path not in sys.path:
                sys.path.insert(0, path)
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        self._saved.clear()
        return False


def to_json(env: Optional[Dict[str, Any]]) -> str:
    return json.dumps(env or {}, sort_keys=True)
