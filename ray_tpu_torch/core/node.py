"""Node/session bootstrap: spawn gcs + nodelet daemons.

Reference: python/ray/_private/node.py (start_head_processes:1148) and
services.py (start_gcs_server:1280, start_raylet:1353). Daemons are separate
OS processes started with a ready-pipe handshake; the session directory holds
logs and liveness metadata.
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.core.config import Config

Address = Tuple[str, int]


def _spawn_with_ready(cmd, session_dir: str, log_name: str,
                      timeout: float = 30.0) -> Tuple[subprocess.Popen, str]:
    """Start a daemon that writes "host:port[:...]\n" to --ready-fd."""
    rfd, wfd = os.pipe()
    os.set_inheritable(wfd, True)
    logdir = os.path.join(session_dir, "logs")
    os.makedirs(logdir, exist_ok=True)
    out = open(os.path.join(logdir, log_name + ".out"), "ab")
    err = open(os.path.join(logdir, log_name + ".err"), "ab")
    # pass_fds (implies close_fds=True): only the ready-fd crosses into the
    # daemon — inheriting everything leaks the parent's stdout/stderr pipes
    # into long-lived daemons, which keeps `pytest | tail`-style consumers
    # blocked on EOF forever after the parent exits.
    proc = subprocess.Popen(cmd + ["--ready-fd", str(wfd)],
                            stdout=out, stderr=err, pass_fds=(wfd,),
                            start_new_session=True)
    out.close(); err.close()
    os.close(wfd)
    line = b""
    deadline = time.time() + timeout
    with os.fdopen(rfd, "rb") as f:
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"{log_name} died at startup; see {logdir}/{log_name}.err")
            chunk = f.readline()
            if chunk:
                line = chunk
                break
    if not line:
        proc.terminate()
        raise RuntimeError(f"{log_name} did not become ready in {timeout}s")
    return proc, line.decode().strip()


def start_gcs(session_dir: str, cfg: Config, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[subprocess.Popen, Address]:
    proc, ready = _spawn_with_ready(
        [sys.executable, "-m", "ray_tpu_torch.core.gcs", "--host", host,
         "--port", str(port), "--config", cfg.to_json()],
        session_dir, "gcs")
    h, p = ready.rsplit(":", 1)
    return proc, (h, int(p))


def start_nodelet(session_dir: str, cfg: Config, gcs_addr: Address,
                  resources: Optional[Dict[str, float]] = None,
                  labels: Optional[Dict[str, Any]] = None,
                  host: str = "127.0.0.1", port: int = 0,
                  log_name: str = "nodelet"):
    proc, ready = _spawn_with_ready(
        [sys.executable, "-m", "ray_tpu_torch.core.nodelet", "--host", host,
         "--port", str(port), "--gcs", f"{gcs_addr[0]}:{gcs_addr[1]}",
         "--session-dir", session_dir,
         "--resources", json.dumps(resources or {}),
         "--labels", json.dumps(labels or {}),
         "--config", cfg.to_json()],
        session_dir, log_name)
    h, p, node_id_hex, store_name = ready.split(":", 3)
    return proc, (h, int(p)), node_id_hex, store_name


def session_root() -> str:
    """Root of the port's sessions, logs, spilled objects and flight
    dumps: ``RAY_TPU_TMPDIR`` when set, else ``ray_tpu_torch`` under the
    process's temp dir (``TMPDIR``), so that two checkouts run with their
    own temp dirs never share a session root."""
    return os.environ.get("RAY_TPU_TMPDIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")


def new_session_dir() -> str:
    base = session_root()
    path = os.path.join(base, f"session_{int(time.time() * 1000)}_{os.getpid()}")
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    # convenience symlink like the reference's session_latest
    latest = os.path.join(base, "session_latest")
    try:
        if os.path.islink(latest) or os.path.exists(latest):
            os.remove(latest)
        os.symlink(path, latest)
    except OSError:
        pass
    return path


DAEMON_MODULE_PREFIX = "ray_tpu_torch.core."


def port_processes() -> Dict[int, Tuple[str, int]]:
    """{pid: (module, ppid)} of the live ``python -m ray_tpu_torch.core.*``
    processes on this machine: GCS, nodelets and workers, of any session."""
    out = {}
    prefix = DAEMON_MODULE_PREFIX.encode()
    for proc in os.listdir("/proc"):
        if not proc.isdigit():
            continue
        try:
            with open(f"/proc/{proc}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{proc}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if len(argv) >= 3 and argv[1] == b"-m" and \
                argv[2].startswith(prefix):
            out[int(proc)] = (argv[2].decode(), ppid)
    return out


def session_pids(roots) -> Dict[int, str]:
    """{pid: module} of the port's processes among ``roots`` (a session's
    daemon pids) and their children (the nodelets' workers)."""
    roots = set(roots)
    return {pid: mod for pid, (mod, ppid) in port_processes().items()
            if pid in roots or ppid in roots}


def pid_alive(pid: int) -> bool:
    """True while ``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def detect_gpus() -> int:
    """Local CUDA device count WITHOUT importing torch or initialising
    CUDA (daemons must hold no CUDA context, as the reference's never grab
    the TPU). Port of ray_tpu/core/node.py:101 detect_tpu_chips.

    Order: the ``RAY_TPU_CHIPS`` override; then ``CUDA_VISIBLE_DEVICES``
    when set (its entries up to the first invalid one, as the CUDA runtime
    reads it; empty means none); then the driver's entries under
    ``/proc/driver/nvidia/gpus/``; then the cards ``nvidia-smi -L`` lists;
    else 0."""
    env = os.environ.get("RAY_TPU_CHIPS")
    if env is not None:
        return int(env)
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        n = 0
        for tok in env.split(","):
            tok = tok.strip()
            if not tok or tok.startswith("-"):
                break
            n += 1
        return n
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        pass
    # a container may not mount the driver's /proc entries, and its
    # /dev/nvidia<N> nodes may name cards it cannot open; nvidia-smi (NVML
    # in its own process, no CUDA context here) lists the ones it can
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))
