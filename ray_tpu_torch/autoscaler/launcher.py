"""Cluster launcher: `python -m ray_tpu_torch.cli up / down / exec /
attach / submit <config>`.

Port of ray_tpu/autoscaler/launcher.py over the port's runtime.
Reference: python/ray/scripts/scripts.py:1238 (up), :1314 (down), :1398
(attach), :1696 (exec) over autoscaler/_private/commands.py. The launcher
brings a cluster up from a laptop: start the head daemons, start the
autoscaler monitor bound to the config's NodeProvider, record cluster state
under ~/.ray_tpu_torch/clusters/<name>.json (``RAY_TPU_TORCH_CLUSTER_DIR``
overrides; the JAX package's clusters live under ~/.ray_tpu), and offer
exec/attach/submit against the running head.

Config schema (subset of the reference's ray-schema.json), in YAML or in
JSON. JSON is YAML too, and parses without PyYAML (which a machine may
lack):

    cluster_name: demo
    max_workers: 4
    idle_timeout_minutes: 1
    provider:
      type: local            # or tpu_pod (project/zone/node_types/...)
    head_resources: {CPU: 8}
    available_node_types:
      worker:
        resources: {CPU: 2}

``head_resources`` are the head nodelet's resources as given: a card on
the head machine adds no "GPU" unit unless they name it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional

STATE_DIR = os.path.expanduser(
    os.environ.get("RAY_TPU_TORCH_CLUSTER_DIR", "~/.ray_tpu_torch/clusters"))


def _parse(text: str, path: str):
    """YAML through PyYAML where it is installed (as the reference
    parses), else JSON; a file that is not JSON then needs PyYAML."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError:
            raise ImportError(
                f"{path}: this cluster config is not JSON, and parsing "
                "YAML needs PyYAML (pip install pyyaml); write the config "
                "as JSON to load it without PyYAML") from None
    return yaml.safe_load(text)


def load_config(path: str) -> dict:
    with open(path) as f:
        cfg = _parse(f.read(), path) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: cluster config must be a mapping")
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("provider", {"type": "local"})
    known = {"cluster_name", "max_workers", "idle_timeout_minutes",
             "provider", "head_resources", "available_node_types",
             "system_config"}
    unknown = set(cfg) - known
    if unknown:
        raise ValueError(
            f"{path}: unknown cluster config keys {sorted(unknown)} "
            f"(known: {sorted(known)})")
    return cfg


def _state_path(name: str) -> str:
    os.makedirs(STATE_DIR, exist_ok=True)
    return os.path.join(STATE_DIR, f"{name}.json")


def _load_state(name: str) -> Optional[dict]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _alive(pid: Optional[int]) -> bool:
    if not pid:
        return False
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:
        # a killed-but-unreaped child (we may be its parent when up() ran
        # in this process) passes kill(pid, 0); a zombie is not alive
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def _reap(pid: int) -> None:
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass   # not our child (CLI down in a fresh process)


def _term_wait(pid: Optional[int], timeout: float = 10.0) -> None:
    """SIGTERM, wait for exit, SIGKILL stragglers — `down` must not
    return with daemons still running."""
    if not _alive(pid):
        return
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.time() + timeout
    while time.time() < deadline:
        _reap(pid)
        if not _alive(pid):
            return
        time.sleep(0.1)
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    _reap(pid)


def up(config_path: str, restart: bool = False) -> dict:
    """Bring the cluster up (ref: scripts.py:1238). Head daemons + monitor
    start on THIS machine; workers come from the provider on demand."""
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.node import new_session_dir, start_gcs, start_nodelet

    cfg = load_config(config_path)
    name = cfg["cluster_name"]
    state = _load_state(name)
    if state and _alive(state.get("gcs_pid")):
        if not restart:
            print(f"cluster {name!r} already running at "
                  f"{state['address']} (use --restart to recreate)")
            return state
        down(config_path)

    sys_cfg = Config.load(cfg.get("system_config") or {})
    session_dir = new_session_dir()
    gcs_proc, gcs_addr = start_gcs(session_dir, sys_cfg)
    head_res = {k: float(v) for k, v in
                (cfg.get("head_resources") or {"CPU": 4.0}).items()}
    nodelet_proc, nodelet_addr, node_id, store = start_nodelet(
        session_dir, sys_cfg, gcs_addr, resources=head_res)
    with open(os.path.join(session_dir, "monitor.log"), "ab") as log:
        monitor_proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.autoscaler.monitor",
             "--gcs", f"{gcs_addr[0]}:{gcs_addr[1]}",
             "--session-dir", session_dir,
             "--cluster-yaml", os.path.abspath(config_path)],
            stdout=log, stderr=subprocess.STDOUT)
    state = {"cluster_name": name,
             "address": f"{gcs_addr[0]}:{gcs_addr[1]}",
             "session_dir": session_dir,
             "gcs_pid": gcs_proc.pid, "nodelet_pid": nodelet_proc.pid,
             "monitor_pid": monitor_proc.pid,
             "config_path": os.path.abspath(config_path)}
    with open(_state_path(name), "w") as f:
        json.dump(state, f, indent=2)
    print(json.dumps(state, indent=2))
    print(f"\ncluster {name!r} is up — connect with "
          f"ray_tpu_torch.init(address='{state['address']}')")
    return state


def down(config_path: str) -> bool:
    """Tear the cluster down (ref: scripts.py:1314): kill the monitor,
    terminate autoscaled provider nodes (from the monitor's persisted
    node table), then stop the head daemons. A nodelet goes down with
    the workers it started."""
    from ray_tpu_torch.autoscaler.node_provider import terminate_tree

    cfg = load_config(config_path)
    name = cfg["cluster_name"]
    state = _load_state(name)
    if state is None:
        print(f"no recorded state for cluster {name!r}")
        return False
    _term_wait(state.get("monitor_pid"))
    nodes_file = os.path.join(state["session_dir"], "autoscaler_nodes.json")
    try:
        with open(nodes_file) as f:
            for rec in json.load(f).values():
                if _alive(rec.get("pid")):
                    terminate_tree(rec["pid"])
                    print(f"terminated autoscaled node pid={rec['pid']}")
    except (OSError, ValueError):
        pass
    # cloud providers track nodes in the cloud, not as local pids — ask
    # the provider itself (a TPU VM left running after `down` keeps
    # billing; ref: commands.py teardown_cluster terminates via provider)
    if cfg["provider"].get("type", "local") != "local":
        try:
            from ray_tpu_torch.autoscaler.monitor import _build_provider

            provider = _build_provider(cfg, None, state["session_dir"])
            for pname in provider.non_terminated_nodes():
                provider.terminate_node(pname)
                print(f"terminated provider node {pname}")
        except Exception as e:   # noqa: BLE001 — best-effort teardown
            print(f"provider teardown failed: {e}; check for leaked nodes")
    for pid_key in ("nodelet_pid", "gcs_pid"):
        if _alive(state.get(pid_key)):
            print(f"stopping {pid_key} {state[pid_key]}")
            terminate_tree(state[pid_key])
            _reap(state[pid_key])
    try:
        os.unlink(_state_path(name))
    except OSError:
        pass
    print(f"cluster {name!r} is down")
    return True


def _env_for(state: dict) -> dict:
    env = dict(os.environ)
    env["RAY_TPU_ADDRESS"] = state["address"]
    return env


def exec_cmd(config_path: str, command: str) -> int:
    """Run a shell command against the cluster (ref: scripts.py:1696).
    The command sees RAY_TPU_ADDRESS; `ray_tpu_torch.init()` picks it up."""
    cfg = load_config(config_path)
    state = _load_state(cfg["cluster_name"])
    if state is None or not _alive(state.get("gcs_pid")):
        print(f"cluster {cfg['cluster_name']!r} is not running")
        return 1
    proc = subprocess.run(command, shell=True, env=_env_for(state))
    return proc.returncode


def submit(config_path: str, script: str, *script_args: str) -> int:
    """Run a python script against the cluster (ref: scripts.py submit)."""
    cfg = load_config(config_path)
    state = _load_state(cfg["cluster_name"])
    if state is None or not _alive(state.get("gcs_pid")):
        print(f"cluster {cfg['cluster_name']!r} is not running")
        return 1
    proc = subprocess.run([sys.executable, script, *script_args],
                          env=_env_for(state))
    return proc.returncode


def attach(config_path: str) -> int:
    """Interactive shell with the cluster address exported (ref:
    scripts.py:1398 `ray attach`)."""
    cfg = load_config(config_path)
    state = _load_state(cfg["cluster_name"])
    if state is None or not _alive(state.get("gcs_pid")):
        print(f"cluster {cfg['cluster_name']!r} is not running")
        return 1
    shell = os.environ.get("SHELL", "/bin/bash")
    print(f"attaching to {cfg['cluster_name']!r} "
          f"(RAY_TPU_ADDRESS={state['address']}); exit to detach")
    return subprocess.run([shell], env=_env_for(state)).returncode


def status(config_path: str) -> dict:
    cfg = load_config(config_path)
    state = _load_state(cfg["cluster_name"]) or {}
    out = {"cluster_name": cfg["cluster_name"],
           "running": _alive(state.get("gcs_pid")),
           "address": state.get("address"),
           "monitor_alive": _alive(state.get("monitor_pid"))}
    print(json.dumps(out, indent=2))
    return out
