"""Head-resident autoscaler daemon.

Port of ray_tpu/autoscaler/monitor.py over the port's runtime.
Reference: python/ray/autoscaler/_private/monitor.py:126 — a process on the
head node that polls GCS load and drives StandardAutoscaler against the
cluster config's NodeProvider. Launched by `python -m ray_tpu_torch.cli
up` (launcher.py) next to the head daemons; writes the provider's node
table to <session_dir>/autoscaler_nodes.json so `down` can terminate
provider nodes even after this process is gone.

    python -m ray_tpu_torch.autoscaler.monitor --gcs H:P --session-dir D \
        --cluster-yaml cluster.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

logger = logging.getLogger("ray_tpu_torch.autoscaler.monitor")


def _build_provider(cfg: dict, gcs_addr, session_dir: str):
    from ray_tpu_torch.autoscaler.node_provider import (LocalNodeProvider,
                                                        TPUPodProvider)

    p = cfg.get("provider", {"type": "local"})
    kind = p.get("type", "local")
    if kind == "local":
        return LocalNodeProvider(gcs_addr, session_dir)
    if kind == "tpu_pod":
        return TPUPodProvider(
            project=p["project"], zone=p["zone"],
            node_types=p.get("node_types"),
            runtime_version=p.get("runtime_version", "v2-alpha-tpuv5-lite"),
            startup_script=p.get("startup_script", ""),
            cluster_name=cfg.get("cluster_name", "default"))
    raise ValueError(f"unknown provider type {kind!r}")


def _node_types(cfg: dict) -> dict:
    out = {}
    for name, t in (cfg.get("available_node_types") or {}).items():
        out[name] = {k: float(v) for k, v in (t.get("resources")
                                              or {}).items()}
    return out or {"worker": {"CPU": 1.0}}


def _dump_state(path: str, provider):
    """Provider node table → disk, so `down` can clean up without us."""
    state = {}
    for name, rec in getattr(provider, "nodes", {}).items():
        state[name] = {"pid": rec["proc"].pid if "proc" in rec else None,
                       "node_id": rec.get("node_id")}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def run_monitor(gcs_addr, session_dir: str, cluster_cfg: dict,
                interval_s: float = 2.0, max_updates: int = 0):
    """Blocking reconcile loop (max_updates=0 → forever)."""
    from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
    from ray_tpu_torch.core.rpc import ClientPool, EventLoopThread

    # A minimal GCS caller: the monitor is not a worker/driver, it only
    # needs gcs_call (ref: monitor.py holds a GcsClient, not a core worker)
    loop_thread = EventLoopThread()
    pool = ClientPool()

    def gcs_call(method, **kw):
        async def _c():
            return await pool.get(tuple(gcs_addr)).call(method, timeout=10.0,
                                                        **kw)
        return loop_thread.run(_c(), timeout=15.0)

    provider = _build_provider(cluster_cfg, gcs_addr, session_dir)
    scaler = StandardAutoscaler(
        gcs_call, provider,
        node_types=_node_types(cluster_cfg),
        max_nodes=int(cluster_cfg.get("max_workers", 4)),
        idle_timeout_s=60.0 * float(
            cluster_cfg.get("idle_timeout_minutes", 1.0)))
    state_path = os.path.join(session_dir, "autoscaler_nodes.json")
    _dump_state(state_path, provider)
    n = 0
    while True:
        try:
            actions = scaler.update()
            if actions["launched"] or actions["terminated"]:
                logger.info("autoscaler actions: %s", actions)
                _dump_state(state_path, provider)
        except (ConnectionRefusedError, OSError):
            logger.warning("GCS unreachable; monitor exiting")
            return
        except Exception:
            logger.exception("autoscaler update failed")
        n += 1
        if max_updates and n >= max_updates:
            return
        time.sleep(interval_s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs", required=True)
    ap.add_argument("--session-dir", required=True)
    ap.add_argument("--cluster-yaml", required=True)
    ap.add_argument("--interval", type=float, default=2.0)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[monitor] %(asctime)s %(levelname)s %(message)s")
    from ray_tpu_torch.autoscaler.launcher import load_config

    cfg = load_config(args.cluster_yaml)
    h, p = args.gcs.rsplit(":", 1)
    run_monitor((h, int(p)), args.session_dir, cfg, args.interval)


if __name__ == "__main__":
    main()
