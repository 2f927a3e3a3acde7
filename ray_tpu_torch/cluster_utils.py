"""Multi-node-on-one-machine test cluster.

Reference: python/ray/cluster_utils.py:99 — spawn one GCS plus N nodelets as
separate processes with faked resources to exercise distributed scheduling,
spillback, object transfer, and failure handling without real hosts.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.node import new_session_dir, start_gcs, start_nodelet


class ClusterNode:
    def __init__(self, proc, addr, node_id_hex, store_name):
        self.proc = proc
        self.addr = addr
        self.node_id_hex = node_id_hex
        self.store_name = store_name

    def kill(self):
        """Hard-kill the nodelet (and its workers) — chaos testing
        (ref: NodeKillerActor _private/test_utils.py:1400)."""
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                self.proc.kill()
            except Exception:
                pass
        self.proc.wait(timeout=5)


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_resources: Optional[Dict[str, float]] = None,
                 system_config: Optional[Dict[str, Any]] = None):
        self.cfg = Config.load(system_config)
        self.session_dir = new_session_dir()
        self.gcs_proc, self.gcs_addr = start_gcs(self.session_dir, self.cfg)
        self.nodes: List[ClusterNode] = []
        if initialize_head:
            self.add_node(resources=head_resources or {"CPU": 2.0})

    @property
    def address(self) -> str:
        return f"{self.gcs_addr[0]}:{self.gcs_addr[1]}"

    def add_node(self, resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, Any]] = None) -> ClusterNode:
        res = dict(resources or {"CPU": 2.0})
        res.setdefault("CPU", 2.0)
        proc, addr, node_id_hex, store_name = start_nodelet(
            self.session_dir, self.cfg, self.gcs_addr, resources=res,
            labels=labels, log_name=f"nodelet-{len(self.nodes)}")
        node = ClusterNode(proc, addr, node_id_hex, store_name)
        self.nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode):
        node.kill()
        self.nodes.remove(node)

    def kill_gcs(self):
        """Hard-kill the control plane (ref: GCS fault-tolerance tests,
        test_gcs_fault_tolerance.py)."""
        try:
            self.gcs_proc.kill()
            self.gcs_proc.wait(timeout=5)
        except Exception:
            pass

    def restart_gcs(self):
        """Restart GCS on the SAME address so nodelets/drivers reconnect.
        Requires cfg.gcs_storage='file' for state to survive."""
        self.kill_gcs()
        self.gcs_proc, self.gcs_addr = start_gcs(
            self.session_dir, self.cfg, host=self.gcs_addr[0],
            port=self.gcs_addr[1])

    def connect(self, **kwargs):
        import ray_tpu_torch

        return ray_tpu_torch.init(address=self.address, **kwargs)

    def shutdown(self):
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        for n in self.nodes:
            try:
                n.kill()
            except Exception:
                pass
        try:
            self.gcs_proc.terminate()
            self.gcs_proc.wait(timeout=3)
        except Exception:
            try:
                self.gcs_proc.kill()
            except Exception:
                pass
