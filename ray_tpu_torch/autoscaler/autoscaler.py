"""StandardAutoscaler: poll GCS load, launch/terminate via the provider.

Port of ray_tpu/autoscaler/autoscaler.py over the port's ``ResourceSet``
and GCS ``get_load`` (gang rows included). Reference: autoscaler.py:166
update loop + resource_demand_scheduler.py:101 (bin-packing of demand into
node types). Round-1 policy: scale up one node
of the matching type per update while unmet demand or pending leases
persist; scale down autoscaled nodes idle past idle_timeout.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.core.common import ResourceSet


class StandardAutoscaler:
    def __init__(self, gcs_call, provider: NodeProvider,
                 node_types: Dict[str, Dict[str, float]],
                 max_nodes: int = 8, idle_timeout_s: float = 60.0):
        """gcs_call(method, **kw) — a bound caller (Runtime.gcs_call)."""
        self.gcs_call = gcs_call
        self.provider = provider
        self.node_types = node_types
        self.max_nodes = max_nodes
        self.idle_timeout_s = idle_timeout_s
        self._idle_since: Dict[str, float] = {}

    def _label_map(self) -> Dict[str, str]:
        """provider_node_id label -> GCS node id, for providers whose
        node_id_of can't resolve (cloud slices)."""
        out: Dict[str, str] = {}
        try:
            for n in self.gcs_call("get_nodes"):
                pid = (n.labels or {}).get("provider_node_id")
                if pid and n.alive:
                    out[pid] = n.node_id.hex()
        except Exception:
            pass
        return out

    def _pick_type(self, demand: Dict[str, float]) -> Optional[str]:
        req = ResourceSet({k: float(v) for k, v in demand.items()})
        for name, res in self.node_types.items():
            if req.fits_in(ResourceSet({k: float(v) for k, v in res.items()})):
                return name
        return None

    def update(self) -> dict:
        """One reconcile step; returns actions taken (ref: autoscaler.py
        StandardAutoscaler.update)."""
        load = self.gcs_call("get_load")
        actions = {"launched": [], "terminated": [], "gang_demand": []}
        n_alive = len(self.provider.non_terminated_nodes())

        # scale up on unmet demand (driver pick_node misses, PENDING
        # placement-group bundles, nodelet infeasible queues, and elastic
        # gang shortfalls — the "gang" tag attributes those launches)
        wanted_types: List[str] = []
        for d in load["unmet_demand"]:
            t = self._pick_type(d["resources"])
            if t:
                wanted_types.append(t)
            if d.get("gang") and d["gang"] not in actions["gang_demand"]:
                actions["gang_demand"].append(d["gang"])
        if not wanted_types and any(v > 0 for v in
                                    load["pending_leases"].values()):
            wanted_types.append(next(iter(self.node_types)))
        for t in wanted_types[:max(0, self.max_nodes - n_alive)]:
            nid = self.provider.create_node(t, self.node_types[t])
            actions["launched"].append(nid)
            break  # one per update, like conservative upscaling

        # scale down idle autoscaled nodes
        now = time.time()
        idle_gcs = set(load["idle_nodes"])
        label_map = self._label_map()
        for pname in self.provider.non_terminated_nodes():
            gcs_id = getattr(self.provider, "node_id_of", lambda _: None)(pname)
            if gcs_id is None:
                # cloud providers can't know GCS ids; slices register
                # their nodelet with labels={"provider_node_id": name}
                gcs_id = label_map.get(pname)
            if gcs_id is not None and gcs_id in idle_gcs:
                since = self._idle_since.setdefault(pname, now)
                if now - since > self.idle_timeout_s:
                    self.provider.terminate_node(pname)
                    actions["terminated"].append(pname)
                    self._idle_since.pop(pname, None)
            else:
                self._idle_since.pop(pname, None)
        return actions
