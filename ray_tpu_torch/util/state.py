"""State/observability API.

Reference: python/ray/util/state/api.py:109 (StateApiClient; list_actors:782,
list_tasks:1009) backed by the GCS task/actor/node tables.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core import runtime as rt


def list_nodes() -> List[dict]:
    out = []
    for n in rt.get_runtime().gcs_call("get_nodes"):
        out.append({"node_id": n.node_id.hex(), "alive": n.alive,
                    "resources": n.resources_total.quantities,
                    "labels": n.labels, "address": n.nodelet_addr})
    return out


def list_actors(state: Optional[str] = None) -> List[dict]:
    out = []
    for a in rt.get_runtime().gcs_call("list_actors"):
        if state and a["state"] != state:
            continue
        out.append({"actor_id": a["actor_id"].hex(), "state": a["state"],
                    "class_name": a["class_name"], "name": a["name"],
                    "namespace": a["namespace"],
                    "num_restarts": a["num_restarts"],
                    "address": a["address"]})
    return out


def list_tasks(limit: int = 1000) -> List[dict]:
    return rt.get_runtime().gcs_call("list_task_events", limit=limit)


def list_jobs() -> List[dict]:
    out = []
    for j in rt.get_runtime().gcs_call("list_jobs"):
        out.append({"job_id": j["job_id"].hex(), "driver": j["driver"],
                    "start": j["start"], "end": j["end"], "meta": j["meta"]})
    return out


def edge_stats() -> Dict[str, dict]:
    """Measured per-edge transfer model, keyed "src_node->dst_node":
    EWMA latency/bandwidth plus totals, learned from object-store pulls
    and collective transport rounds (ray_tpu_torch.observability.edges)."""
    from ray_tpu_torch.observability.edges import edge_stats as _edge_stats

    return _edge_stats()


def list_placement_groups() -> List[dict]:
    """ref: `ray list placement-groups` — the GCS PG table in the same
    view shape as PlacementGroup.table()."""
    out = []
    for pg in rt.get_runtime().gcs_call("list_placement_groups"):
        out.append({"pg_id": pg["pg_id"].hex(), "state": pg["state"],
                    "strategy": pg["strategy"], "name": pg["name"],
                    "bundles": [{"index": b["index"],
                                 "node_id": (b["node_id"].hex()
                                             if b["node_id"] is not None
                                             else None),
                                 "resources": b["resources"]}
                                for b in pg["bundles"]]})
    return out


def health_report() -> dict:
    """The health plane's view (observability/health.py): every
    registered progress beacon with its freshness, recent stall /
    straggler events, telemetry drop counters, node liveness."""
    return rt.get_runtime().gcs_call("health_report")


def summarize_tasks(limit: int = 5000) -> Dict[str, Dict[str, int]]:
    """ref: `ray summary tasks` (state_cli.py)."""
    summary: Dict[str, Dict[str, int]] = {}
    for ev in list_tasks(limit):
        name = ev.get("name", "?")
        state = ev.get("state", "?")
        summary.setdefault(name, {})
        summary[name][state] = summary[name].get(state, 0) + 1
    return summary


def cluster_summary() -> dict:
    """ref: `ray status` output."""
    import ray_tpu_torch

    nodes = list_nodes()
    actors = list_actors()
    return {
        "nodes_alive": sum(1 for n in nodes if n["alive"]),
        "nodes_dead": sum(1 for n in nodes if not n["alive"]),
        "total_resources": ray_tpu_torch.cluster_resources(),
        "available_resources": ray_tpu_torch.available_resources(),
        "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
        "actors_total": len(actors),
        # telemetry-plane integrity: nonzero means the observability
        # story has holes (events dropped at the buffer, or whole
        # reports that never reached the GCS)
        "task_events_dropped": _metric_total("ray_tpu_task_events_dropped"),
        "telemetry_reports_dropped": _metric_total(
            "ray_tpu_telemetry_reports_dropped"),
    }


def _metric_total(name: str) -> float:
    """Cluster-wide total of one merged counter from GCS KV
    ns="metrics" (0.0 when never incremented)."""
    import json

    raw = rt.get_runtime().gcs_call("kv_get", ns="metrics",
                                    key=name.encode())
    if not raw:
        return 0.0
    try:
        payload = json.loads(raw)
        return sum(s.get("value", 0.0) for s in payload.get("series", []))
    except Exception:
        return 0.0


def memory_report(top_n: int = 20) -> dict:
    """Cluster memory attribution (observability/memory.py): per-
    subsystem bytes, top holders with owner/pins/temperature, per-node
    store coverage, the spill-candidate list (unpinned AND cold) and
    leak suspects (pinned with no live owner ref past
    `memory_leak_suspect_s`)."""
    return rt.get_runtime().gcs_call("memory_report", top_n=top_n)


def list_objects(limit: int = 100) -> List[dict]:
    """Attributed resident objects, largest first (ref: `ray memory`'s
    object table) — from the same aggregated view as memory_report()."""
    rep = memory_report(top_n=limit)
    return rep.get("top_holders", [])


def memory_summary() -> dict:
    """Owner-side refcount stats (ref: `ray memory` scripts.py:1900)
    plus spilling-readiness gauges: local store occupancy / pinned bytes
    / pin-count distribution, and the same per node from the stats every
    nodelet agent pushes to GCS KV ns="node_stats"."""
    runtime = rt.get_runtime()
    stats = runtime.refs.stats()
    stats["store_bytes_in_use"] = runtime.store.bytes_in_use()
    stats["store_capacity"] = runtime.store.capacity()
    stats["store_objects"] = runtime.store.num_objects()
    stats["store_evictions"] = runtime.store.num_evictions()
    stats.update({f"store_{k}": v
                  for k, v in runtime.store.pin_summary().items()})
    # per-node store view (spilling readiness across the cluster)
    import json

    nodes: Dict[str, dict] = {}
    try:
        for key in runtime.gcs_call("kv_keys", ns="node_stats"):
            raw = runtime.gcs_call("kv_get", ns="node_stats", key=key)
            if not raw:
                continue
            try:
                s = json.loads(raw)
            except Exception:
                continue
            nodes[key.hex()[:12]] = {
                k: s.get(k) for k in
                ("store_bytes", "store_capacity", "store_occupancy",
                 "store_pinned_bytes", "store_pinned_objects",
                 "store_pin_count_distribution", "spilled_bytes",
                 "spilled_objects", "spilled_then_dropped",
                 "restored_objects", "spill_bytes_total",
                 "restore_bytes_total") if k in s}
    except Exception:
        pass
    stats["nodes"] = nodes
    return stats
