"""Grafana + Prometheus provisioning.

Port of ray_tpu/dashboard/grafana.py: the same files, byte for byte, so
one Grafana and Prometheus setup serves either package's head (the
series are the head's ``raytpu_*`` names in both).

Reference: dashboard/modules/metrics/grafana_dashboard_factory.py — the
reference generates Grafana dashboard JSON and provisioning configs from
its metric definitions. Same idea here: emit a ready-to-mount directory
(Prometheus scrape config pointing at the head's /metrics, Grafana
datasource + dashboard provider YAML, and a cluster dashboard built from
the stats every daemon already exports via /api/v0/node_stats and
util/metrics.py).

    python -m ray_tpu_torch.dashboard.grafana --out /etc/raytpu-grafana \
        --head 127.0.0.1:8265
    # then: grafana-server --config ... provisioning from that dir,
    # prometheus --config.file=<out>/prometheus.yml
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

# Panels: (title, promql expr, unit). Names match util/metrics.py series
# exported on the head's /metrics endpoint.
_PANELS: List[tuple] = [
    ("Nodes alive", 'raytpu_nodes_alive', "short"),
    ("Actors alive", 'raytpu_actors_alive', "short"),
    ("Workers per node", 'raytpu_workers_alive', "short"),
    ("Object store bytes", 'raytpu_object_store_bytes_in_use', "bytes"),
    ("Object store objects", 'raytpu_object_store_num_objects', "short"),
    ("Spilled bytes", 'raytpu_spilled_bytes_total', "bytes"),
    ("Pending leases", 'raytpu_pending_leases', "short"),
    ("OOM kills", 'raytpu_oom_kills_total', "short"),
    ("Host load (1m)", 'raytpu_node_load_1m', "short"),
    ("Host memory available", 'raytpu_node_mem_available_bytes', "bytes"),
]


def generate_dashboard(title: str = "ray_tpu cluster") -> dict:
    """Grafana dashboard JSON (schema v36+, default datasource)."""
    panels = []
    for i, (name, expr, unit) in enumerate(_PANELS):
        panels.append({
            "id": i + 1,
            "title": name,
            "type": "timeseries",
            "gridPos": {"h": 7, "w": 8, "x": (i % 3) * 8,
                        "y": (i // 3) * 7},
            "fieldConfig": {"defaults": {"unit": unit}},
            "targets": [{"expr": expr, "refId": "A",
                         "legendFormat": "{{node}}"}],
        })
    return {
        "title": title,
        "uid": "raytpu-cluster",
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "panels": panels,
        "schemaVersion": 36,
        "tags": ["ray_tpu", "generated"],
    }


def prometheus_config(head_addr: str) -> str:
    return f"""\
# GENERATED by python -m ray_tpu.dashboard.grafana — scrapes the
# dashboard head's aggregated /metrics endpoint.
global:
  scrape_interval: 5s
scrape_configs:
  - job_name: ray_tpu
    metrics_path: /metrics
    static_configs:
      - targets: ['{head_addr}']
"""


def datasource_yaml() -> str:
    return """\
apiVersion: 1
datasources:
  - name: Prometheus
    type: prometheus
    access: proxy
    url: http://127.0.0.1:9090
    isDefault: true
"""


def provider_yaml(dashboards_dir: str) -> str:
    return f"""\
apiVersion: 1
providers:
  - name: ray_tpu
    folder: ray_tpu
    type: file
    options:
      path: {dashboards_dir}
"""


def provision(out_dir: str, head_addr: str = "127.0.0.1:8265") -> List[str]:
    """Write the full provisioning tree; returns written paths."""
    written = []

    def w(rel: str, content: str):
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(content)
        written.append(path)

    w("prometheus.yml", prometheus_config(head_addr))
    w("grafana/provisioning/datasources/raytpu.yaml", datasource_yaml())
    w("grafana/provisioning/dashboards/raytpu.yaml",
      provider_yaml(os.path.join(os.path.abspath(out_dir), "dashboards")))
    w("dashboards/raytpu-cluster.json",
      json.dumps(generate_dashboard(), indent=2))
    return written


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--head", default="127.0.0.1:8265")
    args = ap.parse_args()
    for path in provision(args.out, args.head):
        print(path)


if __name__ == "__main__":
    main()
