"""Dashboard: HTTP head server exposing cluster state, metrics, logs and
the job REST routes; a Grafana/Prometheus provisioning export; the per-node
agent.

Port of ray_tpu/dashboard/. Reference: dashboard/head.py (aiohttp head
server) + dashboard/modules/ (state, metrics, jobs, logs). The port's head
serves through the standard library's ThreadingHTTPServer. ``agent.py``,
embedded in each nodelet, pushes node and host stats to the GCS KV
whenever ``metrics_report_interval_s > 0``; the head reads them there.
"""

from ray_tpu_torch.dashboard.head import DashboardHead, start_dashboard

__all__ = ["DashboardHead", "start_dashboard"]
