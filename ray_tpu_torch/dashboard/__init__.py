"""Dashboard: only ``agent.py`` is ported so far (the nodelet's embedded
agent pushes node and host stats to the GCS KV whenever
``metrics_report_interval_s > 0``). The HTTP head and the Grafana export
(``ray_tpu/dashboard/head.py``, ``grafana.py``) are ROADMAP.md queue 1
item 11.
"""
