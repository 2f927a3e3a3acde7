"""Ray-on-Spark shim: launch a ray_tpu_torch cluster inside Spark executors.

Reference: python/ray/util/spark/ (cluster_init.py:794
setup_ray_cluster, :1067 shutdown_ray_cluster — a head starts on the
Spark driver, then a barrier-mode Spark job pins one long-running task
per executor, each execing a worker node that joins the head).

The TPU image ships no pyspark, so the Spark-dependent half is gated
behind an actionable ImportError (same policy as the gated GBDT
trainers, train/sklearn.py). The launch plan construction —
resources-per-node math and the worker bootstrap command — is pure and
tested; a pyspark environment only needs `_run_on_executors` to map the
plan over a barrier RDD.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

# Sentinel: "use every executor the Spark app can give us"
# (ref: cluster_init.py:38)
MAX_NUM_WORKER_NODES = -1

_active_cluster: Optional[dict] = None


def _worker_plan(num_worker_nodes: int, num_cpus_worker_node: int,
                 head_addr: str,
                 resources_worker_node: Optional[Dict[str, float]] = None
                 ) -> List[dict]:
    """One bootstrap spec per Spark executor slot (pure; ref:
    cluster_init.py worker command assembly)."""
    if num_worker_nodes != MAX_NUM_WORKER_NODES and num_worker_nodes <= 0:
        raise ValueError(
            "num_worker_nodes must be a positive integer or "
            "ray_tpu_torch.util.spark.MAX_NUM_WORKER_NODES")
    import json
    import os

    from ray_tpu_torch.core.node import session_root

    n = 0 if num_worker_nodes == MAX_NUM_WORKER_NODES else num_worker_nodes
    plan = []
    for i in range(max(n, 1)):
        # the worker-node join entrypoint (what LocalNodeProvider and the
        # cluster launcher also exec): a nodelet pointed at the head GCS
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.nodelet",
               "--gcs", head_addr,
               "--session-dir", os.path.join(session_root(), f"spark-worker-{i}"),
               "--resources",
               json.dumps({"CPU": float(num_cpus_worker_node),
                           **(resources_worker_node or {})}),
               "--labels", json.dumps({"spark_executor_rank": i})]
        plan.append({"rank": i, "command": cmd})
    return plan if n else plan[:1]  # MAX -> template spec, fanned at run


def setup_ray_cluster(num_worker_nodes: int,
                      num_cpus_worker_node: int = 1,
                      resources_worker_node: Optional[Dict[str, float]]
                      = None, **kwargs) -> str:
    """Start a ray_tpu_torch head on the Spark driver and one worker per Spark
    executor via a barrier-mode job (ref: cluster_init.py:794). Returns
    the head address. Requires pyspark at runtime."""
    global _active_cluster
    try:
        from pyspark.sql import SparkSession  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "ray_tpu_torch.util.spark.setup_ray_cluster needs pyspark, which "
            "is not in the TPU image. Install pyspark in your Spark "
            "driver environment; the shim then starts the head locally "
            "and fans workers out with a barrier-mode Spark job."
        ) from e
    import ray_tpu_torch

    info = ray_tpu_torch.init(num_cpus=num_cpus_worker_node)
    head_addr = info["address"]
    plan = _worker_plan(num_worker_nodes, num_cpus_worker_node,
                        head_addr, resources_worker_node)
    _run_on_executors(plan)
    _active_cluster = {"head_addr": head_addr, "plan": plan}
    return head_addr


def _run_on_executors(plan: List[dict]) -> None:
    """Pin one worker bootstrap per executor with a barrier RDD
    (ref: cluster_init.py _start_ray_worker_nodes)."""
    from pyspark import BarrierTaskContext
    from pyspark.sql import SparkSession

    spark = SparkSession.getActiveSession()
    sc = spark.sparkContext

    def boot(_it):
        import subprocess

        ctx = BarrierTaskContext.get()
        spec = plan[ctx.partitionId() % len(plan)]
        subprocess.Popen(spec["command"])
        ctx.barrier()
        yield 0

    sc.parallelize(range(len(plan)), len(plan)) \
        .barrier().mapPartitions(boot).collect()


def shutdown_ray_cluster() -> None:
    """ref: cluster_init.py:1067."""
    global _active_cluster
    import ray_tpu_torch

    ray_tpu_torch.shutdown()
    _active_cluster = None


__all__ = ["setup_ray_cluster", "shutdown_ray_cluster",
           "MAX_NUM_WORKER_NODES"]
