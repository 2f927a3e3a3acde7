"""ray_tpu_torch.observability — batched telemetry for the whole cluster.

Four pieces (ref: src/ray/stats/ + metrics_agent.py +
task_event_buffer.h:199):

- TelemetryAgent (agent.py): one per process; accumulates metric deltas,
  task events, spans, and transfer-edge observations locally and ships
  them to the GCS in ONE batched report per
  `telemetry_report_interval_s` — the hot path never issues an RPC.
- EdgeModel (edges.py): GCS-side EWMA latency/bandwidth per directed
  (src_node, dst_node) edge, fed by object-store pulls and collective
  transport rounds; `edge_stats()` is the read API.
- memory (memory.py): per-process MemoryTracker (who holds which bytes,
  pinned why, how hot) + GCS-side MemoryAggregator behind
  `state.memory_report()` — per-subsystem attribution, spill candidates,
  leak suspects.
- chrome_trace (timeline.py): merges task states + spans into a Chrome
  trace with per-worker lanes for `ray_tpu_torch.timeline()`.
"""

from ray_tpu_torch.observability.agent import TelemetryAgent
from ray_tpu_torch.observability.edges import EdgeModel, edge_stats, record_transfer
from ray_tpu_torch.observability.memory import (MemoryAggregator, MemoryTracker,
                                          tracker)
from ray_tpu_torch.observability.timeline import chrome_trace

__all__ = ["TelemetryAgent", "EdgeModel", "edge_stats", "record_transfer",
           "MemoryAggregator", "MemoryTracker", "tracker", "chrome_trace"]
