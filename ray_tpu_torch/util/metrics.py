"""User-defined metrics: Counter / Gauge / Histogram.

Reference: python/ray/util/metrics.py:150,215,290 + metrics_agent.py —
recording is a local lock + dict update with ZERO synchronous RPCs; the
per-process TelemetryAgent (ray_tpu_torch/observability/agent.py) collects the
accumulated deltas and ships them to the GCS in one batched report per
`telemetry_report_interval_s`. The GCS merges deltas across processes
into KV namespace "metrics" (merge_payload below: counters sum, gauges
last-write, histograms add sum/count/buckets), so the state API, the dashboard /metrics endpoint, and `prometheus_text()`
all read one cluster-wide view. Histograms keep per-series buckets and
render valid Prometheus `_bucket{le=...}`/`_sum`/`_count` exposition
with a `+Inf` bound; `quantile(q)` estimates percentiles from them.

Metric objects are tracked by weak reference — hold the instrument for
as long as you record into it (module/engine-level, like the reference's
instruments); deltas pending on a garbage-collected metric are lost.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import runtime as rt

_registry_lock = threading.Lock()
_registry: "weakref.WeakSet[_Metric]" = weakref.WeakSet()


class _Metric:
    kind = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}
        # un-reported deltas, swapped out by the TelemetryAgent
        self._pending: Dict[Tuple, Dict[str, Any]] = {}
        with _registry_lock:
            _registry.add(self)

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple(sorted(merged.items()))

    def _collect(self) -> Optional[dict]:
        """Swap out pending deltas as one report payload (agent-side)."""
        with self._lock:
            if not self._pending:
                return None
            pending, self._pending = self._pending, {}
        return {"name": self.name, "kind": self.kind,
                "description": self.description,
                "series": [dict(d, tags=dict(k)) for k, d in pending.items()]}


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1
            d = self._pending.setdefault(k, {"value": 0.0, "count": 0})
            d["value"] += value
            d["count"] += 1


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            self._values[k] = value
            self._pending[k] = {"value": value}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or [0.01, 0.05, 0.1, 0.5, 1, 5, 10])
        self._sums: Dict[Tuple, float] = {}
        self._buckets: Dict[Tuple, List[int]] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        # first bound >= value == Prometheus `value <= le`; past-the-end
        # lands in the overflow (+Inf) slot
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1
            b = self._buckets.setdefault(k, [0] * (len(self.boundaries) + 1))
            b[idx] += 1
            self._values[k] = self._sums[k] / self._counts[k]  # mean
            d = self._pending.setdefault(
                k, {"sum": 0.0, "count": 0,
                    "buckets": [0] * (len(self.boundaries) + 1)})
            d["sum"] += value
            d["count"] += 1
            d["buckets"][idx] += 1

    def _collect(self) -> Optional[dict]:
        p = super()._collect()
        if p:
            p["boundaries"] = self.boundaries
        return p

    def quantile(self, q: float,
                 tags: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Estimate the q-th quantile (0..1) from THIS process's buckets;
        pass tags to restrict to one series, omit to aggregate all. For
        the cluster-wide estimate use the merged GCS payload with
        quantile_from_buckets()."""
        with self._lock:
            if tags is None:
                rows = list(self._buckets.values())
            else:
                row = self._buckets.get(self._key(tags))
                rows = [row] if row else []
            if not rows:
                return None
            agg = [sum(col) for col in zip(*rows)]
        return quantile_from_buckets(self.boundaries, agg, q)


def quantile_from_buckets(boundaries: List[float], bucket_counts: List[int],
                          q: float) -> Optional[float]:
    """histogram_quantile: walk cumulative counts to the target rank,
    linear-interpolate within the containing bucket. The +Inf bucket
    clamps to the highest finite bound (as Prometheus does)."""
    total = sum(bucket_counts)
    if total <= 0 or not boundaries:
        return None
    rank = max(0.0, min(1.0, q)) * total
    cum = 0
    for i, c in enumerate(bucket_counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(boundaries):
                return float(boundaries[-1])
            lo = boundaries[i - 1] if i >= 1 else 0.0
            frac = (rank - (cum - c)) / c
            return lo + (boundaries[i] - lo) * frac
    return float(boundaries[-1])


def collect_deltas() -> List[dict]:
    """Drain pending deltas from every live metric (TelemetryAgent)."""
    with _registry_lock:
        metrics = list(_registry)
    out = []
    for m in metrics:
        p = m._collect()
        if p:
            out.append(p)
    return out


def merge_payload(base: Optional[dict], delta: dict) -> dict:
    """Merge one delta payload into the stored KV payload (GCS-side):
    counter series sum value/count, gauges take the last write,
    histograms add sum/count/bucket-wise (`value` kept as the mean so
    pre-batching readers of the payload still work)."""
    kind = delta.get("kind", "gauge")
    if base is None or base.get("kind") != kind:
        base = {"kind": kind, "description": delta.get("description", ""),
                "series": []}
    if delta.get("description"):
        base["description"] = delta["description"]
    if delta.get("boundaries"):
        base["boundaries"] = delta["boundaries"]
    index = {tuple(sorted(s.get("tags", {}).items())): s
             for s in base["series"]}
    for s in delta.get("series", []):
        key = tuple(sorted(s.get("tags", {}).items()))
        cur = index.get(key)
        if cur is None:
            cur = {"tags": dict(s.get("tags", {})), "value": 0.0, "count": 0}
            if kind == "histogram":
                cur["sum"] = 0.0
                cur["buckets"] = []
            base["series"].append(cur)
            index[key] = cur
        if kind == "counter":
            cur["value"] += s.get("value", 0.0)
            cur["count"] += s.get("count", 0)
        elif kind == "histogram":
            cur["sum"] += s.get("sum", 0.0)
            cur["count"] += s.get("count", 0)
            db = s.get("buckets", [])
            if len(cur["buckets"]) < len(db):
                cur["buckets"] += [0] * (len(db) - len(cur["buckets"]))
            for i, c in enumerate(db):
                cur["buckets"][i] += c
            cur["value"] = cur["sum"] / cur["count"] if cur["count"] else 0.0
        else:  # gauge: last write wins
            cur["value"] = s.get("value", 0.0)
    base["ts"] = time.time()
    return base


def _labels(tags: Dict[str, str],
            extra: Optional[Tuple[str, str]] = None) -> str:
    items = sorted(tags.items())
    if extra:
        items.append(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def render_prometheus(name: str, data: dict) -> List[str]:
    """Exposition lines for one metric's KV payload (shared by
    prometheus_text and the dashboard /metrics endpoint). Histograms
    emit conformant cumulative `_bucket{le=...}` series ending at +Inf
    plus `_sum`/`_count`."""
    lines = []
    kind = data.get("kind", "gauge")
    if data.get("description"):
        lines.append(f"# HELP {name} {data['description']}")
    lines.append(f"# TYPE {name} {kind}")
    bounds = data.get("boundaries", [])
    for s in data.get("series", []):
        tags = s.get("tags", {})
        if kind == "histogram" and s.get("buckets"):
            cum = 0
            for i, c in enumerate(s["buckets"]):
                cum += c
                le = ("%g" % bounds[i]) if i < len(bounds) else "+Inf"
                lines.append(f'{name}_bucket{_labels(tags, ("le", le))} {cum}')
            lines.append(f"{name}_sum{_labels(tags)} {s.get('sum', 0.0)}")
            lines.append(f"{name}_count{_labels(tags)} {s.get('count', 0)}")
        else:
            lines.append(f"{name}{_labels(tags)} {s['value']}")
    return lines


def prometheus_text() -> str:
    """Render all reported metrics in Prometheus exposition format
    (ref: metrics_agent.py Prometheus export). Flushes this process's
    TelemetryAgent first so just-recorded values are visible
    (read-your-writes)."""
    runtime = rt.get_runtime()
    agent = getattr(runtime, "telemetry", None)
    if agent is not None:
        agent.flush(wait=True)
    lines = []
    for key in sorted(runtime.gcs_call("kv_keys", ns="metrics")):
        raw = runtime.kv_get("metrics", key)
        if raw is None:
            continue
        lines.extend(render_prometheus(key.decode(), json.loads(raw)))
    return "\n".join(lines) + "\n"
