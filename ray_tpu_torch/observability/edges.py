"""Per-edge transfer telemetry: EWMA latency/bandwidth model.

Every measured transfer — an object-store pull
(core/runtime.py:_fetch_from_locations) or a collective transport round
(collective/group.py recv) — records `(src_node, dst_node, nbytes,
seconds)` through the local TelemetryAgent; the GCS folds the
observations into one EdgeModel per directed topology edge. This is the
measured model the collective auto-selector and locality-aware output
placement need (ROADMAP) instead of static world-size thresholds — the
reference's PushManager/PullManager flow control learns the same thing
implicitly from in-flight chunk timing (src/ray/object_manager/).

This module stays import-light (no runtime import at module scope): the
GCS process imports EdgeModel without dragging in the client runtime.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

# Smoothing factor: ~the last 8 observations dominate, so the model
# tracks congestion shifts within one bench sweep but a single outlier
# round does not whipsaw the auto-selector.
EWMA_ALPHA = 0.25

# Size bands for the two EWMAs. A transfer below LAT_BAND_BYTES is
# latency-dominated: its duration estimates the per-hop fixed cost, but
# bytes/seconds on it is rendezvous noise, not link bandwidth. A
# transfer at/above BW_BAND_BYTES is bytes-dominated: its rate estimates
# bandwidth, but folding its duration into the latency EWMA would charge
# every future small hop a megabyte's copy time. Mid-band transfers
# update neither EWMA (they still count toward totals); consumers fall
# back to class priors per-component when a band has no observations yet
# (collective/cost.py:_edge_link).
LAT_BAND_BYTES = 64 * 1024
BW_BAND_BYTES = 256 * 1024


class EdgeModel:
    """EWMA latency/bandwidth per directed (src_node, dst_node) edge."""

    def __init__(self, alpha: float = EWMA_ALPHA):
        self.alpha = alpha
        self._edges: Dict[Tuple[str, str], dict] = {}

    def observe(self, src: Optional[str], dst: Optional[str], nbytes: float,
                seconds: float, kind: str = "transfer") -> None:
        if not src or not dst or seconds is None or seconds < 0:
            return
        e = self._edges.get((src, dst))
        if e is None:
            e = {"src": src, "dst": dst, "count": 0, "bytes_total": 0.0,
                 "seconds_total": 0.0, "latency_ewma_s": None,
                 "bandwidth_ewma_bps": None, "last_ts": 0.0, "kinds": {}}
            self._edges[(src, dst)] = e
        e["count"] += 1
        e["bytes_total"] += float(nbytes)
        e["seconds_total"] += float(seconds)
        e["kinds"][kind] = e["kinds"].get(kind, 0) + 1
        e["last_ts"] = time.time()
        a = self.alpha
        if nbytes < LAT_BAND_BYTES:
            prev_lat = e["latency_ewma_s"]
            e["latency_ewma_s"] = (
                float(seconds) if prev_lat is None
                else a * float(seconds) + (1 - a) * prev_lat)
        if nbytes >= BW_BAND_BYTES and nbytes > 0 and seconds > 0:
            bw = float(nbytes) / float(seconds)
            prev_bw = e["bandwidth_ewma_bps"]
            e["bandwidth_ewma_bps"] = (bw if prev_bw is None
                                       else a * bw + (1 - a) * prev_bw)

    def stats(self) -> Dict[str, dict]:
        """JSON-able snapshot keyed "src->dst"."""
        return {f"{s}->{d}": dict(e, kinds=dict(e["kinds"]))
                for (s, d), e in self._edges.items()}


def record_transfer(src_node: str, dst_node: str, nbytes: float,
                    seconds: float, kind: str = "transfer") -> None:
    """Fire-and-forget observation from anywhere in-process (collective
    rounds, object pulls). No-op without a live runtime; never raises —
    telemetry must not fail the transfer it measures."""
    from ray_tpu_torch.core import runtime as rt

    r = rt.current_runtime_or_none()
    agent = getattr(r, "telemetry", None) if r is not None else None
    if agent is None:
        return
    try:
        agent.record_edge(str(src_node), str(dst_node), float(nbytes),
                          float(seconds), kind)
    except Exception:
        pass


def edge_stats() -> Dict[str, dict]:
    """Cluster-wide per-edge model (read-your-writes: flushes this
    process's agent first)."""
    from ray_tpu_torch.core import runtime as rt

    r = rt.get_runtime()
    agent = getattr(r, "telemetry", None)
    if agent is not None:
        agent.flush(wait=True)
    return r.gcs_call("edge_stats")
