"""Standalone scheduling-policy suite.

Reference: src/ray/raylet/scheduling/policy/ — the pluggable node-picking
policies behind ClusterResourceScheduler::GetBestSchedulableNode
(cluster_resource_scheduler.cc:129):

- HybridPolicy     (hybrid_scheduling_policy.{h,cc}: two-tier
                    available/feasible ranking, critical-resource
                    utilization score truncated below the spread
                    threshold, preferred-node priority, uniform pick
                    among the top-k best)
- SpreadPolicy     (scheduling_policy spread: round-robin)
- RandomPolicy     (random_scheduling_policy)
- NodeAffinityPolicy (node_affinity_scheduling_policy: hard/soft)
- pack_bundles     (bundle_scheduling_policy.cc: placement-group bundle
                    packing for PACK / SPREAD / STRICT_PACK /
                    STRICT_SPREAD)

Pure functions over a snapshot of node states — no GCS/nodelet coupling,
so the suite is unit-testable exactly like the reference's
scheduling_policy_test.cc / hybrid_scheduling_policy_test.cc. The GCS
spillback RPC (`gcs.py rpc_pick_node`) and placement-group scheduler
drive these.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.common import ResourceSet


def _id_key(node_id) -> str:
    """Stable sort key for node ids (plain strings in tests, NodeID
    objects — which define no ordering — in the live GCS)."""
    h = getattr(node_id, "hex", None)
    return h() if callable(h) else str(node_id)


@dataclass
class SchedNode:
    """One node's view for a scheduling decision."""
    node_id: str
    total: ResourceSet
    available: ResourceSet
    alive: bool = True

    def feasible_for(self, request: ResourceSet) -> bool:
        """Could EVER run the request (capacity check; ref:
        IsNodeFeasible — total, not currently-available)."""
        return self.alive and request.fits_in(self.total)

    def available_for(self, request: ResourceSet) -> bool:
        return self.alive and request.fits_in(self.available)


def critical_utilization(node: SchedNode) -> float:
    """Max over resources of used/total (ref: NodeResources::
    CalculateCriticalResourceUtilization — memory/object-store style
    resources count too; zero-capacity resources are skipped)."""
    worst = 0.0
    for k, total in node.total.quantities.items():
        if total <= 0:
            continue
        avail = node.available.quantities.get(k, 0.0)
        worst = max(worst, 1.0 - avail / total)
    return worst


def hybrid_score(node: SchedNode, spread_threshold: float) -> float:
    """Utilization truncated to 0 below the threshold — nodes under the
    threshold tie at 0 so the deterministic id order packs onto them,
    past it the least-utilized wins (ref: ComputeNodeScoreImpl)."""
    u = critical_utilization(node)
    return 0.0 if u < spread_threshold else u


class HybridPolicy:
    """ref: hybrid_scheduling_policy.cc ScheduleImpl. Two-tier ranking
    (available nodes always beat merely-feasible ones), score ties
    broken by node id for determinism, preferred node short-circuits
    when it holds the best score, then a uniform pick among the top-k."""

    def __init__(self, spread_threshold: float = 0.5,
                 top_k_absolute: int = 1, top_k_fraction: float = 0.2,
                 seed: Optional[int] = None):
        self.spread_threshold = spread_threshold
        self.top_k_absolute = top_k_absolute
        self.top_k_fraction = top_k_fraction
        self._rng = random.Random(seed)

    def schedule(self, request: ResourceSet, nodes: Sequence[SchedNode],
                 preferred_node_id: Optional[str] = None,
                 require_node_available: bool = True,
                 force_spillback: bool = False) -> Optional[str]:
        available: List[Tuple[str, float]] = []
        feasible: List[Tuple[str, float]] = []
        preferred_available = preferred_feasible = False
        preferred_score = float("inf")
        for node in nodes:
            if force_spillback and node.node_id == preferred_node_id:
                continue
            if not node.feasible_for(request):
                continue
            score = hybrid_score(node, self.spread_threshold)
            is_avail = node.available_for(request)
            if node.node_id == preferred_node_id:
                preferred_feasible = True
                preferred_available = is_avail
                preferred_score = score
            (available if is_avail else feasible).append(
                (node.node_id, score))
        k = max(self.top_k_absolute,
                int(len(nodes) * self.top_k_fraction))
        if available:
            prefer = (not force_spillback) and preferred_available
            return self._best(available, k,
                              preferred_node_id if prefer else None,
                              preferred_score)
        if feasible and not require_node_available:
            prefer = (not force_spillback) and preferred_feasible
            return self._best(feasible, k,
                              preferred_node_id if prefer else None,
                              preferred_score)
        return None

    def _best(self, scored: List[Tuple[str, float]], k: int,
              preferred_node_id: Optional[str],
              preferred_score: float) -> str:
        # id sort first so equal scores resolve identically every time
        scored.sort(key=lambda p: _id_key(p[0]))
        scored.sort(key=lambda p: p[1])          # stable on score
        if preferred_node_id is not None and \
                preferred_score <= scored[0][1]:
            return preferred_node_id
        return scored[self._rng.randrange(min(k, len(scored)))][0]


class SpreadPolicy:
    """Round-robin over feasible+available nodes in id order (ref:
    scheduling_policy.cc Spread — rotates a starting offset)."""

    def __init__(self):
        self._next = 0

    def schedule(self, request: ResourceSet,
                 nodes: Sequence[SchedNode]) -> Optional[str]:
        cands = sorted((n.node_id for n in nodes
                        if n.available_for(request)), key=_id_key)
        if not cands:
            return None
        choice = cands[self._next % len(cands)]
        self._next += 1
        return choice


class RandomPolicy:
    """Uniform over available nodes (ref: random_scheduling_policy.cc)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def schedule(self, request: ResourceSet,
                 nodes: Sequence[SchedNode]) -> Optional[str]:
        cands = [n.node_id for n in nodes if n.available_for(request)]
        return self._rng.choice(cands) if cands else None


class NodeAffinityPolicy:
    """Pin to one node; `soft` falls back to hybrid when it's gone
    (ref: node_affinity_scheduling_policy.cc)."""

    def __init__(self, node_id: str, soft: bool = False,
                 fallback: Optional[HybridPolicy] = None):
        self.node_id = node_id
        self.soft = soft
        self.fallback = fallback or HybridPolicy()

    def schedule(self, request: ResourceSet,
                 nodes: Sequence[SchedNode]) -> Optional[str]:
        for node in nodes:
            if node.node_id == self.node_id and \
                    node.available_for(request):
                return node.node_id
        if self.soft:
            return self.fallback.schedule(request, nodes)
        return None


# --- placement-group bundle packing ------------------------------------------


def pack_bundles(bundles: Sequence[ResourceSet],
                 nodes: Sequence[SchedNode], strategy: str,
                 exclude_nodes: Optional[set] = None
                 ) -> Optional[List[str]]:
    """Assign every bundle to a node per the PG strategy, or None if the
    gang can't be placed (all-or-nothing, like the reference's 2PC
    prepare phase; ref: bundle_scheduling_policy.cc
    BundlePackSchedulingPolicy / BundleSpreadSchedulingPolicy /
    BundleStrictPackSchedulingPolicy / BundleStrictSpreadSchedulingPolicy).

    Returns a node_id per bundle. Capacity is tracked against a scratch
    copy of each node's availability so multi-bundle-per-node packing is
    honest."""
    scratch: Dict[str, ResourceSet] = {}
    by_id: Dict[str, SchedNode] = {}
    for n in sorted(nodes, key=lambda n: _id_key(n.node_id)):
        if not n.alive or (exclude_nodes and n.node_id in exclude_nodes):
            continue
        scratch[n.node_id] = n.available.copy()
        by_id[n.node_id] = n

    def fits(nid: str, req: ResourceSet) -> bool:
        return req.fits_in(scratch[nid])

    def take(nid: str, req: ResourceSet):
        scratch[nid].subtract(req)

    if strategy == "STRICT_PACK":
        # every bundle on ONE node
        for nid in scratch:
            s = scratch[nid].copy()
            ok = True
            for b in bundles:
                if b.fits_in(s):
                    s.subtract(b)
                else:
                    ok = False
                    break
            if ok:
                return [nid] * len(bundles)
        return None

    # sort bundles largest-first for better first-fit packing (ref:
    # bundle_scheduling_policy.cc sorts by resource size descending)
    order = sorted(range(len(bundles)),
                   key=lambda i: -sum(bundles[i].quantities.values()))
    placement: List[Optional[str]] = [None] * len(bundles)

    if strategy in ("STRICT_SPREAD", "SPREAD"):
        used: set = set()
        for i in order:
            b = bundles[i]
            fresh = [nid for nid in scratch
                     if nid not in used and fits(nid, b)]
            reuse = [nid for nid in scratch
                     if nid in used and fits(nid, b)]
            if fresh:
                nid = min(fresh,
                          key=lambda x: critical_utilization(by_id[x]))
            elif reuse and strategy == "SPREAD":
                nid = min(reuse,
                          key=lambda x: critical_utilization(by_id[x]))
            else:
                return None          # STRICT_SPREAD: distinct or fail
            placement[i] = nid
            used.add(nid)
            take(nid, b)
        return placement  # type: ignore[return-value]

    # PACK: minimize node count — first-fit onto already-used nodes
    used_order: List[str] = []
    for i in order:
        b = bundles[i]
        nid = next((u for u in used_order if fits(u, b)), None)
        if nid is None:
            fresh = [n for n in scratch if fits(n, b)]
            if not fresh:
                return None
            # least-utilized fresh node hosts the next clique
            nid = min(fresh, key=lambda x: critical_utilization(by_id[x]))
            used_order.append(nid)
        placement[i] = nid
        take(nid, b)
    return placement  # type: ignore[return-value]
