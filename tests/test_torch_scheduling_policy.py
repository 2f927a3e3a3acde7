"""Standalone scheduling-policy suite tests (ref: the reference's
src/ray/raylet/scheduling/policy/scheduling_policy_test.cc and
hybrid_scheduling_policy_test.cc — pure decisions over node snapshots,
no cluster).

Port of tests/test_scheduling_policy.py, aimed at ray_tpu_torch.
"""

import numpy as np
import pytest

from ray_tpu_torch.core.common import ResourceSet
from ray_tpu_torch.core.scheduling_policy import (HybridPolicy, NodeAffinityPolicy,
                                            RandomPolicy, SchedNode,
                                            SpreadPolicy,
                                            critical_utilization,
                                            hybrid_score, pack_bundles)
from torch_runtime_support import reap_orphans  # noqa: F401


def node(nid, total, avail=None, alive=True):
    return SchedNode(node_id=nid, total=ResourceSet(dict(total)),
                     available=ResourceSet(dict(avail if avail is not None
                                                else total)), alive=alive)


R = lambda **kw: ResourceSet({k: float(v) for k, v in kw.items()})


# --- scoring -----------------------------------------------------------------


def test_critical_utilization_is_max_over_resources():
    n = node("a", {"CPU": 4, "GPU": 8}, {"CPU": 3, "GPU": 2})
    assert np.isclose(critical_utilization(n), 0.75)   # GPU 6/8 used
    # zero-capacity resources are skipped
    n2 = node("b", {"CPU": 4, "pg_x": 0}, {"CPU": 4, "pg_x": 0})
    assert critical_utilization(n2) == 0.0


def test_hybrid_score_truncates_below_threshold():
    n = node("a", {"CPU": 10}, {"CPU": 7})     # 30% used
    assert hybrid_score(n, 0.5) == 0.0
    assert np.isclose(hybrid_score(n, 0.2), 0.3)


# --- hybrid ------------------------------------------------------------------


def test_hybrid_packs_below_threshold_by_id_order():
    """Two nodes under the threshold tie at score 0 — the deterministic
    id order must pick the same node every time (bin-packing)."""
    pol = HybridPolicy(spread_threshold=0.5, seed=0)
    nodes = [node("b", {"CPU": 4}, {"CPU": 3}),
             node("a", {"CPU": 4}, {"CPU": 3})]
    assert all(pol.schedule(R(CPU=1), nodes) == "a" for _ in range(10))


def test_hybrid_prefers_least_utilized_above_threshold():
    pol = HybridPolicy(spread_threshold=0.1, seed=0)
    nodes = [node("a", {"CPU": 10}, {"CPU": 2}),    # 80% used
             node("b", {"CPU": 10}, {"CPU": 7})]    # 30% used
    assert pol.schedule(R(CPU=1), nodes) == "b"


def test_hybrid_available_tier_beats_feasible_tier():
    """A node that could EVER fit (feasible) loses to any node that can
    fit NOW, regardless of score."""
    pol = HybridPolicy(spread_threshold=0.5)
    nodes = [node("a", {"CPU": 16}, {"CPU": 0}),    # feasible, busy
             node("b", {"CPU": 2}, {"CPU": 2})]     # available
    assert pol.schedule(R(CPU=2), nodes) == "b"
    # with require_node_available, a busy-only cluster yields None...
    assert pol.schedule(R(CPU=8), nodes) is None
    # ...unless the caller accepts queuing behind a feasible node
    assert pol.schedule(R(CPU=8), nodes,
                        require_node_available=False) == "a"


def test_hybrid_infeasible_never_selected():
    pol = HybridPolicy()
    nodes = [node("a", {"CPU": 2}, {"CPU": 2})]
    assert pol.schedule(R(CPU=4), nodes) is None
    assert pol.schedule(R(CPU=4), nodes,
                        require_node_available=False) is None


def test_hybrid_preferred_node_short_circuits_when_best():
    """The preferred (local) node wins whenever it holds the best score,
    even against equal-score peers earlier in id order."""
    pol = HybridPolicy(spread_threshold=0.5, top_k_absolute=3, seed=1)
    nodes = [node("a", {"CPU": 4}, {"CPU": 4}),
             node("z", {"CPU": 4}, {"CPU": 4})]
    assert all(pol.schedule(R(CPU=1), nodes, preferred_node_id="z") == "z"
               for _ in range(10))


def test_hybrid_force_spillback_excludes_preferred():
    pol = HybridPolicy()
    nodes = [node("local", {"CPU": 4}, {"CPU": 4}),
             node("remote", {"CPU": 4}, {"CPU": 4})]
    got = pol.schedule(R(CPU=1), nodes, preferred_node_id="local",
                       force_spillback=True)
    assert got == "remote"
    assert pol.schedule(R(CPU=1), nodes[:1], preferred_node_id="local",
                        force_spillback=True) is None


def test_hybrid_top_k_spreads_across_best_candidates():
    """With top-k > 1 and tied scores, picks distribute over the k best
    (ref: GetBestNode absl::Uniform over top-k)."""
    pol = HybridPolicy(spread_threshold=0.9, top_k_absolute=3, seed=7)
    nodes = [node(f"n{i}", {"CPU": 4}, {"CPU": 4}) for i in range(3)]
    seen = {pol.schedule(R(CPU=1), nodes) for _ in range(60)}
    assert seen == {"n0", "n1", "n2"}


def test_hybrid_dead_node_skipped():
    pol = HybridPolicy()
    nodes = [node("a", {"CPU": 4}, {"CPU": 4}, alive=False),
             node("b", {"CPU": 4}, {"CPU": 4})]
    assert pol.schedule(R(CPU=1), nodes) == "b"


# --- spread / random / affinity ---------------------------------------------


def test_spread_round_robin():
    pol = SpreadPolicy()
    nodes = [node("a", {"CPU": 4}), node("b", {"CPU": 4})]
    got = [pol.schedule(R(CPU=1), nodes) for _ in range(4)]
    assert got == ["a", "b", "a", "b"]


def test_random_uniform_over_available():
    pol = RandomPolicy(seed=3)
    nodes = [node("a", {"CPU": 4}), node("b", {"CPU": 4}),
             node("c", {"CPU": 4}, {"CPU": 0})]
    seen = {pol.schedule(R(CPU=1), nodes) for _ in range(40)}
    assert seen == {"a", "b"}


def test_node_affinity_hard_and_soft():
    nodes = [node("a", {"CPU": 4}), node("b", {"CPU": 4})]
    assert NodeAffinityPolicy("a").schedule(R(CPU=1), nodes) == "a"
    # hard affinity to a missing node fails
    assert NodeAffinityPolicy("zz").schedule(R(CPU=1), nodes) is None
    # soft affinity falls back to hybrid
    assert NodeAffinityPolicy("zz", soft=True).schedule(
        R(CPU=1), nodes) in ("a", "b")


# --- bundle packing ----------------------------------------------------------


def test_pack_minimizes_node_count():
    nodes = [node("a", {"CPU": 4}), node("b", {"CPU": 4})]
    got = pack_bundles([R(CPU=1)] * 3, nodes, "PACK")
    assert got is not None and len(set(got)) == 1


def test_pack_overflows_to_second_node():
    nodes = [node("a", {"CPU": 2}), node("b", {"CPU": 2})]
    got = pack_bundles([R(CPU=1)] * 4, nodes, "PACK")
    assert got is not None
    assert sorted(got.count(n) for n in set(got)) == [2, 2]


def test_strict_pack_all_or_nothing():
    nodes = [node("a", {"CPU": 2}), node("b", {"CPU": 4})]
    got = pack_bundles([R(CPU=1)] * 3, nodes, "STRICT_PACK")
    assert got == ["b", "b", "b"]
    assert pack_bundles([R(CPU=1)] * 5, nodes, "STRICT_PACK") is None


def test_spread_prefers_distinct_nodes_then_reuses():
    nodes = [node("a", {"CPU": 4}), node("b", {"CPU": 4})]
    got = pack_bundles([R(CPU=1)] * 3, nodes, "SPREAD")
    assert got is not None and set(got) == {"a", "b"}


def test_strict_spread_requires_distinct_nodes():
    nodes = [node("a", {"CPU": 4}), node("b", {"CPU": 4})]
    assert pack_bundles([R(CPU=1)] * 2, nodes, "STRICT_SPREAD") is not None
    assert pack_bundles([R(CPU=1)] * 3, nodes, "STRICT_SPREAD") is None
    # exclusion models bundles already placed during a retry
    assert pack_bundles([R(CPU=1)], nodes, "STRICT_SPREAD",
                        exclude_nodes={"a"}) == ["b"]


def test_pack_respects_capacity_across_bundles():
    """The scratch view must decay as bundles land — a node can't be
    double-booked past its availability."""
    nodes = [node("a", {"CPU": 2}, {"CPU": 1}), node("b", {"CPU": 2})]
    got = pack_bundles([R(CPU=1), R(CPU=2)], nodes, "PACK")
    assert got is not None
    # the 2-CPU bundle can only be on b
    assert got[1] == "b"


def test_pack_large_bundles_first():
    """Largest-first ordering: a naive in-order first-fit would strand
    the big bundle; sorting by size packs both."""
    nodes = [node("a", {"CPU": 3})]
    got = pack_bundles([R(CPU=1), R(CPU=2)], nodes, "PACK")
    assert got == ["a", "a"]


def test_bundle_infeasible_returns_none():
    nodes = [node("a", {"CPU": 2})]
    assert pack_bundles([R(CPU=8)], nodes, "PACK") is None
    assert pack_bundles([R(CPU=8)], nodes, "SPREAD") is None
