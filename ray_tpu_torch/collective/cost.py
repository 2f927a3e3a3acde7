"""Measured per-op backend cost model (the ``"auto"`` selector's brain).

Replaces the old static world-size thresholds: each backend's round is
priced as ``hops × edge latency + bytes / edge bandwidth`` over the
group's topology edges, using the GCS-folded ``observability/edges``
EWMA model where an edge has warmed up and priors where it hasn't. The
gather funnel is priced from the group's own measured coordinator EWMA
(group.py `_observe_coord`) the same way.

Determinism contract: every rank must dispatch the same backend for the
same op, but edge-stat snapshots differ per rank — so ranks never call
this independently for dispatch. Rank 0 computes the choice and
broadcasts it through the coordinator (api.GroupClient._agree); this
module itself is pure and deterministic in its inputs.

Priors were calibrated against BENCH_collective.json on the 1-vCPU dev
box (the same one the acceptance sweep runs on); they only matter until
the first few rounds warm the EWMAs.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

#: (latency_s, bandwidth_Bps) priors per link class, pre-warmup.
PRIOR_INTRA = (2.0e-3, 400e6)      # same-node mailbox hop / shm pull
PRIOR_INTER = (3.0e-3, 120e6)      # cross-node nodelet pull
PRIOR_COORD_LAT_S = 1.0e-3         # coordinator rendezvous RTT
PRIOR_COORD_BW_BPS = 250e6         # funnel serialization through one proc
#: Fixed per-contribution cost at the coordinator (arg unpack + slot
#: bookkeeping) — what makes gather O(N) even at zero bytes.
MSG_OVERHEAD_S = 2.0e-4
#: Payload stand-in for ops whose payload size is unknowable at selection
#: time (allgather/broadcast of arbitrary objects, barrier tokens).
NOMINAL_PAYLOAD_BYTES = 64 * 1024
#: An edge below this many EWMA observations still uses priors.
MIN_EDGE_OBS = 3

_CANDIDATES = ("gather", "ring", "hier")


def payload_bucket(nbytes: Optional[int]) -> int:
    """log2 size bucket for decision caching (-1 = size-free ops).
    Coarse on purpose: one measured agreement round covers every payload
    within 2x, and all ranks derive the same bucket from the same
    (contract-identical) payload shape."""
    if nbytes is None:
        return -1
    return max(0, int(nbytes).bit_length() - 1)


def _edge_link(edges: Optional[Dict[str, dict]], src: str,
               dst: str) -> Tuple[float, float, bool]:
    """(latency_s, bandwidth_Bps, measured?) for one directed edge,
    falling back to the reverse direction, then to class priors."""
    p_lat, p_bw = PRIOR_INTRA if src == dst else PRIOR_INTER
    for key in (f"{src}->{dst}", f"{dst}->{src}"):
        e = (edges or {}).get(key)
        if not e or e.get("count", 0) < MIN_EDGE_OBS:
            continue
        lat = e.get("latency_ewma_s")
        bw = e.get("bandwidth_ewma_bps")
        # The EWMAs are size-banded (observability/edges.py): an edge
        # that only carried bulk transfers has measured bandwidth but no
        # measured latency (and vice versa) — fall back per-component.
        if (lat and lat > 0) or (bw and bw > 0):
            return (float(lat) if lat and lat > 0 else p_lat,
                    float(bw) if bw and bw > 0 else p_bw, True)
    return p_lat, p_bw, False


def _worst_link(edges, topology, ranks) -> Tuple[float, float, int]:
    """Worst (max latency, min bandwidth) over a ring's consecutive
    edges — a ring round is gated by its slowest hop."""
    if topology is None or not ranks:
        lat, bw = PRIOR_INTRA
        return lat, bw, 0
    worst_lat, worst_bw, measured = 0.0, math.inf, 0
    for i, r in enumerate(ranks):
        src = topology.node_of(r)
        dst = topology.node_of(ranks[(i + 1) % len(ranks)])
        lat, bw, m = _edge_link(edges, src, dst)
        worst_lat = max(worst_lat, lat)
        worst_bw = min(worst_bw, bw)
        measured += int(m)
    return worst_lat, worst_bw, measured


def predict_costs(op: str, world_size: int, topology,
                  payload_bytes: Optional[int] = None, *,
                  edges: Optional[Dict[str, dict]] = None,
                  coord_lat: Optional[float] = None,
                  coord_bw: Optional[float] = None) -> Tuple[Dict[str, float], int]:
    """Predicted seconds per backend for one round of `op`, plus how many
    topology links were priced from measurements (0 = pure priors)."""
    n = max(1, int(world_size))
    p = float(payload_bytes if payload_bytes is not None
              else NOMINAL_PAYLOAD_BYTES)
    c_lat = coord_lat if coord_lat and coord_lat > 0 else PRIOR_COORD_LAT_S
    c_bw = coord_bw if coord_bw and coord_bw > 0 else PRIOR_COORD_BW_BPS
    ranks = list(range(n))
    lat, bw, measured = _worst_link(edges, topology, ranks)
    depth = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    # Co-located ranks share one memory system: a ring step's "parallel"
    # chunk copies all cross the same shm, so the effective bytes moved
    # per step scale with ranks-per-node. This is what lets a funnel
    # (gather/hier) beat the ring inside a node despite moving the same
    # total bytes — it does so in O(1) rounds instead of O(N).
    leaders: list = []
    m_loc = 1
    if topology is not None and n > 1:
        leaders = list(topology.leader_ranks())
        m_loc = max(1, max(len(topology.peers_on_node(rk))
                           for rk in leaders))
        m_loc = min(m_loc, n)

    # --- gather: one rendezvous RTT, funnel serializes world×bytes ------
    base = 2 * c_lat + n * MSG_OVERHEAD_S
    if op in ("allreduce", "reducescatter"):
        g = base + (2 * n * p) / c_bw
    elif op == "allgather":
        g = base + (n * p + n * n * p) / c_bw      # replies carry N×P each
    elif op == "broadcast":
        g = base + (p + n * p) / c_bw
    else:                                          # barrier
        g = base

    # --- ring: 2(N-1) hops of P/N (tree for latency-bound ops);
    # bytes contend m_loc-wide inside a shared-memory domain ------------
    if n == 1:
        r = 0.0
    elif op == "allreduce":
        r = 2 * (n - 1) * (lat + m_loc * (p / n) / bw)
    elif op == "reducescatter":
        r = (n - 1) * (lat + m_loc * (p / n) / bw)
    elif op == "allgather":
        r = (n - 1) * (lat + m_loc * p / bw)
    elif op == "broadcast":
        r = depth * (lat + p / bw)
    else:                                          # tree barrier: up+down
        r = 2 * depth * lat

    # --- hier: intra funnel + leader ring over the slow domain ----------
    if topology is not None and n > 1:
        num_nodes = max(1, len(leaders))
        m = m_loc
        i_lat, i_bw, i_meas = _edge_link(
            edges, topology.node_of(ranks[0]), topology.node_of(ranks[0]))
        x_lat, x_bw, _ = _worst_link(edges, topology, leaders)
        measured = max(measured, i_meas)
        # Per-member rendezvous work at the funnel leader (mailbox
        # put/take handling) does not parallelize across co-located
        # senders — they share the node's cores — so each extra member
        # costs roughly half a measured intra hop on top of its bytes.
        rdv = (m - 1) * i_lat / 2
        if op in ("allreduce", "reducescatter"):
            # members land concurrently in the leader's mailbox: the
            # serial cost is the leader ingesting (m-1)·P (reduce) and
            # emitting it back (broadcast) — 2 rounds, not 2(m-1) hops
            h = 2 * (i_lat + (m - 1) * p / i_bw + rdv + m * MSG_OVERHEAD_S)
            if num_nodes > 1:
                h += 2 * (num_nodes - 1) * (x_lat + (p / num_nodes) / x_bw)
        elif op == "allgather":
            h = (m - 1) * (i_lat + p / i_bw) + rdv
            if num_nodes > 1:
                h += (num_nodes - 1) * (x_lat + m * p / x_bw)
            h += (m - 1) * (i_lat + n * p / i_bw) + rdv
        elif op == "broadcast":
            h = depth * (lat + p / bw)             # same tree as ring
        else:
            h = 2 * depth * lat
    else:
        h = r

    return {"gather": g, "ring": r, "hier": h}, measured


def choose_backend(op: str, world_size: int, topology,
                   payload_bytes: Optional[int] = None, *,
                   edges: Optional[Dict[str, dict]] = None,
                   coord_lat: Optional[float] = None,
                   coord_bw: Optional[float] = None) -> Tuple[str, dict]:
    """(backend name, decision info) — the info dict is what group stats
    and the timeline span args expose."""
    costs, measured = predict_costs(
        op, world_size, topology, payload_bytes,
        edges=edges, coord_lat=coord_lat, coord_bw=coord_bw)
    # stable tie-break: candidate order is fixed, min() keeps the first
    name = min(_CANDIDATES, key=lambda k: costs[k])
    return name, {
        "backend": name,
        "costs_ms": {k: round(v * 1e3, 4) for k, v in costs.items()},
        "payload_bytes": payload_bytes,
        "measured_links": measured,
        "source": "measured" if measured else "priors",
    }
