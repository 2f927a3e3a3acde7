"""Collective transport tiers (eager / mailbox / zero-copy) + the
measured cost-model auto-selection.

The transport contract: the SAME bits come out no matter which tier the
bytes rode — mailbox pickling, inline eager messages, or object-store
refs resolved through the pinned zero-copy read. Equivalence data is
integer-valued so summation is exact (see test_collective.py).

Port of tests/test_collective_transport.py, aimed at ray_tpu_torch.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.collective.topology import Topology
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def _payload(rank: int, shape, dtype=np.float64, seed=7):
    rng = np.random.default_rng(seed + rank)
    return rng.integers(-50, 50, size=shape).astype(dtype)


# --------------------------------------------------------------------------
# cost model (pure unit tests — no cluster)
# --------------------------------------------------------------------------


def _synthetic_edges(entries):
    """{(src, dst): (lat_s, bw_bps, count)} → edge_stats()-shaped dict."""
    return {f"{s}->{d}": {"src": s, "dst": d, "count": c,
                          "latency_ewma_s": lat, "bandwidth_ewma_bps": bw}
            for (s, d), (lat, bw, c) in entries.items()}


def test_cost_model_prior_selection():
    from ray_tpu_torch.collective import cost

    one = Topology.build({r: "n0" for r in range(8)})
    two = Topology.build({r: f"n{r % 2}" for r in range(8)})
    flat = Topology.build({r: f"n{r}" for r in range(8)})
    # latency-bound → gather; bulk co-located → hier (ring chunk copies
    # contend m_loc-wide for the node's shm, funnel does O(1) rounds);
    # bulk one-rank-per-node → ring (no contention, P/N per hop wins)
    assert cost.choose_backend("allreduce", 8, one, 4096)[0] == "gather"
    assert cost.choose_backend("allreduce", 8, one, 8 << 20)[0] == "hier"
    assert cost.choose_backend("allreduce", 8, flat, 8 << 20)[0] == "ring"
    # 1 MiB spanning nodes: hier's leaders-only inter traffic wins; at
    # much larger payloads its full-payload intra funnel hops catch up
    # and flat ring (P/N per hop) can rightly price cheaper
    assert cost.choose_backend("allreduce", 8, two, 1 << 20)[0] == "hier"
    assert cost.choose_backend("barrier", 8, one)[0] == "gather"
    name, info = cost.choose_backend("allreduce", 4, one, 1 << 20)
    assert info["source"] == "priors" and info["measured_links"] == 0
    assert set(info["costs_ms"]) == {"gather", "ring", "hier"}
    assert info["backend"] == name


def test_cost_model_measured_edges_flip_choice():
    from ray_tpu_torch.collective import cost

    one = Topology.build({r: "n0" for r in range(4)})
    # a measured blazing-fast intra edge makes ring beat gather even at a
    # payload where priors would pick gather
    fast = _synthetic_edges({("n0", "n0"): (1e-4, 2e9, 50)})
    n_prior, _ = cost.choose_backend("allreduce", 4, one, 48 * 1024)
    n_meas, info = cost.choose_backend("allreduce", 4, one, 48 * 1024,
                                       edges=fast)
    assert n_prior == "gather"
    assert n_meas == "ring"
    assert info["source"] == "measured" and info["measured_links"] > 0
    # ...and a measured terrible edge pushes bulk back onto the funnel
    slow = _synthetic_edges({("n0", "n0"): (0.2, 1e6, 50)})
    assert cost.choose_backend("allreduce", 4, one, 1 << 20,
                               edges=slow)[0] == "gather"


def test_cost_model_inter_node_edges_drive_hier():
    from ray_tpu_torch.collective import cost

    two = Topology.build({r: f"n{r % 2}" for r in range(8)})
    # cheap intra, expensive measured inter edges: hier (leaders-only on
    # the slow domain) must win bulk allreduce over flat ring
    edges = _synthetic_edges({
        ("n0", "n0"): (5e-4, 1e9, 50), ("n1", "n1"): (5e-4, 1e9, 50),
        ("n0", "n1"): (2e-2, 3e7, 50), ("n1", "n0"): (2e-2, 3e7, 50)})
    name, info = cost.choose_backend("allreduce", 8, two, 8 << 20,
                                     edges=edges)
    assert name == "hier"
    assert info["costs_ms"]["hier"] < info["costs_ms"]["ring"]


def test_cost_model_underwarmed_edges_fall_back_to_priors():
    from ray_tpu_torch.collective import cost

    one = Topology.build({r: "n0" for r in range(4)})
    # count below MIN_EDGE_OBS: the (absurd) measurement must be ignored.
    # Had it been honored, a 100 s hop latency would have forced every
    # p2p backend out and left gather; priors pick a p2p backend here.
    cold = _synthetic_edges({("n0", "n0"): (100.0, 1.0, cost.MIN_EDGE_OBS - 1)})
    name, info = cost.choose_backend("allreduce", 4, one, 8 << 20,
                                     edges=cold)
    assert name != "gather" and info["source"] == "priors"


def test_payload_bucket_is_log2_and_rank_agnostic():
    from ray_tpu_torch.collective.cost import payload_bucket

    assert payload_bucket(None) == -1
    assert payload_bucket(1) == 0
    assert payload_bucket(1 << 20) == payload_bucket((1 << 21) - 1) == 20
    assert payload_bucket(1 << 21) == 21


# --------------------------------------------------------------------------
# payload_nbytes fast paths (satellite: no per-send pickling)
# --------------------------------------------------------------------------


class _OddPayload:
    """Module-level so the pickle-exemplar fallback can actually pickle it."""

    def __init__(self, n):
        self.blob = b"x" * n


def test_payload_nbytes_fast_paths_and_bounded_fallback():
    from ray_tpu_torch.collective import group as g

    arr = np.zeros((4, 8), dtype=np.float32)
    assert g.payload_nbytes(arr) == arr.nbytes
    assert g.payload_nbytes(b"abcd") == 4
    assert g.payload_nbytes(memoryview(b"abcdef")) == 6
    assert g.payload_nbytes({"a": arr, "b": [b"xy", 3.0]}) == arr.nbytes + 10
    assert g.payload_nbytes((arr, arr)) == 2 * arr.nbytes
    # a zero-copy envelope is priced as the chunk it names, NOT pickled
    env = {g.ZC_KEY: True, "ref": object(), "nbytes": 12345}
    assert g.payload_nbytes(env) == 12345

    g._FALLBACK_NBYTES.pop(_OddPayload, None)
    first = g.payload_nbytes(_OddPayload(100))
    assert first > 100
    # second instance of the same type hits the per-type exemplar cache —
    # the (different) size comes back as the cached one, by design
    assert g.payload_nbytes(_OddPayload(50_000)) == first
    assert _OddPayload in g._FALLBACK_NBYTES


# --------------------------------------------------------------------------
# cross-transport bitwise equivalence + chaos (cluster)
# --------------------------------------------------------------------------


@ray_tpu_torch.remote
class Member:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def transport_run(self, backend, transport, group):
        from ray_tpu_torch import collective as col

        col.init_collective_group(self.world, self.rank, group,
                                  backend=backend, timeout_s=60,
                                  transport=transport)
        # big enough that every per-hop block clears the default
        # zero-copy threshold under transport="auto" too
        big = _payload(self.rank, (self.world * 32 * 1024,))   # world×256KiB
        out = {
            "allreduce": col.allreduce(big, group),
            "reducescatter": col.reducescatter(
                _payload(self.rank, (self.world * 4096, 2)), group),
            "broadcast": np.asarray(col.broadcast(
                _payload(0, (64 * 1024,)) if self.rank == 0 else None,
                src_rank=0, group_name=group)),
            "stats": col.group_stats(group),
        }
        col.barrier(group)
        return out

    def chaos_run(self, group, timeout_s, die_after_round1):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective import CollectiveError

        col.init_collective_group(self.world, self.rank, group,
                                  backend="ring", timeout_s=timeout_s,
                                  transport="zerocopy")
        col.allreduce(np.ones(64 * 1024), group)   # round 1: zc path, alive
        if die_after_round1:
            return {"outcome": "left"}
        t0 = time.time()
        try:
            col.allreduce(np.ones(64 * 1024), group)
            return {"outcome": "no error"}
        except CollectiveError as e:
            return {"outcome": "collective_error",
                    "elapsed": time.time() - t0,
                    "is_timeout": isinstance(e, col.CollectiveTimeoutError),
                    "suspects": e.suspect_ranks,
                    "message": str(e)}


def test_cross_transport_bitwise_equivalence(ray_start_regular):
    """mailbox / zerocopy / eager / auto produce bitwise-identical
    results for ring AND hier, and the tier counters prove each transport
    actually took its tier."""
    from ray_tpu_torch import collective as col

    world = 3
    members = [Member.options(num_cpus=0.5).remote(i, world)
               for i in range(world)]
    results = {}
    for transport in ("mailbox", "zerocopy", "eager", "auto"):
        for backend in ("ring", "hier"):
            group = f"tx_{transport}_{backend}"
            results[(transport, backend)] = ray_tpu_torch.get(
                [m.transport_run.remote(backend, transport, group)
                 for m in members], timeout=240)
            col.destroy_collective_group(group)

    ref = results[("mailbox", "ring")][0]
    for key, outs in results.items():
        for out in outs:
            assert np.array_equal(out["allreduce"], ref["allreduce"]), key
            assert np.array_equal(out["broadcast"], ref["broadcast"]), key
        for rank, out in enumerate(outs):
            total = sum(_payload(r, (world * 4096, 2)) for r in range(world))
            assert np.array_equal(
                out["reducescatter"],
                total[rank * 4096:(rank + 1) * 4096]), key

    # tier proof: zerocopy moved bulk as refs, mailbox/eager moved none
    zc = results[("zerocopy", "ring")][0]["stats"]["transfer"]
    mb = results[("mailbox", "ring")][0]["stats"]["transfer"]
    eg = results[("eager", "ring")][0]["stats"]["transfer"]
    assert zc["zc_sends"] > 0 and zc["zc_bytes_sent"] > 0
    assert mb["zc_sends"] == 0 and eg["zc_sends"] == 0
    # the three tiers + coordinator exchanges partition every send
    for t in (zc, mb, eg):
        assert t["sends"] == t["zc_sends"] + t["eager_sends"] + \
            t["coord_sends"], t
    # auto tiering: world×256KiB blocks clear the default 256KiB zc
    # threshold on the ring's per-step blocks
    au = results[("auto", "ring")][0]["stats"]["transfer"]
    assert au["zc_sends"] > 0
    tp = results[("auto", "ring")][0]["stats"]["transport"]
    assert tp["mode"] == "auto" and tp["zerocopy_threshold_bytes"] == 256 * 1024


@pytest.mark.slow
def test_zerocopy_chaos_member_death_raises(ray_start_regular):
    """Killing a rank mid-round on the ZERO-COPY path raises
    CollectiveTimeoutError naming the rank — survivors never hang on a
    never-resolved ref."""
    world, timeout_s = 3, 6.0
    members = [Member.options(num_cpus=0.5).remote(i, world)
               for i in range(world)]
    refs = [m.chaos_run.remote("zc_chaos", timeout_s,
                               die_after_round1=(i == 1))
            for i, m in enumerate(members)]
    assert ray_tpu_torch.get(refs[1], timeout=240)["outcome"] == "left"
    ray_tpu_torch.kill(members[1])
    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor("_collective_zc_chaos_mbx1"))
    except ValueError:
        pass
    survivors = ray_tpu_torch.get([refs[0], refs[2]], timeout=240)
    for out in survivors:
        assert out["outcome"] == "collective_error", out
        assert out["is_timeout"], out
        assert 1 in out["suspects"], out
        assert out["elapsed"] < 4 * timeout_s + 15, out


def test_auto_backend_agreement_and_decision_exposure(ray_start_regular):
    """backend="auto": every rank dispatches the agreed backend (rank 0's
    cost-model choice broadcast through the coordinator) and group_stats
    exposes the decision with its predicted costs."""
    from ray_tpu_torch import collective as col

    world = 3
    members = [Member.options(num_cpus=0.5).remote(i, world)
               for i in range(world)]
    outs = ray_tpu_torch.get(
        [m.transport_run.remote("auto", "auto", "auto_dec")
         for m in members], timeout=240)
    col.destroy_collective_group("auto_dec")
    decisions = [o["stats"]["decisions"] for o in outs]
    assert decisions[0], "no decisions recorded"
    for d in decisions[1:]:
        assert {k: v["backend"] for k, v in d.items()} == \
            {k: v["backend"] for k, v in decisions[0].items()}
    for dec in decisions[0].values():
        assert dec["backend"] in ("gather", "ring", "hier")
        assert dec["source"] in ("measured", "priors")
        assert set(dec["costs_ms"]) == {"gather", "ring", "hier"}
        assert dec["uses"] >= 1


# --------------------------------------------------------------------------
# regression floor: the transport rework must keep ring ≥ gather on bulk
# --------------------------------------------------------------------------


@pytest.mark.slow
def test_ring_beats_gather_at_8mib_world4(ray_start_regular):
    """The acceptance cell: 8 MiB world-4 allreduce — ring (zero-copy
    transport) must not regress below the gather funnel's throughput."""

    @ray_tpu_torch.remote(num_cpus=0.25)
    class B:
        def run(self, world, rank, group, backend, rounds):
            from ray_tpu_torch import collective as col

            col.init_collective_group(world, rank, group, backend=backend,
                                      timeout_s=180)
            x = np.ones(1 << 20, dtype=np.float64) * (rank + 1)   # 8 MiB
            col.allreduce(x, group)                               # warmup
            times = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                col.allreduce(x, group)
                times.append(time.perf_counter() - t0)
            return sorted(times)[len(times) // 2]

    world, medians = 4, {}
    for backend in ("gather", "ring"):
        group = f"reg_{backend}"
        ms = [B.remote() for _ in range(world)]
        medians[backend] = max(ray_tpu_torch.get(
            [m.run.remote(world, r, group, backend, 5)
             for r, m in enumerate(ms)], timeout=600))
        from ray_tpu_torch import collective as col

        col.destroy_collective_group(group)
        for m in ms:
            ray_tpu_torch.kill(m)
    assert medians["ring"] <= medians["gather"], medians
