"""Backend registry + auto-selection policy.

Backends are factories taking a ``GroupContext`` and returning an object
with the op surface (allreduce/allgather/broadcast/reducescatter/
barrier). Third parties can plug in via ``register_backend`` — e.g. a
future RDMA or grpc transport — without touching the API layer.

``"auto"`` prices each candidate backend with the measured cost model
(cost.py: hops × edge latency + bytes / edge bandwidth from the
observability/edges EWMA stats, priors until edges warm) and picks the
cheapest — small payloads still land on ``gather`` (one coordinator RTT
beats 2(N−1) ring hops when latency dominates), bulk multi-node on
``hier`` (only node leaders pay the inter-node price), bulk single-node
on ``ring`` — but now because the model says so on this cluster, not
because a static world-size threshold guessed it.

Selection inputs must be identical on every rank: ``select_backend``
here is deterministic in its arguments, and the dispatch path
(api.GroupClient) has rank 0 compute the choice with ITS edge snapshot
and broadcast it, so per-rank snapshot drift can never split a group
across backends.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

#: Historic small-payload cutoff; still the default of the Config knob
#: ``collective_eager_threshold_bytes`` (the inline-transport tier), no
#: longer a backend-selection threshold.
SMALL_PAYLOAD_BYTES = 64 * 1024

_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str, factory: Callable) -> None:
    _BACKENDS[name] = factory


def get_backend_factory(name: str) -> Callable:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown collective backend {name!r}; "
            f"available: {sorted(_BACKENDS)}") from None


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


def _register_defaults() -> None:
    from ray_tpu_torch.collective.gather import GatherBackend
    from ray_tpu_torch.collective.hier import HierBackend
    from ray_tpu_torch.collective.ring import RingBackend

    register_backend("gather", GatherBackend)
    register_backend("ring", RingBackend)
    register_backend("hier", HierBackend)


_register_defaults()


def select_backend(op: str, world_size: int, topology,
                   payload_bytes: Optional[int] = None,
                   edges: Optional[Dict[str, dict]] = None) -> str:
    """Resolve "auto" to a concrete backend name for one op call by
    pricing the candidates (cost.py). Deterministic in its arguments;
    pass the same `edges` snapshot on every rank (or let the api layer's
    rank-0 agreement round do it for you)."""
    from ray_tpu_torch.collective import cost

    name, _ = cost.choose_backend(op, world_size, topology, payload_bytes,
                                  edges=edges)
    return name
