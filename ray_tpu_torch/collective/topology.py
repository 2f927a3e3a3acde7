"""Group topology: which ranks share a node, and how that maps onto the
mesh axis hierarchy.

Host collectives have two bandwidth domains, exactly like the device
mesh in ``ray_tpu_torch.parallel.mesh``:

- **intra-node** — ranks on the same host exchange through the shared
  shm object store (ICI-adjacent in mesh terms: cheap, wide);
- **inter-node** — ranks on different hosts pay the TCP xfer plane
  (DCN in mesh terms: the axis to economize).

``Topology`` is built once at group init from each rank's GCS node id
(``ray_tpu_torch.get_runtime_context().get_node_id()``) and drives the
hierarchical backend: intra-node traffic is unconstrained, inter-node
traffic is restricted to one leader per node. ``mesh_axis_map`` states
the correspondence with the device-mesh vocabulary so callers that
already hold a mesh can sanity-check that their host group matches the
slice layout (outer/DCN-tolerant axes ↔ inter-node, inner/ICI axes ↔
intra-node — same recipe as ``build_hybrid_mesh``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ray_tpu_torch.parallel.mesh import AXIS_ORDER

#: Mesh axes that tolerate the slow domain (cross-slice DCN ≈ inter-node
#: host traffic) vs. the axes that must stay in the fast domain
#: (ICI ≈ same-host shm). Mirrors DCNSpec's dp/pp-only contract.
DCN_TOLERANT_AXES: Tuple[str, ...] = ("dp", "pp")
ICI_AXES: Tuple[str, ...] = tuple(a for a in AXIS_ORDER
                                  if a not in DCN_TOLERANT_AXES)


@dataclass(frozen=True)
class Topology:
    """Node grouping of a collective group's ranks.

    Attributes:
        world_size: total ranks.
        node_of_rank: rank -> node id (hex string).
        nodes: node ids in deterministic order (sorted by lowest member
            rank, so every rank derives the identical structure).
        members: node id -> sorted ranks on that node.
        leaders: node id -> lowest rank on that node (the rank that
            speaks for the node on the inter-node ring).
    """

    world_size: int
    node_of_rank: Dict[int, str]
    nodes: Tuple[str, ...] = field(default=())
    members: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    leaders: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def build(cls, node_of_rank: Dict[int, str]) -> "Topology":
        world = len(node_of_rank)
        members: Dict[str, List[int]] = {}
        for rank in sorted(node_of_rank):
            members.setdefault(node_of_rank[rank], []).append(rank)
        nodes = tuple(sorted(members, key=lambda n: members[n][0]))
        return cls(
            world_size=world,
            node_of_rank=dict(node_of_rank),
            nodes=nodes,
            members={n: tuple(r) for n, r in members.items()},
            leaders={n: members[n][0] for n in nodes},
        )

    # -- queries --------------------------------------------------------

    def node_of(self, rank: int) -> str:
        return self.node_of_rank[rank]

    def peers_on_node(self, rank: int) -> Tuple[int, ...]:
        return self.members[self.node_of(rank)]

    def leader_of(self, rank: int) -> int:
        return self.leaders[self.node_of(rank)]

    def is_leader(self, rank: int) -> bool:
        return self.leader_of(rank) == rank

    def leader_ranks(self) -> Tuple[int, ...]:
        """Leaders in node order — the inter-node ring membership."""
        return tuple(self.leaders[n] for n in self.nodes)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def multi_node(self) -> bool:
        return len(self.nodes) > 1

    # -- mesh mapping ---------------------------------------------------

    def mesh_axis_map(self) -> Dict[str, Dict[str, object]]:
        """Map the topology onto the device-mesh axis hierarchy.

        Returns {"inter_node": {...}, "intra_node": {...}} where each
        scope names its size and the mesh axes whose collectives belong
        in that bandwidth domain. A host group backing a hybrid mesh
        should keep the inter_node factor aligned with the mesh's
        DCN-tolerant axes (dp/pp) — same invariant DCNSpec enforces for
        device collectives.
        """
        intra_sizes = {len(self.members[n]) for n in self.nodes}
        return {
            "inter_node": {"size": self.num_nodes,
                           "axes": list(DCN_TOLERANT_AXES)},
            "intra_node": {"size": (max(intra_sizes) if intra_sizes else 0),
                           "uniform": len(intra_sizes) <= 1,
                           "axes": list(ICI_AXES)},
        }

    def compatible_with_mesh(self, mesh) -> bool:
        """True if the inter-node factor divides the mesh's DCN-tolerant
        axis product — i.e. this host group can carry the mesh's
        cross-slice exchanges without putting an ICI-only axis on DCN."""
        try:
            dcn_product = 1
            for a in DCN_TOLERANT_AXES:
                dcn_product *= int(mesh.shape[a])
        except Exception:
            return False
        return self.num_nodes <= 1 or dcn_product % self.num_nodes == 0
