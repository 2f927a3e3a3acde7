"""Placement groups: gang reservation of resource bundles.

Reference: python/ray/util/placement_group.py:34,139. TPU-specific: a bundle
that requests {"TPU": n} is a slice-gang building block — STRICT_SPREAD over
hosts of one slice reserves the whole ICI domain for an SPMD job
(SURVEY.md §7 "slice-aware gang scheduling").
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core.common import ResourceSet
from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core import runtime as rt


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    def ready(self, timeout: float = 30.0) -> bool:
        r = rt.get_runtime().gcs_call("wait_placement_group", pg_id=self.id,
                                      wait_timeout=timeout,
                                      rpc_timeout=timeout + 10.0,
                                      clamp_attempt=False)  # long-poll
        return bool(r.get("ok"))

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout_seconds)

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def table(self) -> Optional[dict]:
        return rt.get_runtime().gcs_call("get_placement_group", pg_id=self.id)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"unknown placement strategy {strategy!r}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    pg_id = PlacementGroupID.from_random()
    rt.get_runtime().gcs_call(
        "create_placement_group", pg_id=pg_id,
        bundles=[ResourceSet({k: float(v) for k, v in b.items()}) for b in bundles],
        strategy=strategy, name=name)
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    rt.get_runtime().gcs_call("remove_placement_group", pg_id=pg.id)
