"""Node OOM defense: memory monitor + worker-killing policies.

Reference: src/ray/common/memory_monitor.h:52 (MemoryMonitor polls system /
cgroup usage on a timer and fires a callback above a usage threshold) and
src/ray/raylet/worker_killing_policy_group_by_owner.h /
worker_killing_policy_retriable_fifo.h (pick which worker dies: group tasks
by owner so every owner keeps making progress, kill the newest member of
the largest group; or kill retriable tasks newest-first). The raylet kills
the chosen worker, the owner's task FSM sees the death and retries
(ray_config_def.h:74 default threshold 0.95, :100 OOM-specific retries).

TPU re-design notes: host RAM pressure matters mostly for the data/ingest
plane (Arrow blocks, spill staging); HBM pressure is handled separately by
the device-tier object accounting. The monitor therefore watches host
memory (cgroup v2 when present, else /proc/meminfo) and only ever kills
*worker* processes — never the nodelet or the store segment.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

_CGROUP_V2_USAGE = "/sys/fs/cgroup/memory.current"
_CGROUP_V2_LIMIT = "/sys/fs/cgroup/memory.max"
_CGROUP_V1_USAGE = "/sys/fs/cgroup/memory/memory.usage_in_bytes"
_CGROUP_V1_LIMIT = "/sys/fs/cgroup/memory/memory.limit_in_bytes"


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            s = f.read().strip()
        if s == "max":
            return None
        return int(s)
    except (OSError, ValueError):
        return None


def _meminfo() -> Tuple[Optional[int], Optional[int]]:
    """(used, total) from /proc/meminfo, used = total - MemAvailable."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total is not None and avail is not None:
                    break
    except OSError:
        return None, None
    if total is None or avail is None:
        return None, total
    return total - avail, total


def get_memory_usage() -> Tuple[int, int]:
    """Current (used_bytes, total_bytes) for this node.

    Prefers the cgroup limit when one is set and tighter than physical RAM
    (containerized nodes), mirroring MemoryMonitor::GetMemoryBytes.
    """
    used, total = _meminfo()
    for upath, lpath in ((_CGROUP_V2_USAGE, _CGROUP_V2_LIMIT),
                         (_CGROUP_V1_USAGE, _CGROUP_V1_LIMIT)):
        climit = _read_int(lpath)
        cused = _read_int(upath)
        if climit is not None and cused is not None and (
                total is None or climit < total):
            return cused, climit
    if used is None or total is None:
        return 0, 1
    return used, total


@dataclass
class KillCandidate:
    """What the policy knows about a running worker."""
    worker_id: bytes
    job_id: Optional[bytes]         # owner grouping key
    is_actor: bool                  # actors are never retriable w/o restarts
    retriable: bool                 # stateless tasks retry by default
    start_time: float               # lease/creation time (newest dies first)


def pick_worker_to_kill(candidates: List[KillCandidate],
                        policy: str = "group_by_owner"
                        ) -> Optional[KillCandidate]:
    """Choose the worker to kill under memory pressure.

    group_by_owner (ref: worker_killing_policy_group_by_owner.h): group by
    (job, retriable); prefer retriable groups, then larger groups — so the
    last task of an owner is only killed when every group is a singleton —
    and kill the newest member (LIFO), which has done the least work.

    retriable_fifo (ref: worker_killing_policy.h RetriableFIFO): kill the
    newest retriable worker; fall back to the newest non-retriable.
    """
    if not candidates:
        return None
    if policy == "retriable_fifo":
        pool = [c for c in candidates if c.retriable] or list(candidates)
        return max(pool, key=lambda c: c.start_time)
    groups: dict = {}
    for c in candidates:
        groups.setdefault((not c.retriable, c.job_id), []).append(c)
    # Sort groups: retriable first (False<True), bigger first; tie → group
    # holding the globally newest member.
    def group_key(item):
        (nonretriable, _job), members = item
        return (nonretriable, -len(members),
                -max(m.start_time for m in members))
    _, members = sorted(groups.items(), key=group_key)[0]
    return max(members, key=lambda c: c.start_time)


class MemoryMonitor:
    """Threshold watcher; the nodelet drives it from an async loop.

    usage_fraction() reads the live system numbers unless a test override
    file is configured (tests write a bare float to it, mirroring how the
    reference fakes usage in memory_monitor_test.cc).
    """

    def __init__(self, threshold: float,
                 test_usage_file: str = ""):
        self.threshold = threshold
        self.test_usage_file = test_usage_file
        self.kills = 0

    def usage_fraction(self) -> float:
        if self.test_usage_file:
            try:
                with open(self.test_usage_file) as f:
                    return float(f.read().strip())
            except (OSError, ValueError):
                return 0.0
        used, total = get_memory_usage()
        return used / max(total, 1)

    def above_threshold(self) -> bool:
        return self.usage_fraction() > self.threshold
