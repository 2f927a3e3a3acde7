"""Typed failure taxonomy for host collectives.

A collective round is a distributed rendezvous: if a member dies (or
stalls past the group's timeout) every surviving rank must surface a
typed error instead of blocking forever inside ``ray_tpu_torch.get``. The
reference framework leans on NCCL/Gloo transport errors for this; here
detection is explicit — per-round timeouts plus a liveness probe of the
peers' mailboxes — and everything funnels into ``CollectiveError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ray_tpu_torch.core.status import RayTpuError


class CollectiveError(RayTpuError):
    """A host-collective round failed (member death, timeout, bad input).

    Attributes:
        group_name: collective group the failed round belonged to.
        op: operation in flight ("allreduce", "barrier", ...).
        suspect_ranks: ranks whose mailbox/coordinator did not respond to
            the post-timeout liveness probe — the likely casualties.
    """

    def __init__(self, msg: str, *, group_name: str = "",
                 op: str = "", suspect_ranks: Optional[Sequence[int]] = None):
        super().__init__(msg)
        self.group_name = group_name
        self.op = op
        self.suspect_ranks = list(suspect_ranks or [])

    def __reduce__(self):   # survive the TaskError pickling hop
        return (_rebuild, (self.args[0] if self.args else "",
                           self.group_name, self.op, self.suspect_ranks))


def _rebuild(msg, group_name, op, suspect_ranks):
    return CollectiveError(msg, group_name=group_name, op=op,
                           suspect_ranks=suspect_ranks)


class CollectiveTimeoutError(CollectiveError, TimeoutError):
    """A round did not complete within the group's ``timeout_s``."""

    def __reduce__(self):
        return (_rebuild_timeout, (self.args[0] if self.args else "",
                                   self.group_name, self.op,
                                   self.suspect_ranks))


def _rebuild_timeout(msg, group_name, op, suspect_ranks):
    return CollectiveTimeoutError(msg, group_name=group_name, op=op,
                                  suspect_ranks=suspect_ranks)
