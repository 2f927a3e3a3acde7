"""Exponential backoff with full jitter, deadline-capped.

Reference: the AWS architecture-blog "full jitter" result — for N
contending retriers, sleeping ``uniform(0, min(cap, base * 2**attempt))``
minimizes total work AND completion time versus equal or decorrelated
jitter. Fixed-interval retry loops (the 0.5s sleeps this replaces in the
nodelet's durable GCS report loop and the driver's GCS reconnect)
synchronize retriers into thundering herds against a just-restarted GCS;
jittered exponential spreads them out while still probing fast at first.
"""

from __future__ import annotations

import random
import time
from typing import Iterator, Optional


class Backoff:
    """One retry loop's backoff state.

    >>> bo = Backoff(base_s=0.05, cap_s=2.0, deadline_s=time.time() + 30)
    >>> while not attempt():
    ...     if not bo.sleep():
    ...         raise TimeoutError("deadline exhausted")
    """

    def __init__(self, base_s: float = 0.05, cap_s: float = 5.0,
                 factor: float = 2.0, deadline_s: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self.deadline_s = deadline_s    # absolute time.time() deadline
        self.attempt = 0
        self._rng = rng or random

    def next_delay(self) -> float:
        """The next sleep: full jitter over the exponential envelope,
        never sleeping past the deadline."""
        # clamp the exponent: factor ** attempt overflows float for
        # long-lived loops (thousands of attempts), and 64 doublings
        # already exceed any sane cap
        envelope = min(self.cap_s,
                       self.base_s * (self.factor ** min(self.attempt, 64)))
        self.attempt += 1
        delay = self._rng.uniform(0.0, envelope)
        if self.deadline_s is not None:
            delay = min(delay, max(self.deadline_s - time.time(), 0.0))
        return delay

    def expired(self) -> bool:
        return self.deadline_s is not None and time.time() >= self.deadline_s

    def sleep(self) -> bool:
        """Blocking sleep; False once the deadline has passed (callers
        stop retrying). Async loops use ``asyncio.sleep(bo.next_delay())``
        with an explicit ``bo.expired()`` check instead."""
        if self.expired():
            return False
        time.sleep(self.next_delay())
        return True


def delays(base_s: float = 0.05, cap_s: float = 5.0, factor: float = 2.0,
           deadline_s: Optional[float] = None,
           rng: Optional[random.Random] = None) -> Iterator[float]:
    """Generator form: yields jittered delays until the deadline passes
    (infinite when no deadline — pair with an attempt cap)."""
    bo = Backoff(base_s, cap_s, factor, deadline_s, rng)
    while not bo.expired():
        yield bo.next_delay()
