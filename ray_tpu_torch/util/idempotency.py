"""At-most-once execution for non-idempotent RPC handlers.

A duplicated request frame (retry after a dropped response, or injected
duplication from the chaos plane) reaches the handler twice. For
idempotent handlers that's harmless; for actor creation / lease grants
it double-spends resources. The fix is the classic idempotency-token
dedupe: the *caller* mints a token stable across its retries, the
handler runs the side effect once per token and replays the recorded
result to every duplicate.

Two properties matter and are easy to get wrong:

- **Only successes are cached.** A failed attempt must NOT be replayed:
  the caller's retry carries the same token precisely because it wants
  the side effect attempted again (e.g. "no worker available" is a
  transient verdict, not a durable one). Failures evict the token.
- **In-flight duplicates coalesce.** The second delivery of a frame
  whose handler is still running must wait for — and share — the first
  attempt's outcome, not start a concurrent second side effect.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Dict, Optional


class IdemCache:
    """Per-handler token → outcome cache (asyncio, single-loop).

    ``run(token, thunk)`` executes ``thunk()`` at most once per token:
    concurrent duplicates await the in-flight attempt, later duplicates
    replay the cached success. ``token=None`` bypasses dedupe entirely
    (callers that predate tokens keep their old semantics).
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._done: "OrderedDict[str, Any]" = OrderedDict()
        self._inflight: Dict[str, asyncio.Future] = {}
        self.hits = 0          # duplicates absorbed (replayed or joined)

    async def run(self, token: Optional[str],
                  thunk: Callable[[], Awaitable[Any]],
                  cache_if: Optional[Callable[[Any], bool]] = None) -> Any:
        """``cache_if``: predicate over the result deciding whether it is
        a *durable* success worth replaying. Handlers that report failure
        in-band (``{"ok": False, "retryable": True}``) must not have that
        verdict replayed to a stable-token retry — the retry exists to
        re-attempt the side effect — so they pass
        ``cache_if=lambda r: r.get("ok")``."""
        if token is None:
            return await thunk()
        if token in self._done:
            self.hits += 1
            self._done.move_to_end(token)
            return self._done[token]
        fut = self._inflight.get(token)
        if fut is not None:
            self.hits += 1
            # shield: a cancelled duplicate must not cancel the original
            return await asyncio.shield(fut)
        fut = asyncio.get_running_loop().create_future()
        self._inflight[token] = fut
        try:
            result = await thunk()
        except BaseException as e:
            # failure: evict so the caller's retry re-attempts the side
            # effect; joined duplicates see the same failure
            self._inflight.pop(token, None)
            if not fut.done():
                fut.set_exception(e)
                # consume it if nobody joined, else "exception was never
                # retrieved" is logged at gc time
                fut.exception()
            raise
        self._inflight.pop(token, None)
        if not fut.done():
            fut.set_result(result)
        if cache_if is None or cache_if(result):
            self._done[token] = result
            while len(self._done) > self.capacity:
                self._done.popitem(last=False)
        return result

    def forget(self, token: str) -> None:
        """Drop a recorded success (e.g. the created actor died and its
        id will be reused for a restart with a new token anyway)."""
        self._done.pop(token, None)

    def stats(self) -> dict:
        return {"done": len(self._done), "inflight": len(self._inflight),
                "hits": self.hits}
