"""@serve.batch: dynamic request batching inside a replica.

Reference: python/ray/serve/batching.py:65 (_BatchQueue) — async requests
accumulate until max_batch_size or batch_wait_timeout_s, then the wrapped
function is called once with the list; results fan back out per-caller.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.queue: List = []          # (item, future)
        self._flusher: Optional[asyncio.Task] = None

    async def submit(self, instance, item) -> Any:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.queue.append((item, fut))
        if len(self.queue) >= self.max_batch_size:
            await self._flush(instance)
        elif self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._delayed_flush(instance))
        return await fut

    async def _delayed_flush(self, instance):
        await asyncio.sleep(self.timeout_s)
        await self._flush(instance)

    async def _flush(self, instance):
        batch, self.queue = self.queue, []
        if not batch:
            return
        items = [b[0] for b in batch]
        try:
            if instance is not None:
                results = self.fn(instance, items)
            else:
                results = self.fn(items)
            if asyncio.iscoroutine(results):
                results = await results
            if len(results) != len(items):
                raise ValueError(
                    f"batched fn returned {len(results)} results for "
                    f"{len(items)} inputs")
            for (_, fut), r in zip(batch, results):
                if not fut.done():
                    fut.set_result(r)
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate an async method taking a LIST of requests."""

    def deco(fn):
        q = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:          # bound method (self, item)
                return await q.submit(args[0], args[1])
            return await q.submit(None, args[0])

        wrapper._batch_queue = q
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
