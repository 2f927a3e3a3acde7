"""Distributed FIFO queue (ref: python/ray/util/queue.py) — actor-backed."""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int = 0):
        import asyncio

        self.maxsize = maxsize
        self.q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item) -> bool:
        await self.q.put(item)
        return True

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        if timeout is None:
            return await self.q.get()
        return await asyncio.wait_for(self.q.get(), timeout)

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {"num_cpus": 0.1})
        opts["max_concurrency"] = 16
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True) -> None:
        ray_tpu_torch.get(self.actor.put.remote(item))

    def put_async(self, item):
        return self.actor.put.remote(item)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self.actor.get.remote(timeout))

    def get_async(self, timeout: Optional[float] = None):
        return self.actor.get.remote(timeout)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)
