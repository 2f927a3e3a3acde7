"""ActorPool: work distribution over a fixed actor fleet.

Reference: python/ray/util/actor_pool.py — `get_next` returns results in
SUBMISSION order (:241), `get_next_unordered` in completion order (:282);
`map`/`map_unordered` stream over each. Indices are assigned at dispatch
time and pending submits drain FIFO, so dispatch order == submit order
and the ordered cursor always points at a dispatched task.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        self._idle = list(actors)
        self._future_to_actor = {}   # ref -> (submission index, actor)
        self._index_to_future = {}   # submission index -> ref
        self._next_task_index = 0
        self._next_return_index = 0  # ordered-get cursor
        self._pending = []           # (fn, value) waiting for an idle actor

    def submit(self, fn: Callable, value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending)

    def has_free(self) -> bool:
        """True when an actor is idle (ref: actor_pool.py has_free)."""
        return bool(self._idle) and not self._pending

    def push(self, actor: Any) -> None:
        """Grow the pool with an idle actor (ref: actor_pool.py push)."""
        self._return_actor(actor)

    def pop_idle(self) -> Any:
        """Remove and return an idle actor, or None (ref: pop_idle)."""
        return self._idle.pop() if self._idle else None

    def _return_actor(self, actor: Any) -> None:
        self._idle.append(actor)
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout=None):
        """Next result in SUBMISSION order (ref: actor_pool.py:241); a
        later task finishing first waits its turn. TimeoutError if the
        next-in-order result isn't ready in `timeout` seconds."""
        if not self.has_next():
            raise StopIteration("no pending results")
        i = self._next_return_index
        # skip indices already consumed by get_next_unordered
        while i < self._next_task_index and i not in self._index_to_future:
            i += 1
        self._next_return_index = i
        ref = self._index_to_future.get(i)
        if ref is None:
            # every dispatched task was consumed unordered; only pending
            # (undispatched) submits remain — impossible with an idle
            # actor, so this means the pool was built with zero actors
            raise RuntimeError("ActorPool has queued work but no actors")
        ready, _ = self._ray.wait([ref], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("next ordered result not ready in time")
        del self._index_to_future[i]
        self._next_return_index = i + 1
        _, actor = self._future_to_actor.pop(ref)
        self._return_actor(actor)
        return self._ray.get(ref)

    def get_next_unordered(self, timeout=None):
        """Next result in COMPLETION order (ref: actor_pool.py:282) —
        the fastest task wins, block order is the caller's problem."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = self._ray.wait(list(self._future_to_actor),
                                  num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result ready in time")
        ref = ready[0]
        index, actor = self._future_to_actor.pop(ref)
        del self._index_to_future[index]
        self._return_actor(actor)
        return self._ray.get(ref)

    def map(self, fn: Callable, values: Iterable[Any]):
        """Results in submission order (ref: actor_pool.py map)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        """Results in completion order (ref: map_unordered)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
