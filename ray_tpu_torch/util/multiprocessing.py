"""multiprocessing.Pool API over ray_tpu_torch actors.

Reference: python/ray/util/multiprocessing/pool.py — Pool whose workers are
actors, so `map`/`apply_async` parallelize over the cluster instead of local
forks. Chunking semantics follow the stdlib: iterables are split into
chunks, each chunk is one actor task.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    """Stdlib-compatible handle over one or more ObjectRefs.

    Collection is lazy: the result is fetched on the first get()/wait()
    on the caller's thread; a collector thread is spawned only when a
    callback requires out-of-band delivery."""

    def __init__(self, refs, single: bool, callback=None, error_callback=None):
        self._refs = list(refs)
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._done = threading.Event()
        self._collect_lock = threading.Lock()
        self._collector_started = False
        self._collecting = False
        self._value = None
        self._error: Optional[BaseException] = None
        if callback is not None or error_callback is not None:
            self._start_collector()

    def _start_collector(self):
        with self._collect_lock:
            if self._collector_started or self._done.is_set():
                return
            self._collector_started = True
        threading.Thread(target=self._collect, daemon=True).start()

    def _collect(self):
        # The lock only claims the fetch; holding it across the get()
        # would stall every wait(timeout) caller (they acquire it in
        # _start_collector) for the full, unbounded collection.
        with self._collect_lock:
            if self._done.is_set() or self._collecting:
                claimed = False
            else:
                self._collecting = True
                claimed = True
        if not claimed:
            self._done.wait()
            return
        try:
            vals = ray_tpu_torch.get(self._refs)
            self._value = vals[0] if self._single else list(
                itertools.chain.from_iterable(vals))
            if self._callback:
                self._callback(self._value)
        except BaseException as e:  # noqa: BLE001 — surfaced via .get()
            self._error = e
            if self._error_callback:
                self._error_callback(e)
        finally:
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        if self._done.is_set():
            return
        if timeout is None:
            self._collect()
        else:
            self._start_collector()
            self._done.wait(timeout)

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result not ready")
        return self._error is None

    def get(self, timeout: Optional[float] = None):
        self.wait(timeout)
        if not self._done.is_set():
            raise TimeoutError("result not ready in time")
        if self._error is not None:
            raise self._error
        return self._value


@ray_tpu_torch.remote
class _PoolActor:
    def __init__(self, initializer=None, initargs=()):
        if initializer:
            initializer(*initargs)

    def run_chunk(self, fn, chunk, star: bool):
        if star:
            return [fn(*item) for item in chunk]
        return [fn(item) for item in chunk]

    def run_one(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))


class Pool:
    """ref: ray.util.multiprocessing.Pool."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), maxtasksperchild=None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            processes = max(int(total), 1)
        self._n = processes
        self._actors = [_PoolActor.remote(initializer, tuple(initargs))
                        for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False
        self._outstanding: List[AsyncResult] = []

    # -- apply ----------------------------------------------------------------

    def apply(self, func: Callable, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args=(), kwds=None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_open()
        a = self._actors[next(self._rr)]
        ref = a.run_one.remote(func, tuple(args), kwds or {})
        return self._track(AsyncResult([ref], single=True, callback=callback,
                                       error_callback=error_callback))

    # -- map ------------------------------------------------------------------

    def map(self, func: Callable, iterable: Iterable, chunksize=None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable, chunksize=None, callback=None,
                  error_callback=None) -> AsyncResult:
        refs = self._submit_chunks(func, list(iterable), chunksize, star=False)
        return self._track(AsyncResult(refs, single=False, callback=callback,
                                       error_callback=error_callback))

    def starmap(self, func: Callable, iterable: Iterable, chunksize=None):
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func, iterable, chunksize=None, callback=None,
                      error_callback=None) -> AsyncResult:
        refs = self._submit_chunks(func, list(iterable), chunksize, star=True)
        return self._track(AsyncResult(refs, single=False, callback=callback,
                                       error_callback=error_callback))

    def imap(self, func, iterable, chunksize=1):
        items = list(iterable)
        refs = self._submit_chunks(func, items, chunksize, star=False)
        for ref in refs:
            for v in ray_tpu_torch.get(ref):
                yield v

    def imap_unordered(self, func, iterable, chunksize=1):
        items = list(iterable)
        refs = self._submit_chunks(func, items, chunksize, star=False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for chunk in ray_tpu_torch.get(ready):
                for v in chunk:
                    yield v

    def _submit_chunks(self, func, items, chunksize, star: bool):
        self._check_open()
        if chunksize is None:
            chunksize = max(1, len(items) // (self._n * 4) or 1)
        refs = []
        for i in range(0, len(items), chunksize):
            a = self._actors[next(self._rr)]
            refs.append(a.run_chunk.remote(func, items[i:i + chunksize], star))
        return refs

    # -- lifecycle ------------------------------------------------------------

    def _track(self, r: AsyncResult) -> AsyncResult:
        self._outstanding = [x for x in self._outstanding if not x.ready()]
        self._outstanding.append(r)
        return r

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []

    def join(self):
        """Blocks until all outstanding async work drains (stdlib
        close()/join() contract)."""
        if not self._closed:
            raise ValueError("Pool is still running")
        for r in self._outstanding:
            try:
                r.wait()
            except BaseException:  # noqa: BLE001 — join only drains
                pass
        self._outstanding = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
