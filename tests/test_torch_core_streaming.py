"""Streaming generator tasks (ref: src/ray/core_worker/task_manager.h:143-171
streaming-generator return refs; num_returns="dynamic" surface in
python/ray/_private/worker.py).

Port of tests/test_core_streaming.py, aimed at ray_tpu_torch.
"""

import numpy as np
import pytest

import ray_tpu_torch
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


def test_streaming_task_basic(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    g = gen.remote(5)
    assert isinstance(g, ray_tpu_torch.ObjectRefGenerator)
    vals = [ray_tpu_torch.get(ref) for ref in g]
    assert vals == [0, 10, 20, 30, 40]
    # exhausted
    with pytest.raises(StopIteration):
        next(g)


def test_streaming_incremental_consumption(ray_start_regular, tmp_path):
    """Items are consumable while the generator is still running."""
    gate = tmp_path / "gate"

    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_gen():
        import time
        yield "first"
        while not gate.exists():     # blocks until the test releases it
            time.sleep(0.05)
        yield "second"

    g = slow_gen.remote()
    first = ray_tpu_torch.get(next(g))
    assert first == "first"          # consumed before the task finished
    gate.write_text("go")
    assert ray_tpu_torch.get(next(g)) == "second"
    with pytest.raises(StopIteration):
        next(g)


def test_streaming_large_items_via_store(ray_start_regular):
    """Items above the inline threshold travel through the node store."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def big(n):
        for i in range(n):
            yield np.full((64, 1024), i, dtype=np.float32)   # 256 KiB

    out = [ray_tpu_torch.get(r) for r in big.remote(3)]
    assert len(out) == 3
    for i, a in enumerate(out):
        assert a.shape == (64, 1024) and float(a[0, 0]) == i


def test_streaming_mid_generator_error(ray_start_regular):
    """Successfully yielded items stay consumable; the task's exception
    surfaces when iterating past them (reference generator semantics)."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def bad():
        yield 1
        yield 2
        raise ValueError("boom at item 3")

    g = bad.remote()
    assert ray_tpu_torch.get(next(g)) == 1
    assert ray_tpu_torch.get(next(g)) == 2
    with pytest.raises(ray_tpu_torch.exceptions.TaskError,
                       match="boom at item 3") as ei:
        next(g)
    assert isinstance(ei.value.cause, ValueError)


def test_streaming_non_generator_return_errors(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def not_a_gen():
        return 42

    g = not_a_gen.remote()
    with pytest.raises(ray_tpu_torch.exceptions.TaskError,
                       match="not a generator") as ei:
        next(g)
    assert isinstance(ei.value.cause, TypeError)


def test_streaming_dynamic_alias_and_options(ray_start_regular):
    @ray_tpu_torch.remote
    def gen(n):
        yield from range(n)

    g = gen.options(num_returns="dynamic").remote(3)
    assert [ray_tpu_torch.get(r) for r in g] == [0, 1, 2]


def test_streaming_item_refs_are_plain_refs(ray_start_regular):
    """Yielded refs interop with wait/get like any owned ref."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen():
        yield from ("a", "b")

    g = gen.remote()
    refs = [next(g), next(g)]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=2, timeout=30)
    assert len(ready) == 2 and not pending
    assert ray_tpu_torch.get(ready) in (["a", "b"], ["b", "a"])


def test_streaming_actor_method(ray_start_regular):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.base = 100

        @ray_tpu_torch.method(num_returns="streaming")
        def count(self, n):
            for i in range(n):
                yield self.base + i

    c = Counter.remote()
    vals = [ray_tpu_torch.get(r) for r in c.count.remote(4)]
    assert vals == [100, 101, 102, 103]


def test_streaming_async_actor_method(ray_start_regular):
    @ray_tpu_torch.remote
    class Tokens:
        @ray_tpu_torch.method(num_returns="streaming")
        async def stream(self, n):
            import asyncio
            for i in range(n):
                await asyncio.sleep(0.01)
                yield f"tok{i}"

    t = Tokens.remote()
    vals = [ray_tpu_torch.get(r) for r in t.stream.remote(3)]
    assert vals == ["tok0", "tok1", "tok2"]


def test_zero_copy_value_outlives_ref(ray_start_regular):
    """A zero-copy value must stay valid after its ObjectRef is GC'd:
    the store region may not be reused while a numpy view aliases it
    (regression — streaming's same-size rapid allocations exposed reuse
    of freed regions under still-live views)."""
    import gc

    @ray_tpu_torch.remote(num_returns="streaming")
    def big(n):
        for i in range(n):
            yield np.full((64, 1024), i, dtype=np.float32)   # 256 KiB

    out = []
    for r in big.remote(6):
        out.append(ray_tpu_torch.get(r))
        del r                      # ref dies; value must survive
    gc.collect()
    for i, a in enumerate(out):
        assert float(a[0, 0]) == i and float(a[-1, -1]) == i, \
            f"item {i} bytes were clobbered by a later allocation"


def test_streaming_generator_progress(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen():
        yield from range(3)

    g = gen.remote()
    out = [ray_tpu_torch.get(r) for r in g]
    assert out == [0, 1, 2]
    assert g.completed() == 3
