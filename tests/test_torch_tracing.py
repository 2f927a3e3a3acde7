"""Distributed tracing: span propagation through task/actor calls.

Reference test model: python/ray/tests/test_tracing.py — spans created
for remote calls, user spans nest, context propagates across processes.

Port of tests/test_tracing.py, aimed at ray_tpu_torch.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import tracing
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    tracing.enable()
    yield
    tracing.disable()
    ray_tpu_torch.shutdown()


def _spans(expect_name=None, timeout=10.0):
    """Snapshot spans; when expect_name is given, poll until a span with
    that name lands (worker task-event buffers flush asynchronously)."""
    import time

    deadline = time.time() + timeout
    while True:
        out = [e for e in ray_tpu_torch.timeline(limit=2000)
               if e.get("kind") == "span"]
        if expect_name is None or any(s["name"] == expect_name for s in out) \
                or time.time() > deadline:
            return out
        time.sleep(0.2)


def test_local_span_nesting(cluster):
    with tracing.span("outer") as outer:
        with tracing.span("inner") as inner:
            pass
    assert inner["trace_id"] == outer["trace_id"]
    assert inner["parent_id"] == outer["span_id"]
    names = {s["name"] for s in _spans()}
    assert {"outer", "inner"} <= names


def test_trace_propagates_to_task(cluster):
    @ray_tpu_torch.remote
    def traced_child():
        # nested user span inside the task continues the same trace
        with tracing.span("in_task_work"):
            return tracing.current_context()["trace_id"]

    with tracing.span("driver_root") as root:
        child_trace = ray_tpu_torch.get(traced_child.remote())
    assert child_trace == root["trace_id"]

    spans = _spans(expect_name="task::traced_child")
    task_spans = [s for s in spans if s["name"] == "task::traced_child"]
    assert task_spans, spans
    ts = task_spans[-1]
    assert ts["trace_id"] == root["trace_id"]
    assert ts["parent_id"] == root["span_id"]
    work = [s for s in spans if s["name"] == "in_task_work"][-1]
    assert work["parent_id"] == ts["span_id"]
    assert "task_id" in ts["attrs"]


def test_trace_propagates_to_actor(cluster):
    @ray_tpu_torch.remote
    class A:
        def m(self):
            return tracing.current_context()["trace_id"]

    with tracing.span("actor_root") as root:
        a = A.remote()
        t = ray_tpu_torch.get(a.m.remote())
    assert t == root["trace_id"]
    spans = _spans(expect_name="actor::m")
    m = [s for s in spans if s["name"] == "actor::m"]
    assert m and m[-1]["parent_id"] == root["span_id"]
    init = [s for s in spans if s["name"] == "actor::A.__init__"]
    assert init and init[-1]["trace_id"] == root["trace_id"]
    ray_tpu_torch.kill(a)


def test_disabled_no_spans(cluster):
    tracing.disable()
    try:
        before = len(_spans())

        @ray_tpu_torch.remote
        def f():
            return tracing.current_context()

        assert ray_tpu_torch.get(f.remote()) is None
        # user spans are no-ops when tracing is off
        with tracing.span("ignored") as s:
            assert s is None
        assert len(_spans()) == before
    finally:
        tracing.enable()


def test_grandchild_task_continues_trace(cluster):
    """Tasks submitted FROM a worker keep the trace even though workers
    never call enable() process-locally."""
    @ray_tpu_torch.remote
    def leaf():
        return tracing.current_context()["trace_id"]

    @ray_tpu_torch.remote
    def mid():
        return ray_tpu_torch.get(leaf.remote())

    with tracing.span("root") as root:
        assert ray_tpu_torch.get(mid.remote()) == root["trace_id"]
    leaf_spans = [s for s in _spans(expect_name="task::leaf")
                  if s["name"] == "task::leaf"]
    assert leaf_spans and leaf_spans[-1]["trace_id"] == root["trace_id"]


def test_trace_chain_task_actor_nested_task(cluster):
    """One trace across a task -> actor method -> nested task chain,
    with parent ids linking each hop to the previous one."""
    @ray_tpu_torch.remote
    def chain_leaf():
        return tracing.current_context()["trace_id"]

    @ray_tpu_torch.remote
    class Hopper:
        def hop(self):
            return ray_tpu_torch.get(chain_leaf.remote())

    a = Hopper.remote()

    @ray_tpu_torch.remote
    def chain_entry(h):
        return ray_tpu_torch.get(h.hop.remote())

    with tracing.span("chain_root") as root:
        assert ray_tpu_torch.get(chain_entry.remote(a)) == root["trace_id"]
    # each hop flushes from a different worker; wait for all three
    _spans(expect_name="task::chain_entry")
    _spans(expect_name="actor::hop")
    spans = _spans(expect_name="task::chain_leaf")

    def latest(name):
        hits = [s for s in spans if s["name"] == name
                and s["trace_id"] == root["trace_id"]]
        assert hits, (name, sorted({s["name"] for s in spans}))
        return hits[-1]

    entry, hop, leaf = (latest("task::chain_entry"), latest("actor::hop"),
                        latest("task::chain_leaf"))
    assert entry["parent_id"] == root["span_id"]
    assert hop["parent_id"] == entry["span_id"]
    assert leaf["parent_id"] == hop["span_id"]
    ray_tpu_torch.kill(a)


def test_continue_trace_noop_when_disabled(cluster):
    """continue_trace with tracing off and no inbound context records
    nothing and leaves the context untouched; an inbound context still
    counts as opt-in (that's how workers join a driver's trace)."""
    tracing.disable()
    try:
        before = len(_spans())
        with tracing.continue_trace(None, "should_not_record") as rec:
            assert rec is None
            assert tracing.current_context() is None
        assert len(_spans()) == before
        ctx = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
        with tracing.continue_trace(ctx, "carried_in") as rec:
            assert rec is not None
            assert rec["trace_id"] == ctx["trace_id"]
            assert rec["parent_id"] == ctx["span_id"]
        assert tracing.current_context() is None  # context restored
    finally:
        tracing.enable()


def test_span_records_errors(cluster):
    with pytest.raises(ValueError):
        with tracing.span("failing"):
            raise ValueError("boom")
    s = [x for x in _spans() if x["name"] == "failing"][-1]
    assert "ValueError" in s["attrs"]["error"]
