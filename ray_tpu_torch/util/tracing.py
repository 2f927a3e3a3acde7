"""Distributed tracing: spans propagated through task/actor calls.

Reference: python/ray/util/tracing/tracing_helper.py — opt-in tracing
that wraps task/actor invocation in spans
(_inject_tracing_into_function:322, _inject_tracing_into_class:447) and
serializes the span context into task metadata
(_function_hydrate_span_args:195) so remote execution continues the
caller's trace.

TPU-shaped re-design: no OpenTelemetry SDK dependency (not in-image).
Spans are plain dicts {trace_id, span_id, parent_id, name, ts, dur, attrs}
riding the existing task-event channel to the GCS (task_event_buffer.h:199
analog), so one store serves task states AND spans, and `ray_tpu_torch.timeline()`
/ the CLI export both as one Chrome trace. Context propagation is a
contextvar here + a `trace_ctx` field on TaskSpec there.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Any, Dict, Optional

_ctx: contextvars.ContextVar[Optional[Dict[str, str]]] = \
    contextvars.ContextVar("ray_tpu_torch_trace_ctx", default=None)

_enabled: Optional[bool] = None


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    """Opt-in like the reference (`ray.init(_tracing_startup_hook=...)`):
    enable() in-process or RAY_TPU_TRACING=1 fleet-wide."""
    if _enabled is not None:
        return _enabled
    return os.environ.get("RAY_TPU_TRACING", "0") in ("1", "true")


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def current_context() -> Optional[Dict[str, str]]:
    """The {trace_id, span_id} to stamp onto outgoing TaskSpecs."""
    return _ctx.get()


def _record(span: Dict[str, Any]) -> None:
    try:
        from ray_tpu_torch import _rt

        rt = _rt.get_runtime()
    except Exception:
        return
    rt.record_span(span)


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """User-facing span (ref: custom spans via util/debug profiling).
    Nested spans chain; spans created inside a task continue the
    submitting caller's trace (a live parent context counts as opt-in
    even when this process never called enable() — that's how worker
    processes participate). No-op when tracing is off."""
    parent = _ctx.get()
    if not (is_enabled() or parent is not None):
        yield None
        return
    rec = {
        "kind": "span",
        "name": name,
        "trace_id": parent["trace_id"] if parent else _new_id(16),
        "span_id": _new_id(8),
        "parent_id": parent["span_id"] if parent else None,
        "ts": time.time(),
        "attrs": dict(attributes or {}),
    }
    token = _ctx.set({"trace_id": rec["trace_id"],
                      "span_id": rec["span_id"]})
    try:
        yield rec
    except BaseException as e:
        rec["attrs"]["error"] = repr(e)
        raise
    finally:
        _ctx.reset(token)
        rec["dur"] = time.time() - rec["ts"]
        _record(rec)


def emit_span(name: str, ts: float, dur: float,
              attributes: Optional[Dict[str, Any]] = None) -> Optional[dict]:
    """Record a synthetic complete span for a phase measured elsewhere
    (streaming-executor op lifetimes, replayed timings). Same opt-in
    rule as span(): a live parent context counts as opt-in, and the
    span chains under it."""
    parent = _ctx.get()
    if not (is_enabled() or parent is not None):
        return None
    rec = {
        "kind": "span",
        "name": name,
        "trace_id": parent["trace_id"] if parent else _new_id(16),
        "span_id": _new_id(8),
        "parent_id": parent["span_id"] if parent else None,
        "ts": float(ts),
        "dur": float(dur),
        "attrs": dict(attributes or {}),
    }
    _record(rec)
    return rec


@contextlib.contextmanager
def continue_trace(trace_ctx: Optional[Dict[str, str]], name: str,
                   attributes: Optional[Dict[str, Any]] = None):
    """Worker-side: wrap a task execution in a span parented to the
    submitted context (ref: _function_span_consumer_name — the remote
    half of the trace). No-op when tracing is off AND no context came."""
    if not (is_enabled() or trace_ctx):
        yield None
        return
    if trace_ctx:
        token = _ctx.set(dict(trace_ctx))
    else:
        token = None
    try:
        with span(name, attributes) as rec:
            yield rec
    finally:
        if token is not None:
            _ctx.reset(token)
