"""Durable workflow DAG execution with per-step checkpoints.

Port of ray_tpu/workflow/api.py over the port's runtime: the same step
keys (numpy and python args give the reference's), storage layout and
statuses. A step's result is pickled to storage: return paths and host
values, not CUDA tensors, which a later process would load onto its card.

Reference: workflow/api.py + task_executor.py + storage/ — steps are content-
addressed by (workflow_id, step name + arg lineage); results persist via
pickle under the storage dir. Resume = skip steps whose result file exists.
Step bodies execute as ray_tpu_torch tasks.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Dict, List, Optional

import ray_tpu_torch


def _atomic_pickle(path: str, obj: Any) -> None:
    """Write-then-rename so readers never observe a torn checkpoint."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _content_bytes(a: Any) -> bytes:
    """Stable content bytes of a step arg. Plain pickle first; callables
    and anything else plain pickle rejects (lambdas, __main__ closures)
    fall back to cloudpickle, which is what actually ships args to the
    executing task."""
    try:
        return pickle.dumps(a, protocol=4)
    except Exception:
        import cloudpickle

        return cloudpickle.dumps(a, protocol=4)


class StepNode:
    def __init__(self, fn, args, kwargs, name=None, max_retries: int = 3):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "step")
        self.max_retries = max_retries
        self._key: Optional[str] = None

    def key(self) -> str:
        # Content-address by the *pickled* args, not repr(): numpy reprs
        # elide interior elements, so two different large arrays would
        # collide onto one step key and resume would silently return the
        # wrong cached result (ref checkpoint identity:
        # python/ray/workflow/task_executor.py). Memoized — parents hash
        # their children's keys, so an uncached chain would re-pickle
        # large args once per ancestor.
        if self._key is not None:
            return self._key
        h = hashlib.sha1(self.name.encode())
        for a in self.args:
            h.update(a.key().encode() if isinstance(a, StepNode)
                     else _content_bytes(a))
        for k in sorted(self.kwargs):
            v = self.kwargs[k]
            h.update(k.encode())
            h.update(v.key().encode() if isinstance(v, StepNode)
                     else _content_bytes(v))
        self._key = f"{self.name}-{h.hexdigest()[:16]}"
        return self._key


class _Step:
    def __init__(self, fn, max_retries: int = 3):
        self.fn = fn
        self.max_retries = max_retries

    def bind(self, *args, **kwargs) -> StepNode:
        return StepNode(self.fn, args, kwargs, max_retries=self.max_retries)

    def options(self, max_retries: int = 3) -> "_Step":
        return _Step(self.fn, max_retries)


def step(fn=None, *, max_retries: int = 3):
    """@workflow.step decorator."""
    if fn is not None:
        return _Step(fn, max_retries)
    return lambda f: _Step(f, max_retries)


class EventNode(StepNode):
    """A durable external-event wait (ref: workflow.wait_for_event +
    event_listener.py). Resolution blocks until send_event() delivers a
    payload for (workflow_id, name); the payload checkpoints like any
    step result, so a resumed workflow does NOT re-wait for an event it
    already received."""

    def __init__(self, name: str, timeout: Optional[float] = None,
                 poll_interval: float = 0.05):
        super().__init__(fn=None, args=(), kwargs={}, name=f"event:{name}")
        self.event_name = name
        self.timeout = timeout
        self.poll_interval = poll_interval

    def key(self) -> str:
        return f"event-{self.event_name}"


def wait_for_event(name: str, timeout: Optional[float] = None) -> EventNode:
    """Use as a step argument (or continuation target): the workflow
    parks until `send_event(workflow_id, name, payload)` fires, then the
    payload flows into the dependent step."""
    return EventNode(name, timeout)


def _event_path(storage: str, workflow_id: str, name: str) -> str:
    d = os.path.join(storage, workflow_id, "events")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name + ".pkl")


def send_event(workflow_id: str, name: str, payload: Any = None, *,
               storage: str) -> None:
    """Deliver an external event (ref: workflow event HTTP endpoint /
    manual event senders). Durable: the payload lands on storage first,
    so a crash between send and receipt re-delivers on resume."""
    _atomic_pickle(_event_path(storage, workflow_id, name), payload)


# ---- workflow queue (ref: max running workflows + QUEUED status) ----------

import threading as _threading

_queue_sem = None
#: thread-local handle to the queue slot the current workflow holds, so
#: event waits can release it while parked
_slot_ctx = _threading.local()


def set_max_running(n: Optional[int]) -> None:
    """Cap concurrently RUNNING workflows started via run_async; excess
    submissions hold in QUEUED status until a slot frees (ref: the
    reference's workflow queue semantics). None lifts the cap."""
    global _queue_sem
    import threading

    _queue_sem = None if n is None else threading.BoundedSemaphore(n)


def _storage_path(storage: str, workflow_id: str, key: str) -> str:
    d = os.path.join(storage, workflow_id, "steps")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, key + ".pkl")


def _write_status(storage: str, workflow_id: str, status: str,
                  error: Optional[str] = None):
    d = os.path.join(storage, workflow_id)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, "status.tmp")
    with open(tmp, "w") as f:
        f.write(status + ("\n" + error if error else ""))
    os.replace(tmp, os.path.join(d, "status"))


def run(node: StepNode, *, workflow_id: str, storage: str) -> Any:
    """Execute the DAG depth-first; persist each step result; resume skips
    persisted steps (ref: workflow durability contract). A step may
    RETURN a StepNode — a continuation (ref: workflow.continuation) —
    which the executor keeps resolving, enabling dynamic/recursive
    workflows with every intermediate step still checkpointed."""
    memo: Dict[str, Any] = {}
    _write_status(storage, workflow_id, "RUNNING")

    def resolve(n: StepNode) -> Any:
        key = n.key()
        if key in memo:
            return memo[key]
        path = _storage_path(storage, workflow_id, key)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out = pickle.load(f)
            memo[key] = out
            return out
        if isinstance(n, EventNode):
            import time as _time

            ep = _event_path(storage, workflow_id, n.event_name)
            deadline = (None if n.timeout is None
                        else _time.time() + n.timeout)
            # an event wait does no work: give the queue slot back while
            # parked, or a capped queue deadlocks when the event depends
            # on a QUEUED workflow's output
            sem = getattr(_slot_ctx, "sem", None)
            if sem is not None:
                sem.release()
            try:
                while not os.path.exists(ep):
                    if deadline is not None and _time.time() > deadline:
                        raise TimeoutError(
                            f"workflow event {n.event_name!r} not "
                            f"delivered within {n.timeout}s")
                    _time.sleep(n.poll_interval)
            finally:
                if sem is not None:
                    sem.acquire()
            with open(ep, "rb") as f:
                out = pickle.load(f)
            _atomic_pickle(path, out)
            memo[key] = out
            return out
        args = [resolve(a) if isinstance(a, StepNode) else a for a in n.args]
        kwargs = {k: (resolve(v) if isinstance(v, StepNode) else v)
                  for k, v in n.kwargs.items()}
        task = ray_tpu_torch.remote(n.fn).options(max_retries=n.max_retries)
        out = ray_tpu_torch.get(task.remote(*args, **kwargs))
        while isinstance(out, StepNode):   # continuation
            out = resolve(out)
        _atomic_pickle(path, out)
        memo[key] = out
        return out

    try:
        out = resolve(node)
    except BaseException as e:
        _write_status(storage, workflow_id, "FAILED", repr(e))
        raise
    _write_status(storage, workflow_id, "SUCCESSFUL")
    return out


def run_async(node: StepNode, *, workflow_id: str, storage: str):
    """Start the workflow on a daemon thread; returns a concurrent
    Future (ref: workflow/api.py run_async returning an ObjectRef). A
    daemon thread, not an executor: a hung workflow must not block
    interpreter exit via the atexit pool join."""
    import threading
    from concurrent.futures import Future

    fut: Future = Future()
    sem = _queue_sem

    def work():
        try:
            if sem is not None:
                _write_status(storage, workflow_id, "QUEUED")
                sem.acquire()
            # transition to RUNNING only after the slot is held: a QUEUED
            # workflow stays cancel()-able for its whole queue wait
            if not fut.set_running_or_notify_cancel():
                if sem is not None:
                    sem.release()
                _write_status(storage, workflow_id, "CANCELLED")
                return
            try:
                _slot_ctx.sem = sem
                try:
                    fut.set_result(run(node, workflow_id=workflow_id,
                                       storage=storage))
                finally:
                    _slot_ctx.sem = None
            finally:
                if sem is not None:
                    sem.release()
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=work, daemon=True).start()
    return fut


def get_status(workflow_id: str, *, storage: str) -> str:
    """RUNNING / SUCCESSFUL / FAILED / NOT_FOUND (ref: workflow
    get_status)."""
    p = os.path.join(storage, workflow_id, "status")
    if not os.path.exists(p):
        return "NOT_FOUND"
    with open(p) as f:
        return f.read().splitlines()[0]


def list_all(*, storage: str) -> List[tuple]:
    """[(workflow_id, status)] for every workflow under the storage dir
    (ref: workflow.list_all)."""
    if not os.path.isdir(storage):
        return []
    return [(wid, get_status(wid, storage=storage))
            for wid in sorted(os.listdir(storage))
            if os.path.isdir(os.path.join(storage, wid))]


def resume(node: StepNode, *, workflow_id: str, storage: str) -> Any:
    """Re-run a FAILED/interrupted workflow; persisted steps are skipped
    (ref: workflow.resume — the DAG is re-supplied since this build
    stores step results, not pickled DAGs)."""
    return run(node, workflow_id=workflow_id, storage=storage)
