"""Dask-on-ray_tpu_torch scheduler: execute dask task graphs as remote tasks.

Reference: python/ray/util/dask/ (ray_dask_get in scheduler.py — walks the
dask graph, submits one Ray task per dask task, passes ObjectRefs as
dependencies so the object store carries intermediates). The scheduler
implements dask's documented get(dsk, keys) protocol on plain dicts, so it
needs no dask import itself (dask is not in the TPU image; when present,
use `dask.compute(..., scheduler=ray_tpu_torch_dask_get)`).

Graph spec (dask.core): dsk maps key -> computation, where a computation
is either a literal, a key reference, or a task tuple
(callable, *args) whose args may nest lists/tuples/subtasks.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch

_REMOTE_EXEC = None


def _ishashable(x) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


def _istask(x) -> bool:
    return isinstance(x, tuple) and bool(x) and callable(x[0])


def _execute_task(func, args):
    """Runs inside the worker. Dependency refs arrive nested inside the
    args list (only TOP-level task args auto-resolve, like the
    reference), so materialize them here via the borrower protocol;
    nested task tuples evaluate inline (dask semantics — nested tasks
    are not graph nodes)."""
    return func(*[_eval_inline(a) for a in args])


def _eval_inline(a):
    if isinstance(a, ray_tpu_torch.ObjectRef):
        return ray_tpu_torch.get(a)
    if _istask(a):
        return _execute_task(a[0], a[1:])
    if isinstance(a, list):
        return [_eval_inline(x) for x in a]
    if isinstance(a, tuple):
        return tuple(_eval_inline(x) for x in a)
    return a


def _remote_exec():
    global _REMOTE_EXEC
    if _REMOTE_EXEC is None:
        _REMOTE_EXEC = ray_tpu_torch.remote(_execute_task)
    return _REMOTE_EXEC


def ray_tpu_torch_dask_get(dsk: Dict[Hashable, Any], keys, **kwargs):
    """The dask scheduler entry point (ref: scheduler.py ray_dask_get).
    Topologically submits one remote task per graph node; dependencies
    flow as ObjectRefs resolved by the runtime, intermediates live in the
    object store. `keys` may be a single key or (nested) lists of keys,
    mirroring dask.get."""
    refs: Dict[Hashable, Any] = {}

    def submit(key):
        if key in refs:
            return refs[key]
        comp = dsk[key]
        refs[key] = _submit_computation(comp)
        return refs[key]

    def _resolve_arg(a):
        # a graph-key reference becomes that node's ObjectRef
        if _ishashable(a) and not _istask(a) and a in dsk:
            return submit(a)
        if _istask(a):
            # nested task: keep as data, evaluated inline in the worker,
            # but its key references must resolve first
            return (a[0],) + tuple(_resolve_arg(x) for x in a[1:])
        if isinstance(a, list):
            return [_resolve_arg(x) for x in a]
        return a

    def _submit_computation(comp):
        if _istask(comp):
            func, args = comp[0], [_resolve_arg(a) for a in comp[1:]]
            return _remote_exec().remote(func, args)
        if _ishashable(comp) and comp in dsk:
            return submit(comp)  # alias key
        return comp  # literal

    def _gather(ks):
        if isinstance(ks, list):
            return [_gather(k) for k in ks]
        ref = submit(ks)
        return ray_tpu_torch.get(ref) if isinstance(ref, ray_tpu_torch.ObjectRef) else ref

    if isinstance(keys, list):
        return [_gather(k) for k in keys]
    return _gather(keys)


# alias matching the reference's public name
ray_dask_get = ray_tpu_torch_dask_get
