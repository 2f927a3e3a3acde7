"""ObjectRef's finalizer during a cyclic garbage collection
(ray_tpu_torch/core/common.py).

A collection runs the finalizers of the cycles it breaks at whatever
allocation triggered it, also inside the runtime's own critical sections
on that thread. ``Runtime._entry`` allocates an ``_ObjectEntry`` under
``_dir_lock``; an ObjectRef freed there (one kept in a cycle by an
exception's traceback, as a serve proxy's retry loop keeps the failed
attempt's ref) whose release reached ``_free_object`` took ``_dir_lock``
again and deadlocked the thread, and every later call of that process
hung behind it. ``ObjectRef.__del__`` now hands a release made during a
collection to the runtime's loop thread (``Runtime.drop_ref_soon``); a
release made by a plain ``del`` stays synchronous.
"""

import gc
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.common import ObjectRef, RuntimeAddress
from ray_tpu_torch.core.ids import ObjectID
from torch_runtime_support import ray_start_regular  # noqa: F401


class _Refs:
    def __init__(self):
        self.deleted = []

    def on_ref_deleted(self, oid, owner):
        self.deleted.append(oid)


class _Runtime:
    """What ObjectRef.__del__ reaches of a runtime."""

    def __init__(self):
        self.refs = _Refs()
        self.soon = []

    def drop_ref_soon(self, oid, owner):
        self.soon.append(oid)


def _ref(rt):
    ref = ObjectRef(ObjectID.from_random(),
                    RuntimeAddress("127.0.0.1", 1, b"w"), _register=False)
    ref._runtime = rt
    return ref


def test_plain_del_releases_at_once():
    rt = _Runtime()
    ref = _ref(rt)
    oid = ref.id
    del ref
    assert rt.refs.deleted == [oid] and rt.soon == []


def test_release_during_a_collection_goes_to_the_loop():
    rt = _Runtime()
    ref = _ref(rt)
    oid = ref.id
    cycle = [ref]
    cycle.append(cycle)
    del ref, cycle
    gc.collect()
    assert rt.soon == [oid] and rt.refs.deleted == []


def test_collection_under_the_directory_lock_frees_without_deadlock(
        ray_start_regular):
    rt = runtime_mod.get_runtime()
    ref = ray_tpu_torch.put(123)
    oid = ref.id
    assert oid in rt.directory
    cycle = [ref]
    cycle.append(cycle)
    del ref, cycle

    def collect_under_lock():
        # what Runtime._entry does when its allocation triggers the
        # collection: hold _dir_lock while the finalizers run
        with rt._dir_lock:
            gc.collect()

    t = threading.Thread(target=collect_under_lock, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive(), \
        "the ref's finalizer deadlocked on the runtime's _dir_lock"
    deadline = time.monotonic() + 10
    while oid in rt.directory:
        assert time.monotonic() < deadline, "the released object was kept"
        time.sleep(0.01)
