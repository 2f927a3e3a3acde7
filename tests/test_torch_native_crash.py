"""Robust-mutex crash recovery of the native store.

The whole safety story of the in-segment design (objstore.cc:27-30) is
that a process SIGKILLed while HOLDING the store mutex must not deadlock
the node: the next locker gets EOWNERDEAD, marks the mutex consistent,
and the index remains structurally valid (single-word state transitions
last). These tests kill a child at a deterministic point — via the
ts_debug_lock_hold hook, which touches a marker file only after the lock
is acquired — and assert the survivors recover fully.

Port of tests/test_native_crash.py, aimed at ray_tpu_torch.
"""

import ctypes
import os
import signal
import subprocess
import sys
import time

import pytest

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import SharedMemoryStore
from torch_runtime_support import reap_orphans, segment_name  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """\
import ctypes, sys
from ray_tpu_torch.core.object_store import SharedMemoryStore, _Lib
from ray_tpu_torch.core.ids import ObjectID

name, marker = sys.argv[1], sys.argv[2]
store = SharedMemoryStore(name)
lib = _Lib.get()
lib.ts_debug_lock_hold.restype = ctypes.c_int
lib.ts_debug_lock_hold.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
# leave an orphaned kCreating entry, as a producer killed mid-write would
off = lib.ts_create_buf(store._h, b"O" * 20, 1 << 20)
assert off != 0
# then grab the mutex and park; the parent kills us mid-sleep
lib.ts_debug_lock_hold(store._h, marker.encode(), 60_000)
"""


def _spawn_lock_holder(store_name: str, marker: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", CHILD, store_name,
                             marker], env=env)


@pytest.fixture
def store(tmp_path):
    name = segment_name(f"crash_{os.getpid()}")
    s = SharedMemoryStore(name, capacity=32 << 20, create=True)
    yield s
    s.close(destroy=True)


def test_eownerdead_recovery_and_reap(store, tmp_path):
    marker = str(tmp_path / "locked")
    child = _spawn_lock_holder(store.name, marker)
    try:
        deadline = time.time() + 30
        while not os.path.exists(marker):
            assert time.time() < deadline, "child never took the lock"
            assert child.poll() is None, "child died early"
            time.sleep(0.02)
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=10)

        # 1. the mutex died with the child; the next operation must take
        # the EOWNERDEAD path, not deadlock (bound it with a timeout)
        import threading

        done = threading.Event()
        ok = {}

        def op():
            ok["put"] = store.put_bytes(ObjectID(b"P" * 20), b"x" * 1024)
            done.set()

        t = threading.Thread(target=op, daemon=True)
        t.start()
        assert done.wait(timeout=15), \
            "store deadlocked after lock-holder was SIGKILLed"
        assert ok["put"]

        # 2. the child's mid-create entry is an orphan: reap frees it
        lib = store._lib
        lib.ts_reap_creating.restype = ctypes.c_int
        assert store.state(ObjectID(b"O" * 20)) == 1   # still kCreating
        n = lib.ts_reap_creating(store._h, 0)
        assert n >= 1, "orphaned kCreating entry was not reaped"
        assert store.state(ObjectID(b"O" * 20)) == 0

        # 3. free-list consistency: after deleting everything, one
        # allocation of nearly the whole heap must fit — only possible if
        # the orphan's block was returned and coalesced correctly
        store.delete(ObjectID(b"P" * 20))
        cap = lib.ts_capacity(store._h)
        big = ObjectID(b"B" * 20)
        view = store.create_view(big, int(cap * 0.9))
        assert view is not None, "heap fragmented/lost after recovery"
        del view
        store.seal(big)
        assert store.contains(big)
    finally:
        if child.poll() is None:
            child.kill()


@pytest.mark.slow
def test_kill_storm_keeps_store_consistent(store):
    """Probabilistic sweep: children hammer create/seal/delete while the
    parent SIGKILLs them at random points; afterwards the store must
    still be lockable and byte-accounting must close."""
    hammer = """\
import sys, os
from ray_tpu_torch.core.object_store import SharedMemoryStore
from ray_tpu_torch.core.ids import ObjectID

store = SharedMemoryStore(sys.argv[1])
i = 0
while True:
    oid = ObjectID(os.urandom(20))
    if store.put_bytes(oid, b"y" * 4096):
        store.delete(oid)
    i += 1
"""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for round_ in range(6):
        procs = [subprocess.Popen([sys.executable, "-c", hammer,
                                   store.name], env=env)
                 for _ in range(2)]
        time.sleep(1.0 + 0.37 * round_ % 1.0)
        for p in procs:
            os.kill(p.pid, signal.SIGKILL)
            p.wait(timeout=10)
    # survivors recover and the store still works end-to-end
    lib = store._lib
    lib.ts_reap_creating(store._h, 0)
    oid = ObjectID(b"Z" * 20)
    assert store.put_bytes(oid, b"ok" * 512)
    got = store.get_view(oid)
    assert bytes(got[:4]) == b"okok"
    del got
    store.release(oid)
