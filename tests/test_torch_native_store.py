"""Native store + transfer plane unit tests (objstore.cc / xfer.cc).

Reference test model: src/ray/object_manager/test/ and plasma store
tests — direct store-API semantics, including the deferred-delete
protection for pinned objects.

Port of tests/test_native_store.py, aimed at ray_tpu_torch.
"""

import numpy as np
import pytest

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import SharedMemoryStore
from torch_runtime_support import reap_orphans, segment_name  # noqa: F401


@pytest.fixture
def stores():
    a = SharedMemoryStore(segment_name("a"), capacity=32 << 20, create=True)
    b = SharedMemoryStore(segment_name("b"), capacity=32 << 20, create=True)
    yield a, b
    a.xfer_serve_stop()
    a.close(destroy=True)
    b.close(destroy=True)


def test_delete_defers_while_pinned(stores):
    a, _ = stores
    oid = ObjectID.from_random()
    payload = b"x" * 4096
    assert a.put_bytes(oid, payload)
    used_with_obj = a.bytes_in_use()
    view = a.get_view(oid)           # pin
    a.delete(oid)                    # must defer, not free under the view
    assert not a.contains(oid)       # logically deleted immediately...
    assert a.bytes_in_use() == used_with_obj   # ...but heap NOT freed yet
    assert bytes(view) == payload    # bytes intact while pinned
    del view
    a.release(oid)                   # last release performs the free
    assert a.state(oid) == 0
    assert a.bytes_in_use() < used_with_obj


def test_delete_during_create_frees_on_seal(stores):
    a, _ = stores
    oid = ObjectID.from_random()
    view = a.create_view(oid, 1024)
    a.delete(oid)                    # arrives mid-write
    view[:4] = b"abcd"
    del view
    a.seal(oid)                      # seal resolves to a free
    assert a.state(oid) == 0


def test_xfer_roundtrip_and_statuses(stores):
    a, b = stores
    port = a.xfer_serve_start("127.0.0.1")
    assert port > 0
    oid = ObjectID.from_random()
    payload = np.random.default_rng(0).bytes(2 << 20)
    assert a.put_bytes(oid, payload)

    rc, total = b.xfer_fetch("127.0.0.1", port, oid)
    assert rc == 0 and total == len(payload)
    got = b.get_view(oid)
    assert bytes(got) == payload
    del got
    b.release(oid)

    # absent at source
    assert b.xfer_fetch("127.0.0.1", port, ObjectID.from_random())[0] == 1
    # already local -> 5 (NOT 3: callers must not spill for a duplicate)
    assert b.xfer_fetch("127.0.0.1", port, oid)[0] == 5
    # connection refused
    assert b.xfer_fetch("127.0.0.1", 1, oid)[0] == 2


def test_xfer_delete_race_keeps_stream_intact(stores):
    """Delete at the source mid-serve must not corrupt the receiver: the
    send-side pin defers the free until the stream finishes."""
    import threading

    a, b = stores
    port = a.xfer_serve_start("127.0.0.1")
    payload = np.random.default_rng(1).bytes(8 << 20)
    oid = ObjectID.from_random()
    assert a.put_bytes(oid, payload)

    results = {}

    def fetch():
        results["rc"] = b.xfer_fetch("127.0.0.1", port, oid)[0]

    t = threading.Thread(target=fetch)
    t.start()
    a.delete(oid)   # races the in-flight send; free must be deferred
    t.join()
    if results["rc"] == 0:           # transfer won the race
        got = b.get_view(oid)
        assert bytes(got) == payload
        del got
        b.release(oid)
    else:                            # delete won before the pin landed
        assert results["rc"] == 1


def test_reap_orphaned_creating_entries(stores):
    """A producer that dies mid-write leaves kCreating forever; the
    reaper frees it (age 0 here) so the id becomes creatable again."""
    a, _ = stores
    oid = ObjectID.from_random()
    view = a.create_view(oid, 2048)
    del view               # producer "dies": no seal, no abort
    assert a.state(oid) == 1
    assert a.create_view(oid, 2048) is None   # id blocked by the orphan
    assert a.reap_creating(0) == 1
    assert a.state(oid) == 0
    v2 = a.create_view(oid, 2048)              # creatable again
    assert v2 is not None
    del v2
    a.seal(oid)
    assert a.contains(oid)
    # a live (young) creating entry is NOT reaped at a sane age
    oid2 = ObjectID.from_random()
    v3 = a.create_view(oid2, 64)
    assert a.reap_creating(300) == 0
    del v3
    a.abort(oid2)


def test_concurrent_first_builds_never_load_a_partial_library(tmp_path):
    """Six processes building the library into one empty directory at
    once (a test run whose workers each start a cluster on a fresh
    checkout) all load a whole library. The JAX package's in-place
    ``make`` races here: a process dlopens a file another is still
    writing ("file too short") and its nodelet dies at startup."""
    import subprocess
    import sys

    code = (
        "import ctypes, sys\n"
        "import ray_tpu_torch.native as n\n"
        "n.BUILD_DIR = sys.argv[1]\n"
        "n.OBJSTORE_SO = sys.argv[1] + '/libraytpu_objstore.so'\n"
        "ctypes.CDLL(n.ensure_built())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stderr=subprocess.PIPE)
             for _ in range(6)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, errs
    assert [f.name for f in tmp_path.iterdir()] == ["libraytpu_objstore.so"]
