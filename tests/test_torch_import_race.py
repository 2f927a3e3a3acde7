"""Concurrent unpickles that import one package (ray_tpu_torch/core/
serialization.py ``IMPORT_LOCK``).

A worker process starts several actors at once, each on its own lane
thread, and each lane unpickles its class and its inline arguments. An
unpickle imports the module a class lives in. When one thread runs a
package's ``__init__`` while another enters one of its submodules
directly (the parent is already in ``sys.modules``, so CPython does not
wait for it), the two can each hold a module lock the other needs; CPython
breaks that cycle by handing one of them a partially initialised module,
and its ``from ... import`` raises ImportError. That is how a rollout
actor of ``ray_tpu_torch.rl`` failed to start in a worker that was
constructing another trainer's actor beside it. The unpickles that start
a task or an actor now take one lock, so their imports run one at a time.

The package below forces the interleaving with events: thread B runs the
package's ``__init__`` and enters ``x``; thread A enters ``y`` first and
then needs ``x``, while ``x`` needs ``y``. Alone, either entry imports
cleanly.
"""

import sys
import threading
import types
import uuid

import pytest

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.runtime import Runtime
from ray_tpu_torch.core.worker import Worker

WAIT_S = 1.0

_INIT = """\
import {sync} as s
s.b_in_init.set()
s.a_in_y.wait({wait})
from {pkg}.x import thing
"""

_X = """\
import time
import {sync} as s
thing = 1
s.b_in_x.set()
time.sleep(0.3)
from {pkg}.y import Y
"""

_Y = """\
import {sync} as s
s.a_in_y.set()
s.b_in_x.wait({wait})
from {pkg}.x import thing
class Y:
    pass
"""

_SYNC = """\
import threading
b_in_init = threading.Event()
a_in_y = threading.Event()
b_in_x = threading.Event()
"""


@pytest.fixture
def race_pkg(tmp_path, monkeypatch):
    tag = uuid.uuid4().hex[:8]
    pkg, sync = f"racepkg_{tag}", f"racepkg_sync_{tag}"
    (tmp_path / pkg).mkdir()
    fmt = {"pkg": pkg, "sync": sync, "wait": WAIT_S}
    (tmp_path / pkg / "__init__.py").write_text(_INIT.format(**fmt))
    (tmp_path / pkg / "x.py").write_text(_X.format(**fmt))
    (tmp_path / pkg / "y.py").write_text(_Y.format(**fmt))
    (tmp_path / f"{sync}.py").write_text(_SYNC)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield pkg, sync
    for name in [n for n in sys.modules
                 if n in (pkg, sync) or n.startswith(pkg + ".")]:
        del sys.modules[name]


def _global(module: str, name: str) -> bytes:
    """A pickle that loads ``module.name`` by reference, as a class or a
    function of an installed module is pickled."""
    return b"\x80\x02c" + f"{module}\n{name}\n".encode() + b"."


def _load_function(blob: bytes):
    fake = types.SimpleNamespace(_fn_cache={}, kv_get=lambda ns, fid: blob)
    return Runtime.load_function(fake, b"fid")


def _resolve_args(blob: bytes):
    out = bytearray(serialization.serialized_size(blob, []))
    serialization.write_to(memoryview(out), blob, [])
    spec = types.SimpleNamespace(args=[("v", bytes(out))])
    args, _ = Worker._resolve_args(types.SimpleNamespace(runtime=None), spec)
    return args[0]


@pytest.mark.parametrize("entry_b,entry_a", [
    (_load_function, _load_function),
    (_resolve_args, _resolve_args),
    (_resolve_args, _load_function),
], ids=["class_and_class", "args_and_args", "args_and_class"])
def test_concurrent_unpickles_import_one_package(race_pkg, entry_b, entry_a):
    pkg, sync = race_pkg
    errors, loaded = {}, {}

    def run(who, entry, blob):
        try:
            loaded[who] = entry(blob)
        except BaseException as e:  # noqa: BLE001 - the test's verdict
            errors[who] = e

    b = threading.Thread(target=run,
                         args=("b", entry_b, _global(f"{pkg}.x", "thing")))
    b.start()
    assert __import__(sync).b_in_init.wait(10)
    a = threading.Thread(target=run,
                         args=("a", entry_a, _global(f"{pkg}.y", "Y")))
    a.start()
    a.join(30)
    b.join(30)
    assert not a.is_alive() and not b.is_alive()
    assert errors == {}
    assert loaded["b"] == 1
    assert loaded["a"] is sys.modules[f"{pkg}.y"].Y
