"""Fixtures of the port's runtime tests (tests/test_torch_*.py).

``tests/conftest.py`` starts the JAX package's clusters and reaps its
daemons (``python -m ray_tpu.core.*``); it gains no fixtures. The port's
runtime tests import from here instead:

- ``ray_start_regular`` / ``ray_start_cluster``: conftest's fixtures of
  the same names, on ``ray_tpu_torch`` (ref: python/ray/tests/conftest.py);
- ``ray_start_8cpu``: ``ray_start_regular`` with 8 CPUs, for the serve
  tests whose fleets need more actors at once than 4 CPUs place (the
  JAX package's serve tests define it in each file);
- ``reap_orphans`` (session-scoped, autouse in every module that imports
  it): kills this run's ``python -m ray_tpu_torch.core.*`` daemons that an
  earlier run orphaned (PPID 1: chaos, GCS-FT and cluster tests SIGKILL
  daemons mid-test and their children reparent to init) and removes this
  run's test shm segments that no live process maps, as conftest does for
  the JAX package's, and the port's cluster segments that no process has
  mapped for an hour.

The reaper acts only on what carries this run's tag, ``RUN_TAG``: a hash
of the checkout's path and the temp dir. Importing this module puts the
tag in ``RAY_TPU_TORCH_TEST_RUN``, which every daemon and worker the tests
start inherits, and ``segment_name`` puts it in a test segment's name. So
two checkouts whose suites run at once never reap each other's processes
or test segments. A cluster segment (``/rtorch_<node id>``) carries no
tag; every live nodelet maps its own, so one unmapped for an hour belongs
to no live run.

A test file imports the names it uses:
``from torch_runtime_support import ray_start_regular, reap_orphans``.
"""

from __future__ import annotations

import glob
import hashlib
import os
import signal
import tempfile
import time

import pytest

from ray_tpu_torch.core.node import port_processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TAG = hashlib.sha1(
    f"{REPO}\0{tempfile.gettempdir()}".encode()).hexdigest()[:12]
RUN_ENV = "RAY_TPU_TORCH_TEST_RUN"
os.environ[RUN_ENV] = RUN_TAG
SHM_TEST_PREFIX = f"/rtorch_test_{RUN_TAG}_"


def segment_name(name: str) -> str:
    """The shm name of a test's store segment, carrying this run's tag."""
    return SHM_TEST_PREFIX + name


def _shm_segments_in_use():
    """Names of /dev/shm segments mapped by any live process
    (/proc/*/maps is authoritative; a segment's mtime is not)."""
    used = set()
    for maps in glob.glob("/proc/[0-9]*/maps"):
        try:
            with open(maps) as f:
                for line in f:
                    i = line.find("/dev/shm/")
                    if i >= 0:
                        used.add(line[i:].split()[0])
        except OSError:
            continue
    return used


def _of_this_run(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
    except OSError:
        return False
    return f"{RUN_ENV}={RUN_TAG}".encode() in env


def reap_orphan_daemons():
    """Kill this run's port daemons whose parent is init. A healthy
    in-run cluster keeps its GCS and nodelets parented to the driver and
    its workers to their nodelet, so a PPID-1 daemon can only be leakage.
    RAY_TPU_NO_REAP=1 protects a deliberately daemonized cluster."""
    if os.environ.get("RAY_TPU_NO_REAP"):
        return
    for pid, (_, ppid) in port_processes().items():
        if ppid == 1 and _of_this_run(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                continue


def reap_shm_segments():
    """Unlink this run's test segments that no live process maps, and
    the port's other segments that are unmapped and over an hour old."""
    now = time.time()
    in_use = _shm_segments_in_use()
    for p in glob.glob("/dev/shm/rtorch_*"):
        if p in in_use:
            continue
        try:
            if p.startswith("/dev/shm" + SHM_TEST_PREFIX) or (
                    not p.startswith("/dev/shm/rtorch_test_")
                    and now - os.path.getmtime(p) > 3600):
                os.unlink(p)
        except OSError:
            pass


@pytest.fixture(scope="session", autouse=True)
def reap_orphans():
    reap_orphan_daemons()
    reap_shm_segments()
    yield


@pytest.fixture(scope="function")
def ray_start_regular():
    import ray_tpu_torch

    info = ray_tpu_torch.init(
        num_cpus=4, ignore_reinit_error=True,
        _system_config={"health_check_period_s": 0.2,
                        "worker_idle_timeout_s": 60.0})
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="function")
def ray_start_8cpu():
    import ray_tpu_torch

    info = ray_tpu_torch.init(
        num_cpus=8, ignore_reinit_error=True,
        _system_config={"health_check_period_s": 0.2,
                        "worker_idle_timeout_s": 60.0})
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="function")
def ray_start_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False,
                      system_config={"health_check_period_s": 0.2,
                                     "health_check_failure_threshold": 5})
    yield cluster
    cluster.shutdown()
