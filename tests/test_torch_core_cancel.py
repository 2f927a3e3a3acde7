"""ray_tpu_torch.cancel (ref: ray.cancel semantics, core_worker.cc CancelTask):
queued tasks drop from the submit queue; executing tasks get
KeyboardInterrupt injected (force=True kills the worker); finished tasks
are a no-op; cancelled tasks never retry.

Port of tests/test_core_cancel.py, aimed at ray_tpu_torch.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.status import TaskCancelledError
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401


@pytest.mark.slow
def test_cancel_queued_task(ray_start_regular, tmp_path):
    """A task parked behind a long-running one cancels without ever
    executing."""
    marker = str(tmp_path / "hog_started")

    @ray_tpu_torch.remote(num_cpus=4)
    def hog(path):
        with open(path, "w") as f:
            f.write("started")
        time.sleep(8)
        return "hog"

    @ray_tpu_torch.remote(num_cpus=4)
    def later():
        return "ran"

    h = hog.remote(marker)
    # Barrier: wait until hog is verifiably EXECUTING (worker spawned,
    # lease granted, all 4 CPUs held) before submitting the victim — under
    # full-suite load worker cold-spawn can take tens of seconds, and
    # without the barrier that spawn time eats the victim-get timeout.
    deadline = time.time() + 90
    while time.time() < deadline and not os.path.exists(marker):
        time.sleep(0.1)
    assert os.path.exists(marker), "hog never started executing"
    queued = later.remote()     # can't schedule: hog holds all 4 CPUs
    time.sleep(0.3)             # let the submit reach the queue
    ray_tpu_torch.cancel(queued)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(queued, timeout=60)
    assert ray_tpu_torch.get(h, timeout=120) == "hog"   # victim unaffected




def _start_and_wait(make_ref, timeout=60.0):
    """Submit a spin task via make_ref(marker_path) and block until its
    marker file appears (the task is verifiably executing)."""
    import os
    import tempfile

    marker = tempfile.mktemp()
    ref = make_ref(marker)
    deadline = time.time() + timeout
    while time.time() < deadline and not os.path.exists(marker):
        time.sleep(0.1)
    assert os.path.exists(marker), "task never started"
    return ref

def test_cancel_running_task(ray_start_regular):
    @ray_tpu_torch.remote
    def spin(path):
        import time as t

        with open(path, "w") as f:
            f.write("started")
        while True:        # pure-python loop: interrupt lands promptly
            t.sleep(0.01)

    ref = _start_and_wait(spin.remote)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)


def test_cancel_force_kills_worker(ray_start_regular):
    @ray_tpu_torch.remote(max_retries=3)
    def spin2(path):
        import time as t

        with open(path, "w") as f:
            f.write("started")
        while True:
            t.sleep(0.01)

    ref = _start_and_wait(spin2.remote)
    ray_tpu_torch.cancel(ref, force=True)
    # despite max_retries=3, a force-cancelled task must NOT retry
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)


def test_cancel_finished_task_noop(ray_start_regular):
    @ray_tpu_torch.remote
    def quick():
        return 7

    ref = quick.remote()
    assert ray_tpu_torch.get(ref, timeout=60) == 7
    ray_tpu_torch.cancel(ref)            # no-op
    assert ray_tpu_torch.get(ref, timeout=5) == 7


def test_cancel_running_actor_method(ray_start_regular):
    """Actor-call refs route the interrupt to the actor's worker; the
    actor SURVIVES (only the method's thread is interrupted) and serves
    subsequent calls."""
    @ray_tpu_torch.remote
    class Worker:
        def spin(self, path):
            with open(path, "w") as f:
                f.write("started")
            while True:
                time.sleep(0.01)

        def ping(self):
            return "pong"

    a = Worker.remote()
    ref = _start_and_wait(a.spin.remote)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)
    # the actor itself lives on
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    ray_tpu_torch.kill(a)


def test_cancel_recursive_unimplemented(ray_start_regular):
    @ray_tpu_torch.remote
    def quick():
        return 1

    ref = quick.remote()
    with pytest.raises(NotImplementedError):
        ray_tpu_torch.cancel(ref, recursive=True)
    assert ray_tpu_torch.get(ref, timeout=30) == 1
