"""Error and exception model.

Reference: src/ray/common/status.h (C++ Status codes) and
python/ray/exceptions.py (user-facing exception taxonomy). One module here:
the Python layer is the only consumer in ray_tpu_torch, the native store reports
errors via return codes.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised; carries the remote traceback (ref: RayTaskError)."""

    def __init__(self, cause: BaseException, remote_tb: str):
        self.cause = cause
        self.remote_tb = remote_tb
        super().__init__(f"{type(cause).__name__}: {cause}\n--- remote traceback ---\n{remote_tb}")


class WorkerCrashedError(RayTpuError):
    """The worker executing a task died (ref: WorkerCrashedError)."""


class ActorDiedError(RayTpuError):
    """Actor is dead and (re)start budget is exhausted (ref: RayActorError).

    Carries the dead actor's id (hex) so routing layers can evict the
    exact replica locally instead of waiting for a control-plane probe
    (ref: RayActorError.actor_id), and whether the failed call was ever
    dispatched to the actor's worker: ``dispatched=False`` means the task
    frame provably never reached the worker, so re-running it cannot
    duplicate side effects — routing layers may retry it regardless of
    idempotency (ref: router.py re-dispatches queued-but-unsent requests
    on replica death)."""

    def __init__(self, msg: str = "", actor_id: str = None,
                 dispatched: bool = True):
        super().__init__(msg)
        self.actor_id = actor_id
        self.dispatched = dispatched

    def __reduce__(self):   # keep actor_id/dispatched across pickling
        return (type(self), (self.args[0] if self.args else "",
                             self.actor_id, self.dispatched))


class ActorUnavailableError(RayTpuError):
    """Actor is restarting; call may be retried (ref: ActorUnavailableError).

    ``dispatched`` mirrors ActorDiedError: False ⇒ the call never reached
    the worker, so a retry is side-effect-safe for any method.
    ``actor_id`` (hex), where known, names the restarting actor, so that
    a router can evict that replica as it does a dead one."""

    def __init__(self, msg: str = "", dispatched: bool = True,
                 actor_id: str = None):
        super().__init__(msg)
        self.dispatched = dispatched
        self.actor_id = actor_id

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.dispatched, self.actor_id))


class TaskCancelledError(RayTpuError):
    """Task was cancelled via ray_tpu_torch.cancel (ref: TaskCancelledError)."""


class ObjectLostError(RayTpuError):
    """Object's value was lost and could not be reconstructed
    (ref: ObjectLostError / ObjectReconstructionFailedError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get(..., timeout=) expired (ref: GetTimeoutError)."""


class ObjectStoreFullError(RayTpuError):
    """Host shm tier full and nothing evictable (ref: ObjectStoreFullError)."""


class RuntimeEnvSetupError(RayTpuError):
    """Worker environment failed to materialize (ref: RuntimeEnvSetupError)."""


class PlacementGroupUnavailableError(RayTpuError):
    """Gang reservation infeasible with current cluster shape."""


class NodeDiedError(RayTpuError):
    """Node lost (health-check failure) while hosting the referenced entity."""
