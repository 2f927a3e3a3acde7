"""ray_tpu_torch.workflow: durable step execution.

Reference: python/ray/workflow/ (api.py:166 run_async, task_executor.py,
storage/) — every step's result is persisted so a crashed workflow resumes
from completed steps instead of recomputing.

    from ray_tpu_torch import workflow

    @workflow.step
    def fetch(): ...

    @workflow.step
    def process(x): ...

    out = workflow.run(process.bind(fetch.bind()),
                       workflow_id="my-flow", storage="/tmp/wf")
    # re-running with the same workflow_id skips completed steps
"""

from ray_tpu_torch.workflow.api import (EventNode, StepNode, get_status,
                                        list_all, resume, run, run_async,
                                        send_event, set_max_running, step,
                                        wait_for_event)

__all__ = ["step", "run", "run_async", "resume", "get_status",
           "list_all", "StepNode", "EventNode", "wait_for_event",
           "send_event", "set_max_running"]
