"""ray_tpu_torch.job: job submission.

Reference: dashboard/modules/job/ — JobManager/JobSupervisor actor
(job_manager.py:516,140) + SDK (sdk.py) + CLI. A job is an entrypoint shell
command run under a supervisor actor on the cluster; status/logs are queryable.

    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient("127.0.0.1:6379")
    job_id = client.submit_job(entrypoint="python my_script.py")
    client.get_job_status(job_id)   # PENDING/RUNNING/SUCCEEDED/FAILED
    client.get_job_logs(job_id)
"""

from ray_tpu_torch.job.manager import JobStatus, JobSubmissionClient

__all__ = ["JobSubmissionClient", "JobStatus"]
