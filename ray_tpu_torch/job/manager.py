"""Job supervisor + client.

Port of ray_tpu/job/manager.py over the port's runtime. Reference:
dashboard/modules/job/job_manager.py — JobSupervisor (:140) is an
actor that runs the entrypoint as a subprocess, polls it, and exposes
status/logs; JobManager (:516) tracks jobs in GCS KV.

The supervisor holds 0.1 CPU and no GPU unit, as the reference's holds no
TPU: an entrypoint that uses the card does so outside the scheduler's
count. Its log is ``jobs/<job_id>.log`` under the port's session root
(``core.node.session_root()``). ``stop_job`` ends the entrypoint's whole
process group and returns once it has exited (a CUDA process frees its
card memory only then).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import ray_tpu_torch


# how long stop() waits for the entrypoint's process group after SIGTERM
# before it SIGKILLs it
STOP_TIMEOUT_S = 30.0


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@ray_tpu_torch.remote
class JobSupervisor:
    """One per job; owns the entrypoint subprocess."""

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[dict] = None,
                 working_dir: Optional[str] = None):
        import subprocess

        from ray_tpu_torch.core.node import session_root

        self.job_id = job_id
        self.entrypoint = entrypoint
        log_dir = os.path.join(session_root(), "jobs")
        os.makedirs(log_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, f"{job_id}.log")
        env = dict(os.environ)
        for k, v in (runtime_env or {}).get("env_vars", {}).items():
            env[k] = str(v)
        self.logf = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            entrypoint, shell=True, stdout=self.logf, stderr=self.logf,
            cwd=working_dir or os.getcwd(), env=env,
            start_new_session=True)
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.stopped = False

    def status(self) -> str:
        rc = self.proc.poll()
        if rc is None:
            return JobStatus.RUNNING
        if self.end_time is None:
            self.end_time = time.time()
            self.logf.flush()
        if self.stopped:
            return JobStatus.STOPPED
        return JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED

    def logs(self) -> str:
        self.logf.flush()
        try:
            with open(self.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, timeout_s: float = STOP_TIMEOUT_S) -> bool:
        """SIGTERM the entrypoint's process group (it leads its own
        session), wait until no process of the group is left, SIGKILL the
        group at ``timeout_s``."""
        import signal

        if self.proc.poll() is None:
            self.stopped = True
            pgid = self.proc.pid
            deadline = time.time() + timeout_s
            sig = signal.SIGTERM
            while True:
                try:
                    os.killpg(pgid, sig)
                except ProcessLookupError:
                    break
                except PermissionError:
                    self.proc.kill()
                    break
                self.proc.poll()
                if sig == signal.SIGTERM:
                    sig = 0
                if time.time() > deadline:
                    sig = signal.SIGKILL
                time.sleep(0.05)
            self.proc.wait()
        return True

    def info(self) -> dict:
        return {"job_id": self.job_id, "entrypoint": self.entrypoint,
                "status": self.status(), "start_time": self.start_time,
                "end_time": self.end_time}


class JobSubmissionClient:
    """ref: python/ray/job_submission SDK surface. Two transports, like
    the reference: an `http://host:port` address targets the dashboard
    head's REST module (job_head.py routes); a `host:port` (or None)
    address connects as a driver and supervises actors directly."""

    def __init__(self, address: Optional[str] = None):
        self._http = None
        if address and address.startswith("http"):
            self._http = address.rstrip("/")
            self._n = 0
            return
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        self._n = 0

    # ---- http transport (ref: job SDK's _do_request) ----

    def _rest(self, method: str, path: str, body: Optional[dict] = None):
        import urllib.request

        req = urllib.request.Request(
            self._http + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   working_dir: Optional[str] = None,
                   submission_id: Optional[str] = None) -> str:
        if self._http:
            return self._rest("POST", "/api/jobs/", {
                "entrypoint": entrypoint, "runtime_env": runtime_env,
                "working_dir": working_dir,
                "submission_id": submission_id})["job_id"]
        job_id = submission_id or f"raytpu-job-{int(time.time())}-{self._n}"
        self._n += 1
        sup = JobSupervisor.options(
            name=f"_job_{job_id}", namespace="job",
            num_cpus=0.1, max_concurrency=4).remote(
            job_id, entrypoint, runtime_env, working_dir)
        # register in GCS KV for listing
        from ray_tpu_torch.core import runtime as rt

        rt.get_runtime().kv_put("jobs", job_id.encode(),
                                json.dumps({"entrypoint": entrypoint,
                                            "submitted": time.time()}).encode())
        return job_id

    def _sup(self, job_id: str):
        return ray_tpu_torch.get_actor(f"_job_{job_id}", namespace="job")

    def get_job_status(self, job_id: str) -> str:
        if self._http:
            return self._rest("GET", f"/api/jobs/{job_id}")["status"]
        return ray_tpu_torch.get(self._sup(job_id).status.remote())

    def get_job_logs(self, job_id: str) -> str:
        if self._http:
            return self._rest("GET", f"/api/jobs/{job_id}/logs")["logs"]
        return ray_tpu_torch.get(self._sup(job_id).logs.remote())

    def get_job_info(self, job_id: str) -> dict:
        if self._http:
            return self._rest("GET", f"/api/jobs/{job_id}")
        return ray_tpu_torch.get(self._sup(job_id).info.remote())

    def stop_job(self, job_id: str) -> bool:
        if self._http:
            return self._rest("POST",
                              f"/api/jobs/{job_id}/stop")["stopped"]
        return ray_tpu_torch.get(self._sup(job_id).stop.remote())

    def list_jobs(self) -> List[str]:
        if self._http:
            return [j if isinstance(j, str) else j.get("job_id")
                    for j in self._rest("GET", "/api/jobs/")]
        from ray_tpu_torch.core import runtime as rt

        return [k.decode() for k in
                rt.get_runtime().gcs_call("kv_keys", ns="jobs")]

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(job_id)
            if st in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return st
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")
