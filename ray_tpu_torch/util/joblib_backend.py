"""joblib backend running batches on ray_tpu_torch actors.

Reference: python/ray/util/joblib/ — `register_ray()` +
`with joblib.parallel_backend("ray_tpu_torch"):` routes scikit-learn style
joblib.Parallel work onto the cluster.
"""

from __future__ import annotations

from joblib.parallel import ParallelBackendBase, register_parallel_backend

import ray_tpu_torch


class RayTpuBackend(ParallelBackendBase):
    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._pool = None

    def configure(self, n_jobs=1, parallel=None, **backend_args):
        from ray_tpu_torch.util.multiprocessing import Pool

        n_jobs = self.effective_n_jobs(n_jobs)
        self._pool = Pool(processes=n_jobs)
        self.parallel = parallel
        return n_jobs

    def effective_n_jobs(self, n_jobs):
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        if n_jobs is None:
            n_jobs = 1
        if n_jobs < 0:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            n_jobs = max(total + 1 + n_jobs, 1)
        return n_jobs

    def apply_async(self, func, callback=None):
        return self._pool.apply_async(func, callback=callback)

    def terminate(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def abort_everything(self, ensure_ready=True):
        self.terminate()
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs,
                           parallel=self.parallel)

    def get_nested_backend(self):
        from joblib._parallel_backends import SequentialBackend

        return SequentialBackend(nesting_level=self.nesting_level + 1), None


def register_ray() -> None:
    """ref: ray.util.joblib.register_ray."""
    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
