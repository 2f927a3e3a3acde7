"""Runtime environments: env_vars, working_dir/py_modules packaging.

Reference: python/ray/runtime_env/ + _private/runtime_env/packaging.py.

Port of tests/test_runtime_env.py, aimed at ray_tpu_torch.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import runtime_env as renv
from torch_runtime_support import reap_orphans  # noqa: F401


def test_validate():
    assert renv.validate(None) == {}
    assert renv.validate({"env_vars": {"A": "1"}}) == {"env_vars": {"A": "1"}}
    with pytest.raises(ValueError, match="not supported"):
        renv.validate({"conda": {"dependencies": ["x"]}})
    with pytest.raises(ValueError, match="unknown"):
        renv.validate({"wat": 1})
    with pytest.raises(TypeError):
        renv.validate({"env_vars": {"A": 1}})


def test_uri_is_content_addressed(tmp_path):
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "mod.py").write_text("X = 1\n")
    u1 = renv.uri_for_directory(str(d))
    u2 = renv.uri_for_directory(str(d))
    assert u1 == u2 and u1.startswith("gcs://pkg_")
    (d / "mod.py").write_text("X = 2\n")
    assert renv.uri_for_directory(str(d)) != u1


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_env_vars_applied_and_restored(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RENV_PROBE": "42"}})
    def read_env():
        return os.environ.get("RENV_PROBE")

    @ray_tpu_torch.remote
    def read_plain():
        return os.environ.get("RENV_PROBE")

    assert ray_tpu_torch.get(read_env.remote()) == "42"
    # a later task on the same worker must not see the leaked var
    assert ray_tpu_torch.get(read_plain.remote()) is None


def test_working_dir_ships_code(cluster, tmp_path):
    d = tmp_path / "wd"
    d.mkdir()
    (d / "shipped_mod.py").write_text("def f():\n    return 'from-pkg'\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(d)})
    def use_mod():
        import shipped_mod

        return shipped_mod.f()

    assert ray_tpu_torch.get(use_mod.remote()) == "from-pkg"


def test_py_modules_on_actor(cluster, tmp_path):
    d = tmp_path / "mods"
    d.mkdir()
    (d / "actor_dep.py").write_text("VALUE = 7\n")

    @ray_tpu_torch.remote
    class A:
        def get(self):
            import actor_dep

            return actor_dep.VALUE

    a = A.options(runtime_env={"py_modules": [str(d)]}).remote()
    assert ray_tpu_torch.get(a.get.remote()) == 7


def test_process_env_vars_keyed_pool(cluster):
    """process_env_vars must exist before worker start (pre-import vars
    like XLA_FLAGS), so they key dedicated worker pools
    (ref: worker_pool.h:156 runtime-env-keyed pools)."""

    @ray_tpu_torch.remote
    def probe():
        # read at execution time, but set at PROCESS SPAWN: a per-task
        # env patch could not fake a pre-import variable, so also return
        # the pid to prove pool separation
        return os.environ.get("RT_POOL_MARK"), os.getpid()

    plain_mark, plain_pid = ray_tpu_torch.get(probe.remote())
    assert plain_mark is None

    env = {"process_env_vars": {"RT_POOL_MARK": "a"}}
    mark_a, pid_a = ray_tpu_torch.get(
        probe.options(runtime_env=env).remote())
    assert mark_a == "a"
    assert pid_a != plain_pid  # dedicated worker, not the plain pool's

    # same env key reuses the pool's worker; different key gets another
    mark_a2, pid_a2 = ray_tpu_torch.get(
        probe.options(runtime_env=env).remote())
    assert (mark_a2, pid_a2) == ("a", pid_a)
    mark_b, pid_b = ray_tpu_torch.get(probe.options(
        runtime_env={"process_env_vars": {"RT_POOL_MARK": "b"}}).remote())
    assert mark_b == "b" and pid_b not in (pid_a, plain_pid)

    # plain tasks never land on env-keyed workers
    m, pid = ray_tpu_torch.get(probe.remote())
    assert m is None and pid not in (pid_a, pid_b)


def test_process_env_vars_on_actor(cluster):
    @ray_tpu_torch.remote
    class A:
        def mark(self):
            return os.environ.get("RT_POOL_MARK")

    a = A.options(runtime_env={
        "process_env_vars": {"RT_POOL_MARK": "actor"}}).remote()
    assert ray_tpu_torch.get(a.mark.remote()) == "actor"
    ray_tpu_torch.kill(a)
