"""The runtime slice as a whole on the CPU, and its guards.

- An actor holding a ``tiny`` ``LLMEngine(device="cpu")`` gives JAX's tokens
  for ``generate([1, 2, 3, 4, 5], max_new_tokens=6)`` in both KV layouts:
  the JAX engine runs in the test (seed 0) and its weights reach the actor
  through the object store, as numpy (the two RNGs never agree, so the
  weights cross over, as in tests/test_torch_llm_engine.py).
- The engine's two hooks into the runtime: its ``PagePool`` reports its
  held pages x page bytes to the memory plane as a "kv" record, and its
  ``ray_tpu_serve_tokens_generated`` counter advances by the tokens
  generated, in process and read back from the cluster's metrics.
- Guards: no module under ``ray_tpu_torch/`` (nor ``chip_smoke.py``)
  imports ``ray_tpu`` or ``jax``; ``import ray_tpu_torch`` loads neither
  torch nor the runtime; the GCS, the nodelet and a worker that ran a
  plain task map no libtorch.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.llm import LLMEngine
from test_torch_support import REPO, jax_reference, jax_tree_to_np
from torch_runtime_support import ray_start_regular, reap_orphans  # noqa: F401

KNOWN = [35, 235, 215, 5, 21, 5]


class _EngineHolder:
    """Holds a tiny f32 engine built from JAX's weights (a numpy tree)."""

    def __init__(self, params, kv_layout):
        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.serve.llm import LLMEngine

        cfg = llama.PRESETS["tiny"].replace(dtype=torch.float32)
        kw = {"page_size": 16} if kv_layout == "paged" else {}
        self.eng = LLMEngine(cfg=cfg,
                             params=llama.params_from_jax(params, "cpu"),
                             kv_layout=kv_layout, device="cpu", **kw)

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)

    def replica(self):
        return self.eng._m_tokens._default_tags["replica"]

    def flush(self):
        from ray_tpu_torch.core import runtime

        runtime.get_runtime().flush_task_events(wait=True)


@pytest.mark.parametrize("kv_layout", ["paged", "contiguous"])
def test_actor_engine_matches_jax(ray_start_regular, kv_layout):
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jnp.float32)
        kw = {"page_size": 16} if kv_layout == "paged" else {}
        je = ref.llm.LLMEngine(cfg=jcfg, kv_layout=kv_layout, seed=0, **kw)
        want = je.generate([1, 2, 3, 4, 5], max_new_tokens=6)
        params = jax_tree_to_np(je.params)
    assert want == KNOWN
    params_ref = ray_tpu_torch.put(params)
    holder = ray_tpu_torch.remote(num_cpus=1)(_EngineHolder).remote(
        params_ref, kv_layout)
    got = ray_tpu_torch.get(holder.generate.remote([1, 2, 3, 4, 5], 6),
                            timeout=120)
    assert got == want
    # the engine's tokens counter, tagged with the actor's replica id,
    # reaches the cluster's metrics
    tag = ray_tpu_torch.get(holder.replica.remote(), timeout=60)
    assert tag not in ("driver", "local")
    ray_tpu_torch.get(holder.flush.remote(), timeout=60)
    from ray_tpu_torch.core import runtime

    raw = runtime.get_runtime().gcs_call(
        "kv_get", ns="metrics", key=b"ray_tpu_serve_tokens_generated")
    series = json.loads(raw)["series"]
    assert sum(s["value"] for s in series
               if s["tags"].get("replica") == tag) == len(want)


def test_paged_pool_in_memory_plane_and_tokens_counter():
    from ray_tpu_torch.observability import memory

    eng = LLMEngine(preset="tiny", kv_layout="paged", page_size=16,
                    seed=0, device="cpu")
    pool = eng.pool
    assert pool.page_nbytes == (eng.kp.nbytes + eng.vp.nbytes) // \
        pool.num_pages > 0
    recs = memory.tracker()._recs
    before = sum(eng._m_tokens._values.values())
    req = eng.submit(list(range(1, 40)), max_new_tokens=12)
    eng.step_n(4)                       # admitted and decoding: pages held
    assert not req.done_event.is_set()
    rec = recs.get(pool._mem_key)
    assert rec is not None and rec.subsystem == "kv"
    assert rec.nbytes == pool.used_pages * pool.page_nbytes > 0
    assert rec.detail["pages"] == pool.used_pages
    while eng.has_work():
        eng.step_n(4)
    assert len(req.generated) == 12
    assert sum(eng._m_tokens._values.values()) - before == 12
    assert eng.metrics["tokens_generated"] == 12
    # cached prompt pages stay held (evictable) until reclaimed
    assert recs[pool._mem_key].nbytes == pool.used_pages * pool.page_nbytes


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 80
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib", "flax",
                                  "optax")]
    assert bad == []


def test_package_import_is_light():
    code = ("import sys, ray_tpu_torch\n"
            "mods = sorted(m for m in sys.modules\n"
            "              if m == 'torch' or m.startswith(('torch.',\n"
            "                                               'ray_tpu_torch.')))\n"
            "print(mods)\n"
            "ray_tpu_torch.remote\n"
            "print('ray_tpu_torch.core.runtime' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.splitlines()
    assert first == "[]"
    assert second == "True"         # the API loads the runtime on first use


def _maps_torch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


def test_daemons_and_plain_workers_never_load_torch(ray_start_regular):
    import os

    procs = ray_tpu_torch.api._session["procs"]
    assert len(procs) == 2          # the GCS and the nodelet

    @ray_tpu_torch.remote
    def plain(x):
        return os.getpid(), float(np.asarray(x).sum())

    pid, total = ray_tpu_torch.get(plain.remote(np.ones(8)), timeout=60)
    assert total == 8.0
    for p in [*(q.pid for q in procs), pid]:
        assert not _maps_torch(p), p


def test_init_detects_gpus_without_cuda(monkeypatch):
    from ray_tpu_torch.core import node

    monkeypatch.setenv("RAY_TPU_CHIPS", "3")
    assert node.detect_gpus() == 3
    monkeypatch.delenv("RAY_TPU_CHIPS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,2")
    assert node.detect_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert node.detect_gpus() == 0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,-1,3")
    assert node.detect_gpus() == 1
    assert "torch.cuda" not in sys.modules or \
        not torch.cuda.is_initialized()


def test_num_gpus_requests_the_gpu_resource():
    from ray_tpu_torch.core.common import ResourceSet
    from ray_tpu_torch.core.config import Config

    assert Config().chip_resource == "GPU"
    rs = ResourceSet.from_options(num_cpus=1, num_gpus=1, memory=None,
                                  resources=None)
    assert rs.quantities == {"CPU": 1.0, "GPU": 1.0}

    @ray_tpu_torch.remote(num_gpus=1)
    class OnGpu:
        pass

    assert OnGpu._options["num_gpus"] == 1
    assert OnGpu.options(num_gpus=2)._options["num_gpus"] == 2
    with pytest.raises(ValueError, match="num_tpus"):
        OnGpu.options(num_tpus=1)


def test_session_root_follows_the_temp_dir(monkeypatch, tmp_path):
    import os
    import tempfile

    from ray_tpu_torch import runtime_env
    from ray_tpu_torch.core import node
    from ray_tpu_torch.observability import flight

    monkeypatch.delenv("RAY_TPU_TMPDIR", raising=False)
    monkeypatch.delenv("RAY_TPU_SESSION_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    root = tmp_path / "ray_tpu_torch"
    assert node.session_root() == str(root)
    assert flight.default_dir() == str(root / "flight")
    assert runtime_env._cache_root() == str(root / "runtime_resources")
    session = node.new_session_dir()
    assert os.path.dirname(session) == str(root)
    assert os.path.realpath(root / "session_latest") == \
        os.path.realpath(session)
    monkeypatch.setenv("RAY_TPU_TMPDIR", str(tmp_path / "other"))
    assert node.session_root() == str(tmp_path / "other")


def test_session_processes_found_and_gone_after_shutdown():
    import os
    import time

    from ray_tpu_torch.core.node import pid_alive, session_pids

    info = ray_tpu_torch.init(num_cpus=1)
    try:
        roots = {p.pid for p in info["procs"]}

        @ray_tpu_torch.remote
        def worker_pid():
            return os.getpid()

        wpid = ray_tpu_torch.get(worker_pid.remote(), timeout=60)
        found = session_pids(roots)
        assert sorted(found[p] for p in roots) == [
            "ray_tpu_torch.core.gcs", "ray_tpu_torch.core.nodelet"]
        assert found[wpid] == "ray_tpu_torch.core.worker"
        assert all(pid_alive(p) for p in found)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 30
    while time.time() < deadline and any(pid_alive(p) for p in found):
        time.sleep(0.2)
    assert not [p for p in found if pid_alive(p)]


def test_reaper_acts_only_on_its_runs_tag(monkeypatch):
    import os
    import signal

    import torch_runtime_support as trs

    monkeypatch.delenv("RAY_TPU_NO_REAP", raising=False)
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    mine = subprocess.Popen(sleep, env=dict(os.environ))
    other = subprocess.Popen(sleep, env=dict(
        os.environ, **{trs.RUN_ENV: "another-checkout"}))
    try:
        orphans = {p.pid: ("ray_tpu_torch.core.worker", 1)
                   for p in (mine, other)}
        monkeypatch.setattr(trs, "port_processes", lambda: orphans)
        trs.reap_orphan_daemons()
        assert mine.wait(timeout=10) == -signal.SIGKILL
        assert other.poll() is None
        assert trs.segment_name("a") == f"/rtorch_test_{trs.RUN_TAG}_a"
    finally:
        for p in (mine, other):
            p.kill()
            p.wait(timeout=10)
