"""The operator surface on the card (``cuda``-marked; it skips without
CUDA, checked inside the test; this file imports no JAX).

A cluster brought up by the launcher from a JSON config whose head holds
no GPU unit: a ``num_gpus=1`` task makes the monitor launch the config's
``gpu_node``, runs there, and launches K1 (the flash-attention forward)
once in its own process, held against the plain version within the ops
module's ``kernel_tolerance``; ``down`` leaves no process of the cluster.
"""

import json
import os
from pathlib import Path

import pytest

from test_torch_support import require_cuda
from torch_runtime_support import reap_orphans  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _attend():
    """K1 once on this process's card, against the plain version with its
    bf16 products summed in f32; this process's pid, node and launch
    count."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 256, 4, 64, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    before = fa.launches
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    launched = fa.launches - before
    mm = torch.backends.cuda.matmul
    mm.allow_bf16_reduced_precision_reduction = False
    plain, _ = fa.flash_attention_reference(q, k, v, causal=True)
    err = (out.float() - plain.float()).abs()
    held = bool((err <= fa.kernel_tolerance(q, k, v, plain,
                                            causal=True)).all())
    return {"launches": launched, "held": held, "pid": os.getpid(),
            "node": ray_tpu_torch.get_runtime_context().get_node_id()}


@pytest.mark.cuda
def test_gpu_task_on_autoscaled_node_runs_k1(tmp_path, monkeypatch):
    require_cuda()
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import launcher
    from ray_tpu_torch.core import runtime as _rt
    from ray_tpu_torch.core.node import pid_alive, session_pids

    monkeypatch.setattr(launcher, "STATE_DIR", str(tmp_path / "clusters"))
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    cfg = tmp_path / "cluster.json"
    cfg.write_text(json.dumps({
        "cluster_name": "ops-card", "max_workers": 1,
        "idle_timeout_minutes": 0.1, "provider": {"type": "local"},
        "head_resources": {"CPU": 2, "GPU": 0},
        "available_node_types": {"gpu_node": {
            "resources": {"CPU": 2, "GPU": 1}}}}))
    state = launcher.up(str(cfg))
    pids = set()
    try:
        ray_tpu_torch.init(address=state["address"])
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
        r = ray_tpu_torch.get(
            ray_tpu_torch.remote(num_gpus=1)(_attend).remote(), timeout=900)
        nodes = {n.node_id.hex(): n
                 for n in _rt.get_runtime().gcs_call("get_nodes")}
        node = nodes[r["node"]]
        assert node.labels.get("autoscaled") is True
        assert node.labels.get("node_type") == "gpu_node"
        assert node.resources_total.quantities.get("GPU") == 1.0
        assert r["launches"] == 1 and r["held"], r
        pids = {r["pid"], state["gcs_pid"], state["nodelet_pid"]}
        pids |= set(session_pids(pids))
    finally:
        ray_tpu_torch.shutdown()
        launcher.down(str(cfg))
    assert not [p for p in pids if pid_alive(p)]
