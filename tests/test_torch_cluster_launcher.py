"""Cluster launcher e2e on the port (ray_tpu_torch/autoscaler/launcher.py):
tests/test_cluster_launcher.py's case re-aimed (ref: ray up/down/exec,
scripts.py:1238,1314,1696, and the FakeMultiNodeProvider autoscaler e2e,
autoscaler/_private/fake_multi_node/node_provider.py:237):
up → submit infeasible work → monitor launches a node → work completes →
exec runs against the cluster → down terminates everything, the
autoscaled node's workers included. The JAX package marks it slow; it runs
here unmarked (~20 s)."""

import json
import os
import subprocess
import sys
import time

import pytest
from torch_runtime_support import reap_orphans  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cluster_yaml(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_CLUSTER_DIR", str(tmp_path / "clusters"))
    y = tmp_path / "cluster.yaml"
    y.write_text("""\
cluster_name: launcher-e2e
max_workers: 2
idle_timeout_minutes: 0.05
provider:
  type: local
head_resources: {CPU: 2}
available_node_types:
  gadget-node:
    resources: {CPU: 2, gadget: 4}
system_config:
  health_check_period_s: 0.2
""")
    return str(y)


def test_up_scale_exec_down(cluster_yaml, tmp_path, monkeypatch):
    from ray_tpu_torch.autoscaler import launcher
    from ray_tpu_torch.core.node import session_pids

    # STATE_DIR is resolved at import; point it at the fixture's dir
    monkeypatch.setattr(launcher, "STATE_DIR",
                        os.environ["RAY_TPU_TORCH_CLUSTER_DIR"])
    monkeypatch.chdir(REPO)   # the daemons run `python -m ray_tpu_torch.*`
    state = launcher.up(cluster_yaml)
    try:
        assert launcher._alive(state["gcs_pid"])
        assert launcher._alive(state["monitor_pid"])

        # idempotent up
        again = launcher.up(cluster_yaml)
        assert again["gcs_pid"] == state["gcs_pid"]

        # infeasible work: needs a 'gadget' resource only the autoscaled
        # node type offers → the MONITOR (not this driver) must launch it
        script = tmp_path / "work.py"
        script.write_text("""\
import ray_tpu_torch

ray_tpu_torch.init()   # RAY_TPU_ADDRESS from the launcher env

@ray_tpu_torch.remote(resources={"gadget": 1})
def need_gadget():
    return "scaled"

print("RESULT:" + ray_tpu_torch.get(need_gadget.remote(), timeout=120))
ray_tpu_torch.shutdown()
""")
        env = dict(os.environ, RAY_TPU_ADDRESS=state["address"],
                   PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, str(script)], env=env,
                             capture_output=True, text=True, timeout=180)
        assert "RESULT:scaled" in out.stdout, out.stdout + out.stderr

        # the monitor recorded the autoscaled node
        nodes_file = os.path.join(state["session_dir"],
                                  "autoscaler_nodes.json")
        with open(nodes_file) as f:
            nodes = json.load(f)
        assert nodes, "monitor did not persist the launched node"
        node_pids = {rec["pid"] for rec in nodes.values()}
        # the autoscaled nodelet and the worker that ran the task
        tree = session_pids(node_pids)
        assert len(tree) > len(node_pids), tree

        # exec: command sees the cluster address
        rc = launcher.exec_cmd(cluster_yaml,
                               "test -n \"$RAY_TPU_ADDRESS\"")
        assert rc == 0

        # idle scale-down (idle_timeout = 3 s): the monitor should
        # terminate the autoscaled node on its own
        deadline = time.time() + 90
        while time.time() < deadline:
            with open(nodes_file) as f:
                if not json.load(f):
                    break
            time.sleep(1.0)
        with open(nodes_file) as f:
            assert json.load(f) == {}, "idle node was not scaled down"
        # terminate_node took the node's workers with its nodelet
        assert not [p for p in tree if launcher._alive(p)], tree
        head_tree = session_pids({state["nodelet_pid"]})
    finally:
        assert launcher.down(cluster_yaml)
    for pid_key in ("gcs_pid", "nodelet_pid", "monitor_pid"):
        assert not launcher._alive(state[pid_key]), f"{pid_key} survived down"
    assert not [p for p in head_tree if launcher._alive(p)], head_tree
    # exec against a downed cluster fails cleanly
    assert launcher.exec_cmd(cluster_yaml, "true") == 1
