"""The operator surface of the port (ray_tpu_torch/autoscaler, job,
workflow, dashboard head and grafana, client gateway, client, _perf and
the CLI) against the JAX package's, exactly, on the same inputs.

The reference modules load through ``test_torch_support``'s stubs, group
"ops" (``import ray_tpu`` itself fails on this Python). Nothing here
starts a cluster: the autoscaler reads a scripted ``get_load``, the
providers run a recording command runner, the workflows run in local mode
on both sides (the stub's ``remote``/``get``, and the same two functions
patched into ``ray_tpu_torch``), the CLIs' parsers are compared as trees.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from test_torch_support import _local_get, _local_remote, jax_reference

import ray_tpu_torch
from ray_tpu_torch import workflow as port_workflow
from ray_tpu_torch.autoscaler import autoscaler as port_autoscaler
from ray_tpu_torch.autoscaler import launcher as port_launcher
from ray_tpu_torch.autoscaler import node_provider as port_np
from ray_tpu_torch.dashboard import grafana as port_grafana
from ray_tpu_torch.dashboard.head import _jsonable as port_jsonable

REPO = Path(__file__).resolve().parents[1]
NEW_PACKAGES = ("autoscaler", "job", "workflow", "dashboard", "client",
                "client_gateway", "_perf", "cli")


def _ref_jsonable():
    """The reference's ``_jsonable`` (and ``_jsonable_key``), compiled from
    ray_tpu/dashboard/head.py: that module imports ``core/rpc.py``, which
    does not load on this Python."""
    path = REPO / "ray_tpu" / "dashboard" / "head.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_jsonable", "_jsonable_key")]
    ns: dict = {"Any": object}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         ns)
    return ns["_jsonable"]


# --- import guard ------------------------------------------------------------


def test_new_packages_import_no_torch_jax_or_reference():
    """Importing every new module in a fresh interpreter loads no torch,
    jax or ray_tpu module (they are host code; the gateway imports torch
    only for a value that is a tensor), and no source line of theirs
    imports jax or ray_tpu."""
    mods = ["ray_tpu_torch." + m for m in NEW_PACKAGES] + [
        "ray_tpu_torch.autoscaler.launcher",
        "ray_tpu_torch.autoscaler.monitor",
        "ray_tpu_torch.dashboard.grafana", "ray_tpu_torch.job.manager",
        "ray_tpu_torch.workflow.api"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'ray_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    files = [p for d in ("autoscaler", "job", "workflow")
             for p in (REPO / "ray_tpu_torch" / d).glob("*.py")]
    files += [REPO / "ray_tpu_torch" / f for f in (
        "dashboard/head.py", "dashboard/grafana.py", "client.py",
        "client_gateway.py", "_perf.py", "cli.py")]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "ray_tpu"), \
                    (path, n)


# --- the autoscaler ----------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t


class _Recorder:
    """A provider that records its calls; with ``gcs_ids`` it resolves
    provider names to GCS node ids as LocalNodeProvider does, without it
    the autoscaler must match them by the ``provider_node_id`` label."""

    def __init__(self, gcs_ids: bool):
        self.calls = []
        self.live = []
        self.gcs_ids = gcs_ids

    def create_node(self, node_type, resources):
        name = f"{node_type}-{len(self.calls)}"
        self.calls.append(("create", node_type, dict(resources)))
        self.live.append(name)
        return name

    def terminate_node(self, name):
        self.calls.append(("terminate", name))
        self.live.remove(name)

    def non_terminated_nodes(self):
        return list(self.live)

    def node_id_of(self, name):
        return f"gcs-{name}" if self.gcs_ids else None


def _load(demand=(), pending=None, idle=()):
    return {"unmet_demand": [dict(d) for d in demand],
            "pending_leases": dict(pending or {}),
            "idle_nodes": list(idle)}


# (load, seconds to advance before the update); node ids "gcs-<name>"
_SCRIPT = [
    (_load([{"resources": {"CPU": 2.0}, "ts": 0}]), 0.0),
    (_load([{"resources": {"GPU": 1.0}, "ts": 0},
            {"resources": {"CPU": 1.0}, "ts": 0, "gang": "train:g"},
            {"resources": {"CPU": 1.0}, "ts": 0, "gang": "train:g"}]), 1.0),
    (_load([{"resources": {"TPU": 8.0}, "ts": 0}]), 1.0),      # no type fits
    (_load(pending={"n1": 2}), 1.0),                         # leases queued
    (_load([{"resources": {"CPU": 1.0}, "ts": 0}],
           idle=["gcs-cpu-0"]), 1.0),                        # at max_nodes
    (_load(idle=["gcs-cpu-0", "gcs-gpu_node-1"]), 5.0),
    (_load(idle=["gcs-cpu-0", "gcs-gpu_node-1"]), 20.0),     # past timeout
    (_load(idle=["gcs-cpu-0"]), 31.0),
    (_load(idle=["gcs-cpu-2"]), 1.0),
    (_load(), 100.0),
]


def _run_autoscaler(mod, gcs_ids, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=clock.time))
    provider = _Recorder(gcs_ids)
    loads = iter(_SCRIPT)
    current = {}

    def gcs_call(method, **kw):
        if method == "get_load":
            return current["load"]
        assert method == "get_nodes"
        # cloud providers' nodes carry their name as a label
        return [types.SimpleNamespace(
            labels={"provider_node_id": n}, alive=True,
            node_id=types.SimpleNamespace(hex=lambda n=n: f"gcs-{n}"))
            for n in provider.live]

    scaler = mod.StandardAutoscaler(
        gcs_call, provider,
        node_types={"cpu": {"CPU": 4.0}, "gpu_node": {"CPU": 2.0,
                                                      "GPU": 1.0}},
        max_nodes=3, idle_timeout_s=10.0)
    actions = []
    for load, dt in loads:
        clock.t += dt
        current["load"] = load
        actions.append(scaler.update())
    return actions, provider.calls


@pytest.mark.parametrize("gcs_ids", [True, False],
                         ids=["node_id_of", "labels"])
def test_autoscaler_update_matches_reference(gcs_ids, monkeypatch):
    """StandardAutoscaler.update() over a scripted get_load: launches (one
    a turn, the first type that fits, pending leases, max_nodes), gang
    attribution and idle terminations under a fake clock, through a
    local-style and a cloud-style provider."""
    with jax_reference("ops") as ref:
        want = _run_autoscaler(ref.autoscaler_autoscaler, gcs_ids,
                               monkeypatch)
    got = _run_autoscaler(port_autoscaler, gcs_ids, monkeypatch)
    assert got == want
    actions, calls = got
    assert [a["launched"] for a in actions[:2]] == [["cpu-0"],
                                                    ["gpu_node-1"]]
    assert actions[1]["gang_demand"] == ["train:g"]
    assert any(a["terminated"] for a in actions)


# --- cloud providers -----------------------------------------------------------


class _Runner:
    def __init__(self, replies):
        self.calls = []
        self.replies = replies

    def __call__(self, args, stdin=""):
        self.calls.append((list(args), stdin))
        for key, reply in self.replies.items():
            if key in " ".join(args):
                return reply
        return "[]"


_TPU_LIST = json.dumps([
    {"name": "projects/p/locations/z/queuedResources/"
             "ray-tpu-c1-v5e-8-01010101", "state": {"state": "ACTIVE"}},
    {"name": "projects/p/locations/z/queuedResources/ray-tpu-x-1",
     "state": {"state": "ACTIVE"}}])
_REPLIES = {
    "tpu": {"list": _TPU_LIST},
    "gce": {"list": json.dumps([
        {"name": "ray-cpu-c1-cpu16-01010101", "status": "RUNNING"},
        {"name": "ray-cpu-c1-b", "status": "TERMINATED"}])},
    "aws": {"run-instances": json.dumps(
        {"Instances": [{"InstanceId": "i-0abc"}]}),
        "describe-instances": json.dumps({"Reservations": [
            {"Instances": [{"InstanceId": "i-0abc"}]}]})},
    "k8s": {"get pods": json.dumps({"items": [
        {"metadata": {"name": "ray-node-tpu8-01010101"},
         "status": {"phase": "Running"}}]})},
}


def _drive(mod, kind, monkeypatch):
    """Each cloud provider's create / list / terminate through a recording
    runner; tempfile paths (the startup script's) by their content."""
    monkeypatch.setattr(os, "urandom", lambda n: b"\x01" * n)
    r = _Runner(_REPLIES[kind])
    if kind == "tpu":
        p = mod.TPUPodProvider(
            project="proj", zone="us-central2-b",
            node_types={"v5e-8": {"accelerator_type": "v5litepod-8"}},
            startup_script="#!/bin/bash\necho a, b\n",
            runner=lambda a: r(a), cluster_name="c1")
        name = p.create_node("v5e-8", {"TPU": 8})
    elif kind == "gce":
        p = mod.GCEProvider(
            project="proj", zone="us-central1-a",
            node_types={"cpu16": {"machine_type": "n2-standard-16",
                                  "image_family": "debian-12",
                                  "image_project": "debian-cloud"}},
            startup_script="#!/bin/sh\ntrue\n",
            runner=lambda a: r(a), cluster_name="c1")
        name = p.create_node("cpu16", {"CPU": 16})
    elif kind == "aws":
        p = mod.AWSProvider(
            region="us-west-2", user_data="#cloud-config",
            node_types={"m5": {"instance_type": "m5.4xlarge",
                               "ami": "ami-123", "subnet_id": "s-1",
                               "key_name": "k"}},
            runner=lambda a: r(a), cluster_name="c1")
        name = p.create_node("m5", {"CPU": 16})
    else:
        p = mod.KubernetesProvider(
            namespace="ray", image="ray-tpu:v1",
            node_types={"tpu8": {"cpu": "8", "memory": "16Gi",
                                 "tpu": "8"}},
            runner=r, cluster_name="c1")
        name = p.create_node("tpu8", {"CPU": 8, "TPU": 8})
    live = p.non_terminated_nodes()
    p.terminate_node(name)
    calls = []
    for args, stdin in r.calls:
        norm = []
        for a in args:
            if a.startswith("--metadata-from-file=startup-script="):
                path = a.split("=", 2)[2]
                a = "--metadata-from-file=startup-script=" + \
                    Path(path).read_text()
                os.unlink(path)
            norm.append(a)
        calls.append((norm, json.loads(stdin) if stdin else None))
    return name, live, calls


@pytest.mark.parametrize("kind", ["tpu", "gce", "aws", "k8s"])
def test_cloud_provider_argv_matches_reference(kind, monkeypatch):
    """Every cloud provider's argv, word for word, and its node names and
    listings. The Kubernetes pod's command runs the port's CLI, the one
    difference by design."""
    with jax_reference("ops") as ref:
        want = _drive(ref.autoscaler_node_provider, kind, monkeypatch)
    got = _drive(port_np, kind, monkeypatch)
    if kind == "k8s":
        pod = got[2][0][1]["spec"]["containers"][0]
        ref_pod = want[2][0][1]["spec"]["containers"][0]
        assert pod["command"] == ["python", "-m", "ray_tpu_torch.cli",
                                  "start", "--block"]
        assert ref_pod["command"] == ["python", "-m", "ray_tpu.cli",
                                      "start", "--block"]
        pod["command"] = ref_pod["command"]
    assert got == want


# --- the launcher's config -------------------------------------------------

_CONFIGS = {
    "yaml": "cluster_name: c\nmax_workers: 1\nprovider: {type: local}\n"
            "available_node_types:\n  gpu_node:\n    resources: "
            "{CPU: 2, GPU: 1}\n",
    "json": json.dumps({"cluster_name": "c", "max_workers": 1,
                        "idle_timeout_minutes": 0.1,
                        "head_resources": {"CPU": 4, "GPU": 0},
                        "available_node_types": {"gpu_node": {
                            "resources": {"CPU": 2, "GPU": 1}}},
                        "system_config": {"health_check_period_s": 0.2}}),
    "defaults": "max_workers: 2\n",
    "empty": "",
    "unknown_key": json.dumps({"cluster_name": "c", "workers": 1}),
    "not_a_mapping": "[1, 2]\n",
    "scalar": "7\n",
}


def _load_config(load, path):
    try:
        return ("ok", load(str(path)))
    except Exception as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(_CONFIGS))
def test_load_config_matches_reference(case, tmp_path):
    """load_config's accept (defaults filled) and reject (unknown keys, a
    non-mapping) cases, with PyYAML present as in the reference."""
    path = tmp_path / f"{case}.cfg"
    path.write_text(_CONFIGS[case])
    with jax_reference("ops") as ref:
        want = _load_config(ref.autoscaler_launcher.load_config, path)
    assert _load_config(port_launcher.load_config, path) == want


def test_load_config_without_pyyaml(tmp_path, monkeypatch):
    """Without PyYAML (the card's machine has none) a JSON-written config
    loads to what PyYAML gives, and a YAML-only one raises an ImportError
    that names PyYAML."""
    good = tmp_path / "c.json"
    good.write_text(_CONFIGS["json"])
    with_yaml = port_launcher.load_config(str(good))
    bad = tmp_path / "c.yaml"
    bad.write_text(_CONFIGS["yaml"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert port_launcher.load_config(str(good)) == with_yaml
    with pytest.raises(ImportError, match="PyYAML"):
        port_launcher.load_config(str(bad))
    unknown = tmp_path / "u.json"
    unknown.write_text(_CONFIGS["unknown_key"])
    with pytest.raises(ValueError, match="unknown cluster config keys"):
        port_launcher.load_config(str(unknown))


# --- workflows -----------------------------------------------------------------


def _add(a, b=0):
    return a + b


def _total(x, scale=1.0):
    return float(np.sum(x)) * scale


_BIG = np.zeros(3000)
_BIG_B = _BIG.copy()
_BIG_B[1500] = 1.0
_KEY_CASES = {
    "python_args": ((_add, (1, 2), {}), None),
    "kwargs": ((_add, (1,), {"b": 5}), None),
    "strings_and_containers": ((_add, ("a", {"k": [1, 2.5, None]}), {}),
                               None),
    "numpy": ((_total, (_BIG,), {"scale": np.float32(2)}), None),
    "numpy_mid_array": ((_total, (_BIG_B,), {}), None),
    "numpy_int_matrix": ((_total, (np.arange(12).reshape(3, 4),), {}), None),
    "nested": ((_add, ("child",), {}), (_add, (3, 4), {})),
}


def _key(mod, case):
    (fn, args, kwargs), child = _KEY_CASES[case]
    if child is not None:
        cfn, cargs, ckw = child
        args = (mod.StepNode(cfn, cargs, ckw),)
    return mod.StepNode(fn, args, kwargs).key()


@pytest.mark.parametrize("case", sorted(_KEY_CASES))
def test_step_key_matches_reference(case):
    """StepNode.key(): content-addressed by the pickled args, the same on
    both sides for python and numpy args (and for a child step)."""
    with jax_reference("ops") as ref:
        want = _key(ref.workflow_api, case)
    assert _key(port_workflow.api, case) == want
    if case == "numpy_mid_array":
        # the elided reprs collide; the keys do not
        assert want != _key(port_workflow.api, "numpy")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _flow(api, storage, marker):
    """A three-step workflow whose last step fails while `marker` exists:
    (status, files) after the failing run, then after resume, and the
    result."""

    def load(n):
        return list(range(n))

    def square(xs):
        return [x * x for x in xs]

    def report(xs, ys):
        if os.path.exists(marker):
            raise RuntimeError("report failed on purpose")
        return {"sum": sum(xs) + sum(ys)}

    load_s = api.step(load)
    square_s = api.step(square)
    report_s = api.step(max_retries=0)(report)
    xs = load_s.bind(4)
    dag = report_s.bind(xs, square_s.bind(xs))
    open(marker, "w").close()
    with pytest.raises(Exception, match="on purpose"):
        api.run(dag, workflow_id="flow", storage=storage)
    first = (api.get_status("flow", storage=storage), _files(storage))
    os.unlink(marker)
    out = api.resume(dag, workflow_id="flow", storage=storage)
    second = (api.get_status("flow", storage=storage), _files(storage),
              api.list_all(storage=storage))
    return first, second, out


def test_workflow_fail_and_resume_match_reference(tmp_path, monkeypatch):
    """A workflow's statuses and stored file names across a failing run
    and its resume, both packages in local mode (steps run in process)."""
    with jax_reference("ops") as ref:
        want = _flow(ref.workflow_api, str(tmp_path / "ref"),
                     str(tmp_path / "m1"))
    monkeypatch.setattr(ray_tpu_torch, "remote", _local_remote,
                        raising=False)
    monkeypatch.setattr(ray_tpu_torch, "get", _local_get, raising=False)
    got = _flow(port_workflow.api, str(tmp_path / "port"),
                str(tmp_path / "m2"))
    assert got == want
    assert want[0][0] == "FAILED" and want[1][0] == "SUCCESSFUL"
    assert want[2] == {"sum": 20}


# --- grafana -------------------------------------------------------------------


def _grafana(mod, out):
    return {
        "dashboard": json.dumps(mod.generate_dashboard(), indent=2),
        "titled": json.dumps(mod.generate_dashboard("t"), sort_keys=True),
        "prometheus": mod.prometheus_config("10.0.0.1:8265"),
        "datasource": mod.datasource_yaml(),
        "provider": mod.provider_yaml("/x/dashboards"),
        "files": {str(Path(p).relative_to(out)): Path(p).read_bytes()
                  for p in mod.provision(str(out), "127.0.0.1:1234")},
    }


def test_grafana_outputs_match_reference_byte_for_byte(tmp_path):
    out = tmp_path / "prov"
    with jax_reference("ops") as ref:
        want = _grafana(ref.dashboard_grafana, out)
    assert _grafana(port_grafana, out) == want


# --- the gateway's codec -------------------------------------------------------


class _FakeRef:
    """Stands for an ObjectRef on both sides (``.id.hex()``)."""

    def __init__(self, h):
        self.id = types.SimpleNamespace(hex=lambda: h)


@dataclasses.dataclass
class _Point:
    x: int
    y: float


_CODEC_VALUES = {
    "scalars": [None, True, 3, 2.5, "s"],
    "bytes": b"\x00\xff",
    "nested": {"a": [1, (2, b"b")], 3: {"t": (1, 2)}},
    "numpy_scalar": np.float32(1.5),
    "numpy_array": np.arange(6, dtype=np.int64).reshape(2, 3),
    "numpy_float_array": np.linspace(0, 1, 5),
    "object": _Point(1, 2.0),
    "ref": {"r": _FakeRef("ab" * 8), "l": [_FakeRef("cd" * 8)]},
}


def _encode(mod, v, pickle_fallback):
    refs: dict = {}
    codec = mod._Codec(refs)
    try:
        out = codec.encode(v, pickle_fallback=pickle_fallback)
    except Exception as e:
        return (type(e).__name__, str(e))
    back = codec.decode(out)
    return out, sorted(refs), repr(back)


@pytest.mark.parametrize("name", sorted(_CODEC_VALUES))
@pytest.mark.parametrize("pickle_fallback", [True, False],
                         ids=["python_client", "json_client"])
def test_codec_matches_reference(name, pickle_fallback, monkeypatch):
    """_Codec.encode (both client kinds) and decode of what it encoded:
    markers, containers, numpy, pickled objects, refs, and the error for a
    value a JSON-only client cannot take."""
    v = _CODEC_VALUES[name]
    with jax_reference("ops") as ref:
        monkeypatch.setattr(sys.modules["ray_tpu"], "ObjectRef", _FakeRef,
                            raising=False)
        want = _encode(ref.ray_tpu_client_gateway, v, pickle_fallback)
    from ray_tpu_torch import client_gateway

    monkeypatch.setattr(ray_tpu_torch, "ObjectRef", _FakeRef, raising=False)
    assert _encode(client_gateway, v, pickle_fallback) == want


def test_codec_tensor_encodes_as_reference_array(monkeypatch):
    """A torch tensor reaches a JSON-only client as the reference sends
    the numpy array of its values; a 0-d tensor as its number (the
    reference's 0-d array is not encodable)."""
    import torch

    from ray_tpu_torch import client_gateway

    arr = np.arange(6, dtype=np.int64).reshape(2, 3)
    with jax_reference("ops") as ref:
        monkeypatch.setattr(sys.modules["ray_tpu"], "ObjectRef", _FakeRef,
                            raising=False)
        want = ref.ray_tpu_client_gateway._Codec({}).encode(
            arr, pickle_fallback=False)
    codec = client_gateway._Codec({})
    assert codec.encode(torch.from_numpy(arr),
                        pickle_fallback=False) == want
    assert codec.encode(torch.tensor(2.5), pickle_fallback=False) == 2.5


# --- the dashboard's JSON conversion -------------------------------------------


class _Id:
    def __init__(self, h):
        self._h = h

    def hex(self):
        return self._h


class _Quant:
    quantities = {"CPU": 2.0, "GPU": 1.0}


_JSONABLE = {
    "bytes_keys": {b"\x01\x02": [1, (2, 3)], 4: "x", 1.5: None},
    "ids": [_Id("ff00"), {"n": _Id("aa")}],
    "dataclass": _Point(3, 4.5),
    "quantities": {"r": _Quant()},
    "bytes": b"\xde\xad",
    "other": {"k": object, "key": ("t", 1)},
    "object_key": {("a", 1): 2},
}


@pytest.mark.parametrize("name", sorted(_JSONABLE))
def test_jsonable_matches_reference(name):
    assert port_jsonable(_JSONABLE[name]) == _ref_jsonable()(_JSONABLE[name])


# --- the CLIs' argparse trees --------------------------------------------------


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _tree(parser):
    """{command: [(option strings, dest, default, choices, required, nargs,
    const)]} of a parser's subcommands (callable defaults left out)."""
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        rows = []
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            rows.append((tuple(a.option_strings), a.dest,
                         None if callable(a.default) else a.default,
                         tuple(a.choices) if a.choices else None,
                         a.required, a.nargs, a.const))
        defaults = {k: v for k, v in p._defaults.items() if not callable(v)}
        out[name] = (sorted(rows), defaults)
    return out


def test_cli_commands_and_options_match_reference(monkeypatch):
    """Every command of the reference's CLI, with its options, is the
    port's (lint, which waits for raylint's port, apart)."""
    import argparse

    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", ["ray_tpu", "status"])
    with jax_reference("ops") as ref:
        with pytest.raises(_Parsed) as ei:
            ref.ray_tpu_cli.main()
        want = _tree(ei.value.parser)
    from ray_tpu_torch import cli

    got = _tree(cli.build_parser())
    assert want.pop("lint") and got.pop("lint")
    assert got == want
    assert set(got) >= {"start", "stop", "status", "list", "summary",
                        "stack", "internal-stats", "debug", "microbenchmark",
                        "gateway", "timeline", "memory", "top", "metrics",
                        "chaos", "dashboard", "serve", "up", "down", "exec",
                        "submit", "attach", "cluster-status", "doctor",
                        "blackbox"}


def test_cli_lint_names_its_roadmap_item():
    """ROADMAP item 11.4 is the port's raylint: `lint` routes to it."""
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.cli", "lint",
                          "--", "--help"], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "python -m ray_tpu_torch.devtools.lint" in out.stdout
    assert "11.4" not in out.stdout + out.stderr
