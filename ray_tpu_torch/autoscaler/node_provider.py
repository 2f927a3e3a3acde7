"""NodeProvider plugin API + local provider.

Port of ray_tpu/autoscaler/node_provider.py over the port's runtime.
Reference: python/ray/autoscaler/node_provider.py (create/terminate/
non_terminated_nodes) and the fake multi-node provider
(fake_multi_node/node_provider.py:237) used to test scaling logic without a
cloud. The cloud providers keep the reference's argv word for word; a
local node's nodelet is the port's (``python -m ray_tpu_torch.core.nodelet``)
and dies with its workers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class NodeProvider:
    """Subclass for real clouds (GKE TPU slices, QueuedResources)."""

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Spawns real nodelets on this machine (one per 'node')."""

    def __init__(self, gcs_addr, session_dir: str, cfg=None):
        from ray_tpu_torch.core.config import Config

        self.gcs_addr = tuple(gcs_addr)
        self.session_dir = session_dir
        self.cfg = cfg or Config.load()
        self.nodes: Dict[str, Any] = {}
        self._counter = 0

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        from ray_tpu_torch.core.node import start_nodelet

        self._counter += 1
        name = f"auto-{self._counter}"
        proc, addr, node_id_hex, store = start_nodelet(
            self.session_dir, self.cfg, self.gcs_addr, resources=resources,
            labels={"autoscaled": True, "node_type": node_type},
            log_name=f"nodelet-{name}")
        self.nodes[name] = {"proc": proc, "addr": addr,
                            "node_id": node_id_hex}
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        """SIGTERM the nodelet and every worker it started (a worker would
        otherwise notice its nodelet gone only at its next ping, seconds
        later, holding whatever CUDA context it made); SIGKILL what is
        still alive 10 s later."""
        rec = self.nodes.pop(provider_node_id, None)
        if rec:
            terminate_tree(rec["proc"].pid, proc=rec["proc"])

    def non_terminated_nodes(self) -> List[str]:
        return [k for k, v in self.nodes.items()
                if v["proc"].poll() is None]

    def node_id_of(self, provider_node_id: str) -> Optional[str]:
        rec = self.nodes.get(provider_node_id)
        return rec["node_id"] if rec else None


def terminate_tree(pid: int, proc=None, timeout_s: float = 10.0) -> None:
    """SIGTERM a daemon of the port and the port's processes it started
    (a nodelet and its workers), wait for all of them to exit, SIGKILL
    stragglers. ``proc`` (the daemon's Popen, where this process started
    it) is reaped too."""
    import os
    import signal
    import time

    from ray_tpu_torch.core.node import pid_alive, session_pids

    pids = set(session_pids({pid})) | {pid}
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in pids:
            try:
                os.kill(p, sig)
            except OSError:
                pass
        deadline = time.time() + (timeout_s if sig == signal.SIGTERM
                                  else 5.0)
        while time.time() < deadline:
            if proc is not None:
                proc.poll()
            if not any(pid_alive(p) for p in pids):
                return
            time.sleep(0.05)


class TPUPodProvider(NodeProvider):
    """Cloud provider that provisions whole TPU slices via GCP Queued
    Resources (ref: the reference's cloud NodeProviders —
    autoscaler/_private/gcp/node_provider.py — re-shaped for TPU: the
    unit of scaling is an ICI-connected SLICE, not a fungible VM; a
    node_type names an accelerator topology like "v5litepod-8").

    Cloud calls go through a pluggable `runner(args: list[str]) -> str`
    (default: the gcloud CLI), so scaling logic is testable without a
    cloud and alternative control planes (KubeRay-style operators) can
    slot in the same way.
    """

    def __init__(self, project: str, zone: str,
                 node_types: Optional[Dict[str, Dict[str, str]]] = None,
                 runtime_version: str = "v2-alpha-tpuv5-lite",
                 startup_script: str = "", runner=None,
                 cluster_name: str = "default"):
        self.project = project
        self.zone = zone
        # node_type -> {"accelerator_type": ..., "runtime_version": ...}
        self.node_types = node_types or {}
        self.runtime_version = runtime_version
        # The script should start the nodelet with
        # --labels '{"provider_node_id": "<name>"}' (the autoscaler
        # matches idle GCS nodes back to provider ids by that label).
        self.startup_script = startup_script
        self.runner = runner or self._gcloud
        # names carry the cluster prefix so list() never counts another
        # cluster's queued resources, and a random suffix so restarts
        # (or lingering FAILED resources) can't collide
        self.name_prefix = f"ray-tpu-{cluster_name}-"

    @staticmethod
    def _gcloud(args: List[str]) -> str:
        import subprocess

        return subprocess.run(["gcloud"] + args, check=True,
                              capture_output=True, text=True).stdout

    def _type(self, node_type: str) -> Dict[str, str]:
        t = self.node_types.get(node_type, {})
        return {"accelerator_type": t.get("accelerator_type", node_type),
                "runtime_version": t.get("runtime_version",
                                         self.runtime_version)}

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        import os

        name = f"{self.name_prefix}{node_type}-{os.urandom(4).hex()}"
        t = self._type(node_type)
        args = ["alpha", "compute", "tpus", "queued-resources", "create",
                name,
                f"--node-id={name}",
                f"--project={self.project}",
                f"--zone={self.zone}",
                f"--accelerator-type={t['accelerator_type']}",
                f"--runtime-version={t['runtime_version']}"]
        if self.startup_script:
            # --metadata parses comma-separated key=value pairs; real
            # scripts must go via --metadata-from-file
            import tempfile

            f = tempfile.NamedTemporaryFile("w", suffix=".sh", delete=False)
            f.write(self.startup_script)
            f.close()
            args.append(f"--metadata-from-file=startup-script={f.name}")
        self.runner(args)
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        self.runner(["alpha", "compute", "tpus", "queued-resources",
                     "delete", provider_node_id,
                     f"--project={self.project}", f"--zone={self.zone}",
                     "--force", "--quiet"])

    def non_terminated_nodes(self) -> List[str]:
        import json as _json

        out = self.runner(["alpha", "compute", "tpus", "queued-resources",
                           "list", f"--project={self.project}",
                           f"--zone={self.zone}", "--format=json"])
        nodes = []
        for item in _json.loads(out or "[]"):
            name = item["name"].rsplit("/", 1)[-1]
            if not name.startswith(self.name_prefix):
                continue  # another cluster's queued resources
            state = (item.get("state", {}) or {}).get("state", "")
            if state in ("ACTIVE", "PROVISIONING", "WAITING_FOR_RESOURCES",
                         "ACCEPTED", "CREATING"):
                nodes.append(name)
        return nodes


class GCEProvider(NodeProvider):
    """Plain GCE VM provider for CPU fleets (rollout workers, data
    workers) alongside TPU slices (ref:
    autoscaler/_private/gcp/node_provider.py — the non-TPU half).
    Same pluggable runner contract as TPUPodProvider."""

    def __init__(self, project: str, zone: str,
                 node_types: Optional[Dict[str, Dict[str, str]]] = None,
                 startup_script: str = "", runner=None,
                 cluster_name: str = "default"):
        self.project = project
        self.zone = zone
        # node_type -> {"machine_type": ..., "image_family": ...,
        #               "image_project": ...}
        self.node_types = node_types or {}
        self.startup_script = startup_script
        self.runner = runner or TPUPodProvider._gcloud
        self.name_prefix = f"ray-cpu-{cluster_name}-"

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        import os

        t = self.node_types.get(node_type, {})
        name = f"{self.name_prefix}{node_type}-{os.urandom(4).hex()}"
        args = ["compute", "instances", "create", name,
                f"--project={self.project}", f"--zone={self.zone}",
                f"--machine-type={t.get('machine_type', node_type)}",
                f"--labels=ray-cluster={self.name_prefix.rstrip('-')}"]
        if t.get("image_family"):
            args.append(f"--image-family={t['image_family']}")
        if t.get("image_project"):
            args.append(f"--image-project={t['image_project']}")
        if self.startup_script:
            import tempfile

            f = tempfile.NamedTemporaryFile("w", suffix=".sh",
                                            delete=False)
            f.write(self.startup_script)
            f.close()
            args.append(f"--metadata-from-file=startup-script={f.name}")
        self.runner(args)
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        self.runner(["compute", "instances", "delete", provider_node_id,
                     f"--project={self.project}", f"--zone={self.zone}",
                     "--quiet"])

    def non_terminated_nodes(self) -> List[str]:
        import json as _json

        out = self.runner(["compute", "instances", "list",
                           f"--project={self.project}",
                           f"--zones={self.zone}", "--format=json"])
        nodes = []
        for item in _json.loads(out or "[]"):
            name = item.get("name", "")
            if not name.startswith(self.name_prefix):
                continue
            if item.get("status") in ("RUNNING", "PROVISIONING",
                                      "STAGING"):
                nodes.append(name)
        return nodes


class AWSProvider(NodeProvider):
    """EC2 provider via the aws CLI (ref:
    autoscaler/_private/aws/node_provider.py — boto3 there; the CLI
    keeps this dependency-free and the runner stays mockable). Nodes are
    tagged `ray-cluster` so list/terminate never touch foreign
    instances; the provider id is the EC2 instance id."""

    def __init__(self, region: str,
                 node_types: Optional[Dict[str, Dict[str, str]]] = None,
                 user_data: str = "", runner=None,
                 cluster_name: str = "default"):
        self.region = region
        # node_type -> {"instance_type": ..., "ami": ...,
        #               "subnet_id": ..., "key_name": ...}
        self.node_types = node_types or {}
        self.user_data = user_data
        self.runner = runner or self._aws
        self.cluster_tag = f"ray-tpu-{cluster_name}"

    @staticmethod
    def _aws(args: List[str]) -> str:
        import subprocess

        return subprocess.run(["aws"] + args, check=True,
                              capture_output=True, text=True).stdout

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        import json as _json

        t = self.node_types.get(node_type, {})
        tags = (f"ResourceType=instance,Tags=["
                f"{{Key=ray-cluster,Value={self.cluster_tag}}},"
                f"{{Key=ray-node-type,Value={node_type}}}]")
        args = ["ec2", "run-instances", f"--region={self.region}",
                "--count=1",
                f"--instance-type={t.get('instance_type', node_type)}",
                f"--tag-specifications={tags}", "--output=json"]
        if t.get("ami"):
            args.append(f"--image-id={t['ami']}")
        if t.get("subnet_id"):
            args.append(f"--subnet-id={t['subnet_id']}")
        if t.get("key_name"):
            args.append(f"--key-name={t['key_name']}")
        if self.user_data:
            args.append(f"--user-data={self.user_data}")
        out = self.runner(args)
        return _json.loads(out)["Instances"][0]["InstanceId"]

    def terminate_node(self, provider_node_id: str) -> None:
        self.runner(["ec2", "terminate-instances",
                     f"--region={self.region}",
                     f"--instance-ids={provider_node_id}"])

    def non_terminated_nodes(self) -> List[str]:
        import json as _json

        out = self.runner([
            "ec2", "describe-instances", f"--region={self.region}",
            "--filters",
            f"Name=tag:ray-cluster,Values={self.cluster_tag}",
            "Name=instance-state-name,Values=pending,running",
            "--output=json"])
        ids = []
        for res in _json.loads(out or "{}").get("Reservations", []):
            for inst in res.get("Instances", []):
                ids.append(inst["InstanceId"])
        return ids


class KubernetesProvider(NodeProvider):
    """Pod-per-node provider via kubectl (ref: the reference's kuberay
    integration, autoscaler/_private/kuberay/node_provider.py — there
    the operator owns pods; here the provider drives the API directly,
    which is the shape of the pre-operator k8s provider). Each ray node
    is a pod labeled `ray-cluster=<name>`; the startup command runs the
    nodelet."""

    def __init__(self, namespace: str = "default",
                 image: str = "ray-tpu:latest",
                 node_types: Optional[Dict[str, Dict[str, Any]]] = None,
                 command: Optional[List[str]] = None, runner=None,
                 cluster_name: str = "default"):
        self.namespace = namespace
        self.image = image
        # node_type -> {"cpu": "4", "memory": "8Gi", "tpu": "8", ...}
        self.node_types = node_types or {}
        self.command = command or ["python", "-m", "ray_tpu_torch.cli",
                                   "start", "--block"]
        self.runner = runner or self._kubectl
        self.label = f"ray-cluster={cluster_name}"

    @staticmethod
    def _kubectl(args: List[str], stdin: str = "") -> str:
        import subprocess

        return subprocess.run(["kubectl"] + args, input=stdin or None,
                              check=True, capture_output=True,
                              text=True).stdout

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        import json as _json
        import os

        t = self.node_types.get(node_type, {})
        name = f"ray-node-{node_type}-{os.urandom(4).hex()}"
        limits = {"cpu": str(t.get("cpu", int(resources.get("CPU", 1))))}
        if t.get("memory"):
            limits["memory"] = t["memory"]
        if t.get("tpu") or resources.get("TPU"):
            limits["google.com/tpu"] = str(t.get("tpu") or
                                           int(resources["TPU"]))
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": self.namespace,
                         "labels": dict([self.label.split("=")],
                                        **{"ray-node-type": node_type})},
            "spec": {"restartPolicy": "Never",
                     "containers": [{"name": "ray-node",
                                     "image": self.image,
                                     "command": self.command,
                                     "resources": {"limits": limits}}]},
        }
        self.runner(["apply", "-n", self.namespace, "-f", "-"],
                    _json.dumps(pod))
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        self.runner(["delete", "pod", provider_node_id,
                     "-n", self.namespace, "--wait=false"])

    def non_terminated_nodes(self) -> List[str]:
        import json as _json

        out = self.runner(["get", "pods", "-n", self.namespace,
                           "-l", self.label, "-o", "json"])
        names = []
        for item in _json.loads(out or "{}").get("items", []):
            phase = item.get("status", {}).get("phase", "")
            if phase in ("Pending", "Running"):
                names.append(item["metadata"]["name"])
        return names
