"""Multi-cloud NodeProvider tests with fake command runners, on the port
(ray_tpu_torch/autoscaler/node_provider.py, ray_tpu_torch/util/spark.py):
tests/test_autoscaler_providers.py's cases re-aimed (ref: the reference
tests its cloud providers against moto/fake clients —
python/ray/tests/test_autoscaler.py MockProvider pattern; here the
pluggable runner IS the seam). The argv is the reference's word for word
(tests/test_torch_ops_parity.py holds it against the reference's); the
spark plan starts the port's nodelet and counts cards as "GPU"."""

import json

import pytest

from ray_tpu_torch.autoscaler import (AWSProvider, GCEProvider,
                                KubernetesProvider, TPUPodProvider)


class Recorder:
    def __init__(self, replies=None):
        self.calls = []
        self.replies = replies or {}

    def __call__(self, args, stdin=""):
        self.calls.append((list(args), stdin))
        for key, reply in self.replies.items():
            if key in " ".join(args):
                return reply
        return "[]"


# --- TPU queued resources ----------------------------------------------------


def test_tpu_provider_create_and_filtering():
    r = Recorder()
    p = TPUPodProvider(project="proj", zone="us-central2-b",
                       node_types={"v5e-8": {
                           "accelerator_type": "v5litepod-8"}},
                       runner=lambda a: r(a), cluster_name="c1")
    name = p.create_node("v5e-8", {"TPU": 8})
    assert name.startswith("ray-tpu-c1-v5e-8-")
    flat = " ".join(r.calls[0][0])
    assert "queued-resources create" in flat
    assert "--accelerator-type=v5litepod-8" in flat
    assert "--zone=us-central2-b" in flat

    listing = json.dumps([
        {"name": f"projects/p/locations/z/queuedResources/{name}",
         "state": {"state": "ACTIVE"}},
        {"name": "projects/p/locations/z/queuedResources/ray-tpu-OTHER-x",
         "state": {"state": "ACTIVE"}},
        {"name": f"projects/p/locations/z/queuedResources/{name}2",
         "state": {"state": "FAILED"}},
    ])
    r.replies["list"] = listing
    live = p.non_terminated_nodes()
    assert live == [name]          # other cluster + FAILED filtered out


def test_gce_provider_lifecycle():
    r = Recorder()
    p = GCEProvider(project="proj", zone="us-central1-a",
                    node_types={"cpu16": {"machine_type": "n2-standard-16",
                                          "image_family": "debian-12",
                                          "image_project": "debian-cloud"}},
                    runner=lambda a: r(a), cluster_name="c1")
    name = p.create_node("cpu16", {"CPU": 16})
    flat = " ".join(r.calls[0][0])
    assert "instances create" in flat
    assert "--machine-type=n2-standard-16" in flat
    assert "--image-family=debian-12" in flat
    p.terminate_node(name)
    assert "delete" in " ".join(r.calls[1][0])
    r.replies["list"] = json.dumps([
        {"name": name, "status": "RUNNING"},
        {"name": name + "b", "status": "TERMINATED"},
        {"name": "unrelated-vm", "status": "RUNNING"}])
    assert p.non_terminated_nodes() == [name]


def test_aws_provider_lifecycle():
    r = Recorder(replies={
        "run-instances": json.dumps(
            {"Instances": [{"InstanceId": "i-0abc"}]}),
        "describe-instances": json.dumps(
            {"Reservations": [{"Instances": [{"InstanceId": "i-0abc"},
                                             {"InstanceId": "i-0def"}]}]}),
    })
    p = AWSProvider(region="us-west-2",
                    node_types={"m5": {"instance_type": "m5.4xlarge",
                                       "ami": "ami-123"}},
                    runner=lambda a: r(a), cluster_name="c1")
    iid = p.create_node("m5", {"CPU": 16})
    assert iid == "i-0abc"
    flat = " ".join(r.calls[0][0])
    assert "--instance-type=m5.4xlarge" in flat
    assert "--image-id=ami-123" in flat
    assert "ray-cluster,Value=ray-tpu-c1" in flat
    assert p.non_terminated_nodes() == ["i-0abc", "i-0def"]
    flat = " ".join(r.calls[1][0])
    assert "tag:ray-cluster,Values=ray-tpu-c1" in flat
    assert "instance-state-name,Values=pending,running" in flat
    p.terminate_node("i-0abc")
    assert "terminate-instances" in " ".join(r.calls[2][0])


def test_kubernetes_provider_pod_spec():
    r = Recorder()
    p = KubernetesProvider(namespace="ray", image="ray-tpu:v1",
                           node_types={"tpu8": {"cpu": "8",
                                                "memory": "16Gi",
                                                "tpu": "8"}},
                           runner=r, cluster_name="c1")
    name = p.create_node("tpu8", {"CPU": 8, "TPU": 8})
    args, stdin = r.calls[0]
    assert args[:2] == ["apply", "-n"]
    pod = json.loads(stdin)
    assert pod["metadata"]["name"] == name
    assert pod["metadata"]["labels"]["ray-cluster"] == "c1"
    limits = pod["spec"]["containers"][0]["resources"]["limits"]
    assert limits == {"cpu": "8", "memory": "16Gi",
                      "google.com/tpu": "8"}
    # the pod runs the port's CLI
    assert pod["spec"]["containers"][0]["command"][:3] == [
        "python", "-m", "ray_tpu_torch.cli"]

    r.replies["get pods"] = json.dumps({"items": [
        {"metadata": {"name": name}, "status": {"phase": "Running"}},
        {"metadata": {"name": "dead"}, "status": {"phase": "Succeeded"}},
    ]})
    assert p.non_terminated_nodes() == [name]
    p.terminate_node(name)
    assert r.calls[-1][0][:2] == ["delete", "pod"]


# --- ray-on-spark shim -------------------------------------------------------


def test_spark_worker_plan():
    from ray_tpu_torch.util.spark import MAX_NUM_WORKER_NODES, _worker_plan

    plan = _worker_plan(3, 4, "10.0.0.1:6379",
                        resources_worker_node={"GPU": 8})
    assert len(plan) == 3
    cmd = " ".join(plan[1]["command"])
    assert "ray_tpu_torch.core.nodelet" in cmd
    assert "--gcs 10.0.0.1:6379" in cmd
    assert '"CPU": 4.0' in cmd and '"GPU": 8' in cmd
    # MAX sentinel yields a template spec
    assert len(_worker_plan(MAX_NUM_WORKER_NODES, 1, "h:1")) == 1
    with pytest.raises(ValueError):
        _worker_plan(0, 1, "h:1")


def test_spark_setup_gated_without_pyspark():
    from ray_tpu_torch.util.spark import setup_ray_cluster

    with pytest.raises(ImportError, match="pyspark"):
        setup_ray_cluster(num_worker_nodes=2)
