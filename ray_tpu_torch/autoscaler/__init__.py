"""ray_tpu_torch.autoscaler: demand-driven node scale-up/down.

Port of ray_tpu/autoscaler/ over the port's runtime: host code, no torch.
Reference: python/ray/autoscaler/_private/ — StandardAutoscaler
(autoscaler.py:166) driven by Monitor (monitor.py:126) reading GCS resource
state; LoadMetrics (load_metrics.py:63); NodeProvider plugin API
(autoscaler/node_provider.py). TPU-specific: providers allocate whole
slices, not single VMs — a "node" is one TPU VM host carrying its slice
topology labels, and scale-up for an SPMD job means provisioning a full
slice's worth of hosts at once (QueuedResources/GKE provider planned;
LocalNodeProvider here exercises the control loop like the reference's
FakeMultiNodeProvider, fake_multi_node/node_provider.py:237).
"""

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    AWSProvider, GCEProvider, KubernetesProvider, LocalNodeProvider,
    NodeProvider, TPUPodProvider)

__all__ = ["StandardAutoscaler", "NodeProvider", "LocalNodeProvider",
           "TPUPodProvider", "GCEProvider", "AWSProvider",
           "KubernetesProvider"]
