"""Developer tooling: ``chaos.py`` (the GCS, the nodelet and the runtime
import it lazily to install a fault plan from their Config) and raylint
(``lint/``), the distributed-correctness static analysis of the port's
tree: ``python -m ray_tpu_torch.devtools.lint`` or ``python -m
ray_tpu_torch.cli lint``.
"""
