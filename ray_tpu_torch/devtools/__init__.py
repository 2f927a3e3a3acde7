"""Developer tooling: only ``chaos.py`` is ported so far (the GCS, the
nodelet and the runtime import it lazily to install a fault plan from
their Config). raylint (``ray_tpu/devtools/lint``) is ROADMAP.md queue 1
item 11.4.
"""
