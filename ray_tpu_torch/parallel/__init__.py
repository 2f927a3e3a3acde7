"""ray_tpu_torch.parallel: the training step (``train_step.py``).

Port of the single-device part of ``ray_tpu/parallel``. Import-light:
importing the package imports nothing; ``train_step`` imports torch.
Meshes, sharding rules and presets (``mesh.py``, ``sharding.py``,
``presets.py``) wait for ROADMAP.md queue 1 item 4, and the pipeline
(``pipeline.py``) for item 8; every ``mesh=`` argument raises until then.
"""
