"""ray_tpu_torch.core: the distributed runtime (tasks, actors, objects, scheduling).

Layering (bottom-up), mirroring the reference's architecture
(SURVEY.md section 1) but re-designed for TPU hosts:

- ids/config/status/serialization  — common substrate (ref: src/ray/common/)
- object_store                     — node object plane: native shm store +
                                     in-process memory store (ref: plasma +
                                     core_worker/store_provider/)
- rpc                              — asyncio message layer (ref: src/ray/rpc/)
- gcs                              — cluster control plane (ref: src/ray/gcs/)
- nodelet                          — per-node daemon: worker pool, leases,
                                     object manager (ref: src/ray/raylet/)
- worker                           — worker process runtime (ref: core_worker
                                     execution side)
- runtime                          — in-process driver/worker runtime:
                                     ownership, task manager, submission
                                     (ref: core_worker submission side)
"""
