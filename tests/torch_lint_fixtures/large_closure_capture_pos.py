"""Positive: remote fns closing over module-level array constants."""
import numpy as np
import torch

import ray_tpu_torch

EMBEDDING_TABLE = np.random.randn(50000, 512)
ROPE_FREQS = torch.arange(0, 64, dtype=torch.float32)


@ray_tpu_torch.remote
def embed(token_ids):
    return EMBEDDING_TABLE[token_ids]       # ~100MB pickled per task


@ray_tpu_torch.remote
class Encoder:
    def rotate(self, x):
        return x * ROPE_FREQS               # tensor constant, per task


WEIGHTS = torch.randn(4096, 4096)


@ray_tpu_torch.remote(num_gpus=1)
def project(x):
    return x @ WEIGHTS                      # 64 MiB pickled per task
