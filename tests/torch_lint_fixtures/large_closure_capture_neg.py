"""Negative: arrays passed by ref/argument or built inside the task."""
import torch

import ray_tpu_torch

EMBEDDING_TABLE = torch.randn(50000, 512)
VOCAB_SIZE = 50000                          # plain scalar: cheap to close over


@ray_tpu_torch.remote
def embed(table, token_ids):
    return table[token_ids]                 # passed as argument (or ObjectRef)


@ray_tpu_torch.remote
def build_and_embed(token_ids):
    table = torch.randn(50000, 512)         # built inside the task
    return table[token_ids]


@ray_tpu_torch.remote
def count(token_ids):
    return len(token_ids) % VOCAB_SIZE      # scalar capture is fine


def local_embed(token_ids):
    return EMBEDDING_TABLE[token_ids]       # not a remote fn


def main():
    table_ref = ray_tpu_torch.put(EMBEDDING_TABLE)
    return embed.remote(table_ref, [1, 2, 3])
