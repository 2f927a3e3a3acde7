"""ray_tpu_torch.ops: hand-written Hopper kernels and their plain versions.

- paged_attention: the fused paged decode write-and-attend kernel (K6)
  and read-only paged decode attention (K5), one split-KV kernel.
- flash_attention: the flash attention forward, causal/full (K1) or with a
  sliding window (K2), and its FlashAttention-2 backward, dQ (K3) and
  dK/dV (K4), behind a ``torch.autograd.Function``.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
its plain PyTorch version for CPU tensors. Kernels build lazily, at the
first launch, so importing this package needs neither ``nvcc`` nor a card.
"""
