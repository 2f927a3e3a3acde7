"""Model zoo of the port: plain functions on tensors, JAX layouts kept.

``llama`` (serving over paged and contiguous KV, int8 weights, and the
training forward/loss) and ``gpt2`` (the training forward/loss that
BASELINE.md's GPT-2 125M trainer runs)."""
