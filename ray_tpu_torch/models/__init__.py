"""Model zoo of the port: plain functions on tensors, JAX layouts kept.

Only ``llama`` is ported so far (serving over paged and contiguous KV,
int8 weights, and the training forward/loss)."""
