"""Model zoo of the port: plain functions on tensors, JAX layouts kept.

Only ``llama`` is ported so far (the paged serving path and the training
forward/loss)."""
