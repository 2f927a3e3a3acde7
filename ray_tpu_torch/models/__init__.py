"""Model zoo of the port: plain functions on tensors, JAX layouts kept.

``llama`` (serving over paged and contiguous KV, int8 weights, and the
training forward/loss, sequence parallel (``forward_sp``) and pipeline
parallel (``forward_pp``)), ``gpt2`` (the training forward/loss that
BASELINE.md's GPT-2 125M trainer runs), ``moe`` (the Mixture-of-Experts
Llama variant, experts over the data axes under ``ShardingRules.ep()``),
``vit`` (image classification) and ``registry`` (family, preset -> config
and module). Import-light: importing the package imports none of them."""
