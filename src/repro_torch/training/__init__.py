"""Training of the port (the JAX package's ``training/``): synthetic data,
AdamW with float32 moments, the microbatched train step and ``Trainer``
with periodic atomic checkpoints and resume."""
