"""Atomic npz checkpoints in the JAX package's layout."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
