"""Runnable examples of the port (the JAX package's ``examples/``)."""
