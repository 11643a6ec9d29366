"""Sharding rules of the port (the JAX package's ``distributed``)."""
