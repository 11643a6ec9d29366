"""Dense GQA decoder-only models of the port (the JAX package's
``models/``): layers, attention with the prefill/decode kernels, the
transformer stack and the architecture dispatch."""
