"""Operation and byte counts of the kernels and of the model, from their
shapes: each input byte read once, each output byte written once."""
