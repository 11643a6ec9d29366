"""Trinity's shared vector-search pool on PyTorch and CUDA (NVIDIA Hopper).

The port mirrors the JAX package's layout so each module's counterpart is
found by path:

  configs/base.py           — ``VectorPoolConfig`` (same fields, defaults)
  vector/                   — synthetic dataset, exact kNN oracle, CAGRA-like
                              graph builder, hash probe + topM merge, the
                              read side of the online index
  kernels/                  — the fixed-shape distance stage: plain-torch
                              versions (``ref``), the hand-written Hopper
                              kernels (``distance`` + ``csrc/distance.cu``),
                              the device dispatcher (``ops``), the builder
  core/                     — scheduler, roofline prices, continuous-batching
                              engine, the monolithic ``VectorPool``
  prng.py                   — bit-exact threefry2x32 entry-point PRNG
  convert.py                — index, engine state and checkpoints from numpy
  training/, checkpoint/    — synthetic data, AdamW, the train step and
                              ``Trainer``; atomic npz checkpoints
  launch/, examples/        — the serving and training drivers

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
the CPU is used only when the caller asks for it (``device="cpu"``), and a
missing card raises instead of falling back. The package imports neither
``jax`` nor anything of the JAX package.
"""
