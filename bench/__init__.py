"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
each metric's reader in ``metrics/<metric>.py``, the limits of its
correctness check in ``limits/<config>.json``, and the system that drives
the port for the configuration's ``system`` in ``systems/<system>.py``.

The yardstick lives here and nowhere in the program: traffic generation,
the plain references (``reference/``), the operation and byte counts of
the kernels and the model (``ops/``), the table of peaks, the trace
reduction, and the comparison that decides ``correct``. Nothing here
imports ``jax`` or the JAX package ``repro``.
"""
