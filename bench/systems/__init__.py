"""Systems under test, one module a configuration ``system``: each makes
its inputs from the seed, drives the port through its normal entry
points, and judges what the timed path produced against a plain
reference.

A system module has ``Run(config, traffic, limits, seed, device,
tracer)`` with ``setup()``, ``window(seconds)``, ``close()`` (frees the
program's state) and ``check() -> [Check]``, and fills ``Run.record``
with what the metric readers read."""
