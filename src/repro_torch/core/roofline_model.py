"""Extend-step prices for the pool's simulated clock.

A copy of the JAX package's ``core/roofline_model.py`` trimmed to what the
pools use: the ``Hardware`` row, ``extend_time`` and ``extend_time_group``
(the megabatched sharded pool's price). The pool's clock is a
*simulated* clock priced by this model, so the port must use the same
prices as the JAX package for its completion times to match.

These are model outputs for the TPU-v5e-class ``V5E`` row (197 TFLOP/s
bf16, 819 GB/s HBM), not times measured on any card; nothing derived from
them is an H100 number. An H100 row waits until the card has measured it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 197e12  # bf16
    hbm_bw: float = 819e9
    ici_bw: float = 50e9  # per link
    dcn_bw: float = 6.25e9  # per host, inter-pod
    intra_node_lat: float = 2e-6  # ICI hop
    network_lat: float = 20e-6  # DCN / pool-to-pool RPC
    launch_floor: float = 5e-6  # per fixed-shape op dispatch


V5E = Hardware()


def extend_time(pool_cfg, hw: Hardware = V5E, active_tasks: int | None = None) -> float:
    """One continuous-batching extend: T gathered rows of d floats from HBM
    (memory term) + T·d MACs (compute term) + fixed dispatch floor."""
    T = pool_cfg.task_batch if active_tasks is None else max(active_tasks, 1)
    d = pool_cfg.dim
    mem = T * d * 4 / hw.hbm_bw
    flops = 2.0 * T * d / hw.peak_flops
    return hw.launch_floor + max(mem, flops)


def extend_time_group(pool_cfg, cohort: int, double_buffer: bool = False,
                      hw: Hardware = V5E) -> float:
    """Per-member extend time inside a megabatched cohort: ``cohort``
    lanes share ONE fixed-shape dispatch, so the launch floor (a host-side
    per-dispatch cost) amortises across them while each lane still pays
    its own memory/compute term. With double buffering the host dispatch
    work overlaps the previous chunk's device compute, so the per-step
    cost is the max of the two instead of their sum. ``cohort=1`` without
    double buffering reduces exactly to :func:`extend_time`."""
    T = pool_cfg.task_batch
    d = pool_cfg.dim
    mem = T * d * 4 / hw.hbm_bw
    flops = 2.0 * T * d / hw.peak_flops
    dev = max(mem, flops)
    host = hw.launch_floor / max(cohort, 1)
    return max(host, dev) if double_buffer else host + dev
