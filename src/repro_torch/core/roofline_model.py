"""Paper §2: roofline utilisation model for prefill / decode / vector search.

    u_max = min(1, AI · B_mem / P_peak)
    u(X)  = min(u_max, (X / X_sat)^alpha)

plus the calibrated per-step timing model the pools' simulated clock and
the cluster simulator are priced by: a copy of the JAX package's
``core/roofline_model.py``. The clocks must use the same prices as the
JAX package for completion times to match.

These are model outputs for the TPU-v5e-class ``V5E`` row (197 TFLOP/s
bf16, 819 GB/s HBM, 50 GB/s/link ICI), not times measured on any card;
nothing derived from them is an H100 number. The parameter counts come
from the port's ``models/model_zoo.analytic_param_count``, which covers
every model family of the JAX package.
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


def u_max(ai: float, hw: Hardware = V5E) -> float:
    return min(1.0, ai * hw.hbm_bw / hw.peak_flops)


def u_curve(x: float, x_sat: float, alpha: float, umax: float) -> float:
    return min(umax, (x / x_sat) ** alpha) if x > 0 else 0.0


# ---------------------------------------------------------------------------
# stage-specific arithmetic intensities and saturation scales (paper Fig. 1)
# ---------------------------------------------------------------------------


def prefill_ai(seq_len: int, d_model: int) -> float:
    """Big GEMMs: per token ≈ 2·d (weights read once per tile) — AI rises
    with effective batch·seq; approximate with the GEMM AI bound d/2 at
    bf16, comfortably past the compute roof."""
    return min(seq_len, d_model) / 2.0


def decode_ai(batch: int, n_active_params: float = 2.8e9,
              kv_read_per_req: float = 0.94e9) -> float:
    """Decode arithmetic intensity: weights amortise over the batch but the
    per-request KV read does not —
        AI(B) = 2·N·B / (2·N·bytes + B·kv_read_per_req)
    rising with B and saturating at 2·N/kv_read ≈ 6 FLOP/B (deepseek-moe-16b
    active params, 4k context ⇒ ~0.94 GB KV per request per step), i.e. a
    plateau u_max ≈ 2.5% — far below the compute roof (paper Fig. 1)."""
    flops = 2.0 * n_active_params * batch
    bytes_ = 2.0 * n_active_params + batch * kv_read_per_req
    return flops / bytes_


def ann_ai(graph_degree: int) -> float:
    """Graph traversal: each gathered db row (d·4 bytes f32) is used for
    one d-MAC distance ⇒ AI ≈ 0.5 FLOP/byte, batch-independent."""
    return 0.5


def stage_curves(cfg, batch_points, q_points, hw: Hardware = V5E):
    """Returns the Fig. 1 dataset: utilisation vs batch for the 3 stages."""
    rows = []
    u_pre_max = 1.0
    u_dec_max = lambda b: u_max(decode_ai(b), hw)
    u_ann_max = u_max(ann_ai(cfg.graph_degree), hw)
    for b in batch_points:
        rows.append(("prefill", b, u_curve(b, 4.0, 0.9, u_pre_max)))
        rows.append(("decode", b, u_curve(b, 64.0, 0.8, u_dec_max(b))))
    for q in q_points:
        rows.append(("vector_search", q, u_curve(q, 48.0, 0.8, u_ann_max)))
    return rows


# ---------------------------------------------------------------------------
# calibrated step-time model (drives the cluster simulator)
# ---------------------------------------------------------------------------


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


def per_request_batch_search_time(pool_cfg, batch: int, max_extends: int,
                                  hw: Hardware = V5E) -> float:
    """Baseline: lockstep batch pays the *max* extend count (stragglers)."""
    per_extend = extend_time(pool_cfg, hw,
                             active_tasks=batch * pool_cfg.parents_per_step
                             * pool_cfg.graph_degree)
    return max_extends * per_extend


def prefill_time(cfg, tokens: int, n_chips: int, hw: Hardware = V5E) -> float:
    """Compute-bound prefill: 2·N_active·tokens FLOPs (+ quadratic attention
    ignored below 32k — sub-1% for the assigned shapes)."""
    from repro_torch.models.model_zoo import analytic_param_count

    n_active = analytic_param_count(cfg, active_only=True)
    flops = 2.0 * n_active * tokens
    weights_bytes = 2.0 * n_active
    compute = flops / (n_chips * hw.peak_flops)
    memory = weights_bytes / (n_chips * hw.hbm_bw)
    return hw.launch_floor + max(compute, memory)


def decode_step_time(cfg, batch: int, avg_ctx: int, n_chips: int,
                     hw: Hardware = V5E) -> float:
    """Memory-bound decode: weights read once per step + per-request KV."""
    from repro_torch.models.model_zoo import analytic_param_count
    from repro_torch.serving.kv_cache import kv_bytes_per_token

    n_active = analytic_param_count(cfg, active_only=True)
    flops = 2.0 * n_active * batch
    bytes_ = 2.0 * n_active + batch * avg_ctx * kv_bytes_per_token(cfg)
    compute = flops / (n_chips * hw.peak_flops)
    memory = bytes_ / (n_chips * hw.hbm_bw)
    return hw.launch_floor + max(compute, memory)


def model_step_times(cfg, shape, n_chips: int, hw: Hardware = V5E):
    """(compute_s, memory_s) for one LLM step of `cfg` at `shape` on
    n_chips — coarse analytic fallback used by the cluster simulator when a
    dry-run-derived table is not loaded."""
    from repro_torch.models.model_zoo import analytic_param_count

    n_active = analytic_param_count(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    flops = 2.0 * n_active * tokens
    compute = flops / (n_chips * hw.peak_flops)
    if shape.kind == "decode":
        # weights + kv read per step
        bytes_ = n_active * 2.0 + shape.global_batch * shape.seq_len * 1024
    else:
        bytes_ = n_active * 2.0 + tokens * 4096
    memory = bytes_ / (n_chips * hw.hbm_bw)
    return compute, memory
