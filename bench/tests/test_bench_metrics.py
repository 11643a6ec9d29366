"""The metric arithmetic: tails of all samples, rates over whole calls,
the trace's reduction and the operation counts."""
import math
import types

import pytest

from bench import manifest as mf
from bench import reduce, stats
from bench.ops import decode_attention_bytes, distance_bytes, model_flops
from bench.trace import Summary, busy_us, reduce_events


def view(record, summary=None, cfg=None):
    return types.SimpleNamespace(record=record, summary=summary, cfg=cfg,
                                 setup_s=12.5)


def test_percentile_is_a_tail_of_every_sample():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 100], 95) == 100
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_by_statistics_quantiles():
    assert stats.spread([1, 1, 1, 1]) == 0.0
    assert stats.spread([90, 100, 110, 100, 100]) == pytest.approx(0.1)


def test_prefill_tail_reads_prefill_only():
    r = {"latency_s": {"prefill": [0.01] * 19 + [0.5], "decode": [9.0]}}
    assert mf.reader("prefill_retrieval_p95_ms")(view(r)) == pytest.approx(10)


def test_retrievals_per_s_over_the_window():
    r = {"completed": 900, "window_s": 4.5}
    assert mf.reader("retrievals_per_s")(view(r)) == pytest.approx(200)


def calls():
    return [{"S": 8, "ttft_s": 0.2, "t_start": 0.0, "t_decode0": 0.2,
             "t_end": 1.0, "probe_s": [("prefill", 0.05), ("decode", 0.1)],
             "reprefill_s": 0.5},
            {"S": 16, "ttft_s": 0.4, "t_start": 1.0, "t_decode0": 1.4,
             "t_end": 3.0, "probe_s": [("prefill", 0.15)],
             "reprefill_s": 1.2}]


def test_rates_over_whole_calls():
    r = {"calls": calls(), "batch": 4, "max_new": 8, "window_s": 3.0}
    v = view(r)
    assert mf.reader("output_tokens_per_s")(v) == pytest.approx(64 / 3.0)
    assert mf.reader("ttft_ms")(v) == pytest.approx(300)
    assert mf.reader("retrieve_ms.serve")(v) == pytest.approx(100)
    assert mf.reader("reprefill_share")(v) == pytest.approx(170 / 3)
    # (0.8 - 0.1 + 1.6) s over (8 + 8) + (16 + 8) decode steps
    assert mf.reader("decode_step_ms")(v) == pytest.approx(2300 / 40)
    assert mf.reader("setup_s")(v) == 12.5


def test_pool_counters():
    r = {"chunk_s": [0.004, 0.006], "tasks_emitted": 300,
         "tasks_capacity": 1000, "preemptions": 3, "completed": 1500}
    v = view(r)
    assert mf.reader("extend_chunk_ms")(v) == pytest.approx(5)
    assert mf.reader("task_occupancy")(v) == pytest.approx(30)
    assert mf.reader("preemptions_per_1k")(v) == pytest.approx(2)


class Ev:
    def __init__(self, name, kind, a, b, dev="cuda"):
        self._n, self._k, self._a, self._b, self._d = name, kind, a, b, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._d == "cuda" else "DeviceType.CPU"


def test_trace_reduction():
    evs = [Ev("bench.pool.step_multi", "user_annotation", 0, 1000, "cpu"),
           Ev("bench.pool.step_multi", "gpu_user_annotation", 0, 1000),
           Ev("ProfilerStep#3", "gpu_user_annotation", 0, 1000),
           Ev("distance_kernel<true>", "kernel", 100, 300),
           Ev("other", "kernel", 250, 400),
           Ev("Memcpy DtoH", "gpu_memcpy", 700, 800),
           Ev("aten::add", "cpu_op", 0, 50, "cpu")]
    s = Summary()
    reduce_events(evs, 1e-6, s)
    assert s.busy_s == pytest.approx(400e-9)
    assert s.window_s == 1e-6 and s.segments == 1
    assert s.kernel("distance_kernel") == (pytest.approx(200e-9), 1)
    assert s.gap_s["bench.pool.step_multi"] == pytest.approx(600e-9)
    bd = s.breakdown()
    assert bd["device_ops"][0][0] == "distance_kernel<true>"
    assert reduce.idle_pct(s) == pytest.approx(60)
    assert busy_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_roofline_is_the_mean_bound_over_the_mean_time():
    s = Summary()
    s.op_s["decode_split_kernel<x>"] = 2e-6
    s.op_n["decode_split_kernel<x>"] = 2
    bw = 3.35e12
    got = reduce.roofline_pct(s, "decode_split_kernel", [bw * 1e-7] * 2)
    assert got == pytest.approx(10.0)
    assert reduce.roofline_pct(s, "distance_kernel", [1]) is None
    assert reduce.roofline_pct(None, "x", [1]) is None


def test_distance_bytes_count_each_row_once():
    import torch

    ids = torch.tensor([5, 5, 7, -1], dtype=torch.int32)
    slots = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    # rows 5, 7 and queries 0, 1 of 16 floats; 3 valid (id, slot) pairs;
    # 4 outputs
    assert distance_bytes.launch_bytes(ids, slots, 16) == (
        4 * 16 * 4 + 3 * 8 + 4 * 4)


def test_decode_attention_bytes():
    b = decode_attention_bytes.launch_bytes(2, 8, 2, 64, 10, 2, 2)
    assert b == 2 * 2 * 10 * 2 * 64 * 2 + 2 * 2 * 8 * 64 * 2


def test_request_flops_by_hand():
    from bench.systems.serve import model_config
    from bench_tiny import serve_cell

    cfg = model_config(serve_cell()[0])
    # d 64, ffn 96, 4/2 heads of 16, 4 experts top-2, d_inner 128,
    # d_state 16, conv 4, dt rank 4, vocab 512; 7 Mamba + 1 attention,
    # 4 MoE + 4 SwiGLU
    mamba = 2 * (64 * 256 + 128 * 36 + 4 * 128 + 128 * 64) + 2 * 4 * 128 \
        + 7 * 128 * 16
    attn = 2 * (2 * 64 * 64 + 2 * 64 * 32)
    moe = 2 * (64 * 4 + 2 * 3 * 64 * 96)
    dense = 2 * 3 * 64 * 96
    n = 8 + 8
    want = (n * (7 * mamba + attn + 4 * moe + 4 * dense)
            + 4 * 4 * 16 * n * (n + 1) // 2 + 9 * 2 * 64 * 512)
    assert model_flops.request_flops(cfg, 8, 8) == pytest.approx(want)
    assert [k for k, _ in model_flops.layer_kinds(cfg)].index("attn") == 4


def test_serve_mfu_against_the_peak():
    from bench.systems.serve import model_config
    from bench_tiny import serve_cell

    cfg = model_config(serve_cell()[0])
    r = {"calls": calls(), "batch": 4, "max_new": 8, "window_s": 3.0}
    want = 4 * (model_flops.request_flops(cfg, 8, 8)
                + model_flops.request_flops(cfg, 16, 8)) / (3.0 * 989e12)
    assert mf.reader("serve_mfu")(view(r, cfg=cfg)) == pytest.approx(100 * want)
    assert not math.isnan(want)
