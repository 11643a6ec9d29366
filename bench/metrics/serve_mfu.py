"""The model FLOPs the window's requests need (``bench/ops/model_flops.py``:
prompt and new tokens through the routed experts and attention, no
re-prefill, no unrouted expert) over the window times the H100's
989 TFLOP/s in bf16, in %."""
from bench.ops.model_flops import request_flops
from bench.peaks import H100_SXM


def read(run):
    r = run.record
    calls = r.get("calls")
    if not calls:
        return None
    flops = sum(r["batch"] * request_flops(run.cfg, c["S"], r["max_new"])
                for c in calls)
    return 100.0 * flops / (r["window_s"] * H100_SXM["bf16_flops"])
