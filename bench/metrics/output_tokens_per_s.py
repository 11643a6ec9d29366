"""Output tokens of the window's whole calls over their wall time: the
re-prefill steps count as time, not as tokens."""
from bench.stats import rate


def read(run):
    r = run.record
    if "calls" not in r:
        return None
    return rate(len(r["calls"]) * r["batch"] * r["max_new"], r["window_s"])
