"""95th percentile of the host-clock latency of every prefill-class
retrieval due in the window, from when it was due to when it was seen
complete (drained after the close)."""
from bench.stats import percentile


def read(run):
    lat = run.record.get("latency_s", {}).get("prefill")
    return percentile(lat, 95) * 1e3 if lat else None
