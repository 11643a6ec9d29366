"""Reductions the metric readers share: a kernel's share of its
roofline, and the device's idle share, from the traced segments."""
from __future__ import annotations

from bench.peaks import H100_SXM


def roofline_pct(summary, kernel: str, launch_bytes) -> "float | None":
    """The bytes bound of the mean traced launch over its mean device
    time, in %: None when the trace holds no such launch. The launches
    recorded and the kernel events of the segments are the same launches
    up to one at a segment's edge, so the means are compared."""
    if summary is None or not launch_bytes:
        return None
    seconds, events = summary.kernel(kernel)
    if events == 0 or seconds <= 0:
        return None
    bound_s = sum(launch_bytes) / len(launch_bytes) / H100_SXM["hbm_bytes_per_s"]
    return 100.0 * bound_s / (seconds / events)


def idle_pct(summary) -> "float | None":
    if summary is None or summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
