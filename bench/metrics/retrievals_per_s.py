"""Completed retrievals over the window's wall time (host clock)."""
from bench.stats import rate


def read(run):
    r = run.record
    return rate(r["completed"], r["window_s"]) if "completed" in r else None
