"""Mean over every request of the window of the time from its call's
start to the prefill logits (``generate``'s ``ttft_s``, its prefill
probes included); a call's requests share its TTFT."""
from bench.stats import mean


def read(run):
    calls = run.record.get("calls")
    return mean(c["ttft_s"] for c in calls) * 1e3 if calls else None
