"""Mean host time of one ``RealServer._retrieve`` call (one probe,
submitted and drained), over the window's probes."""
from bench.stats import mean


def read(run):
    calls = run.record.get("calls")
    if not calls:
        return None
    probes = [s for c in calls for _, s in c["probe_s"]]
    return mean(probes) * 1e3 if probes else None
