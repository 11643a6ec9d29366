"""Stage-aware preemptions (``PoolMetrics.preemptions``) per 1,000
retrievals completed in the window."""


def read(run):
    r = run.record
    if not r.get("completed"):
        return None
    return 1000.0 * r["preemptions"] / r["completed"]
