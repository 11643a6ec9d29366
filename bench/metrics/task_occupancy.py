"""Share of the fixed-shape distance batch doing real work over the
window: ``PoolMetrics.tasks_emitted / tasks_capacity``."""


def read(run):
    r = run.record
    if not r.get("tasks_capacity"):
        return None
    return 100.0 * r["tasks_emitted"] / r["tasks_capacity"]
