"""Mean host time of one fused K-extend chunk (``step_multi``, which ends
in its completion-mask sync), over the window's chunks."""
from bench.stats import mean


def read(run):
    chunks = run.record.get("chunk_s")
    return mean(chunks) * 1e3 if chunks else None
