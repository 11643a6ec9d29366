"""Share of the traced segments in which no operation ran on the card."""
from bench.reduce import idle_pct


def read(run):
    return idle_pct(run.summary) if "calls" in run.record else None
