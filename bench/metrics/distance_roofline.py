"""The distance kernel's (B1, ``distance_kernel``) device time against
the bytes its launches have to move (``bench/ops/distance_bytes.py``) at
the H100's 3.35 TB/s, over the traced segments."""
from bench.reduce import roofline_pct


def read(run):
    return roofline_pct(run.summary, "distance_kernel",
                        run.record.get("distance_launch_bytes"))
