"""One run of one cell: set-up, the measured window, with ``--trace 1``
a traced tail of the same traffic after it, the device's numbers, the
program freed, the comparison that decides ``correct``, and the result
line. ``run.py`` calls it on the card; the tests call it on
the CPU at a small size (``device="cpu"``, no card check)."""
from __future__ import annotations

import time

import torch

from bench import manifest as mf
from bench.check import verdict
from bench.trace import Tracer


class View:
    """What the metric readers read."""

    def __init__(self, system_run, summary, setup_s):
        self.record = system_run.record
        self.summary = summary
        self.setup_s = setup_s
        self.cfg = getattr(system_run, "cfg", None)


def device_info(device, n_cards: int, trace: bool, summary) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n_cards))
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_cards, "memory_peak_bytes": int(peak)}
    if trace:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def run_cell(cell: dict, config: dict, traffic: dict, limits: dict,
             metrics: list, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None, n_cards: int = 1) -> dict:
    """The result line's object for one run (``correct`` and the checks
    last), and the system run for inspection."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    tp = traffic.get("trace", {})
    tracer = Tracer(trace, tp["period_s"], tp["active_s"],
                    cuda=device.type == "cuda")
    sysrun = mf.system(config["system"]).Run(config, traffic, limits, seed,
                                             device, tracer)
    sysrun.setup()
    setup_s = time.perf_counter() - t_start
    sysrun.window(seconds)  # with ``trace``, the traced tail after it
    summary = tracer.summary if trace else None
    dev = device_info(device, n_cards, trace, summary)
    view = View(sysrun, summary, setup_s)
    values = {}
    for m in metrics:
        v = mf.reader(m["name"])(view)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    sysrun.close()
    checks = sysrun.check()
    out = {"correct": verdict(checks) and sysrun.record["failed"] == 0,
           "attempted": int(sysrun.record["attempted"]),
           "failed": int(sysrun.record["failed"]),
           "metrics": values, "device": dev}
    if trace:
        out["breakdown"] = summary.breakdown()
    counters = dict(getattr(sysrun, "counters", {}))
    if counters:
        out["counters"] = counters
    out["checks"] = {c.name: c.entry() for c in checks}
    return out, checks, sysrun
