"""The readings that a cell's limits are set from: the program's compared
numbers on each seed, and the control's (the reference in the program's
place at the precision below the configuration's) on the control seeds,
at the cell's own size and load, several seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds S] [--longest]

``--longest`` runs only the traffic's longest prompt length, the call a
run compares. ``--fault early_stop`` plants a fault under the program
(every search stops after two extends) for the readings a recall limit
is set against. Prints one JSON line a seed. The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import env  # noqa: E402

env.one_thread()


def plant_early_stop():
    """Every retrieval completes after two extends: answers of the right
    form, with their ids' own distances, from a search cut short."""
    from repro_torch.core import trinity_pool
    from repro_torch.core.continuous_batching import SlotParams

    trinity_pool.VectorPool._params_for = (
        lambda self, req, rep=None: SlotParams(budget=2))


FAULTS = {"early_stop": plant_early_stop}


def readings(cell, config, traffic, limits, seed, seconds, control,
             device="cuda"):
    """One seed: the program's run through its window, then its readings
    and (with ``control``) the control's."""
    import torch

    from bench import manifest as mf
    from bench.trace import Tracer

    t0 = time.perf_counter()
    run = mf.system(config["system"]).Run(config, traffic, limits, seed,
                                          device, Tracer(False))
    run.setup()
    run.window(seconds)
    run.close()
    t1 = time.perf_counter()
    out = run.readings(control)
    out.update(seed=seed, attempted=run.record["attempted"],
               failed=run.record["failed"], run_s=t1 - t0,
               judge_s=time.perf_counter() - t1,
               counters=dict(getattr(run, "counters", {})))
    # the run's wrappers hold it in reference cycles: free its weights
    # before the next seed makes its own
    del run
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--longest", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    env.setup_paths()
    env.keep_caches_inside()
    from bench import manifest as mf

    man = mf.manifest()
    cell = mf.cell(man, args.workload)
    env.require_cards(cell["chips"])
    config = mf.config_file(man, cell["config"])
    traffic = mf.traffic_file(cell["traffic"])
    if args.longest:
        traffic["prompt_lengths"] = [max(traffic["prompt_lengths"])]
    limits = mf.limits_file(cell["config"])
    if args.fault:
        FAULTS[args.fault]()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctrl - set(seeds)):
        r = readings(cell, config, traffic, limits, seed, args.seconds,
                     seed in ctrl)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
