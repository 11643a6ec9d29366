"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` a ``breakdown``, and last the numbers compared, each
beside its limit); the same numbers end standard error. Exits non-zero,
printing no result, without the cards the cell asks for, when the port is
missing, or when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import env  # noqa: E402

env.one_thread()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    env.setup_paths()
    env.keep_caches_inside()
    from bench import manifest as mf
    from bench import runner

    man = mf.manifest()
    cell = mf.cell(man, args.workload)
    try:
        env.require_cards(cell["chips"])
    except env.NoCards as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    import torch

    torch.set_num_threads(1)
    out, checks, _ = runner.run_cell(
        cell, mf.config_file(man, cell["config"]),
        mf.traffic_file(cell["traffic"]), mf.limits_file(cell["config"]),
        mf.metrics_of(man, cell["name"], bool(args.trace)), args.seed,
        args.seconds, bool(args.trace), "cuda", T_START, cell["chips"])
    bad = env.forbidden_modules()
    if bad:
        print(f"no result: JAX modules loaded: {bad}", file=sys.stderr)
        return 4
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
