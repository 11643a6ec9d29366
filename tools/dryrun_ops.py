"""Where a dry-run cell's counts come from: trace one (arch × shape) cell
as ``launch/dryrun.py`` does and split its per-device flops, bytes and
collective bytes by ATen op and by the model function that issued it (the
innermost frame under ``repro_torch/models`` or ``repro_torch/training``).

Usage:
  PYTHONPATH=src python tools/dryrun_ops.py --arch xlstm-350m \
      --shape prefill_32k [--top 25] [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import cost, dryrun, mesh

_MODEL_DIRS = (os.sep + os.path.join("repro_torch", "models") + os.sep,
               os.sep + os.path.join("repro_torch", "training") + os.sep)


def _site() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if any(d in name for d in _MODEL_DIRS):
            return f"{os.path.basename(name)}:{f.f_code.co_name}"
        f = f.f_back
    return "-"


class _ByOp(cost.CostCounter):
    """The counter, each op's share of its counts kept by op and site."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.by = defaultdict(lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = (self.flops, self.bytes_accessed,
                  sum(self.collective_bytes.values()))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        after = (self.flops, self.bytes_accessed,
                 sum(self.collective_bytes.values()))
        if after != before:
            row = self.by[(str(func), _site())]
            for i in range(3):
                row[i] += after[i] - before[i]
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    counters = []

    def make(**kw):
        counters.append(_ByOp(**kw))
        return counters[-1]

    dryrun.CostCounter = make
    got = dryrun.trace_cell(get_config(args.arch), SHAPES[args.shape],
                            mesh.make_production_mesh())
    by = counters[0].by
    print(f"{args.arch} × {args.shape} × 16x16: trace {got['trace_s']:.1f} s"
          f", flops {got['flops']:.4e} bytes {got['bytes_accessed']:.4e} "
          f"collective {got['collective_bytes']['total']:.4e}")
    for i, what in enumerate(("flops", "bytes", "collective bytes")):
        total = sum(r[i] for r in by.values()) or 1
        print(f"\n{what} by op and site (share of {total:.4e}):")
        rows = sorted(by.items(), key=lambda kv: -kv[1][i])[:args.top]
        for (op, site), r in rows:
            if r[i]:
                print(f"  {r[i] / total:7.2%}  {r[i]:.4e}  {op}  {site}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cell": got, "by": [
                {"op": op, "site": site, "flops": r[0], "bytes": r[1],
                 "collective": r[2]} for (op, site), r in by.items()]},
                f, indent=1)


if __name__ == "__main__":
    main()
