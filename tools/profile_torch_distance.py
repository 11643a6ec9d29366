#!/usr/bin/env python3
"""Device time of the port's distance kernels (B1 ``distance_slot_gather``,
B2 ``distance_onehot``) at ``chip_smoke.py`` phase 2's shapes, for this tree
and another checkout in turns on one NVIDIA GPU, with their outputs held
bit-equal.

    python3 tools/profile_torch_distance.py --src OTHER/src   # old, new, new, old
    python3 tools/profile_torch_distance.py --worker [--src DIR] [--label L] [--out FILE]

``--src`` points at the ``src`` directory of another checkout of the repo
(for example a ``git archive`` of a parent commit unpacked under a
directory ``.gitignore`` lists). Without ``--worker`` the script runs a
worker process per turn, old, new, new, old, each of which builds its
tree's kernels, times every case, prints one JSON line and saves its
outputs; the script then asserts ``torch.equal`` between the old and the
new outputs of every case, kernel and metric, and prints one JSON line of
the times side by side.

Cases: G = 1 at the engine shape (N 10^6, d 128, R 64, T 2048, 128 task
sets so rows come from HBM) and at the serving pool's (N 2000, d 64, R 16,
T 512); then G in {1, 4, 16, 32} lanes at T 2048, R 64, d 128, each lane
250,000 rows (the 10^6 rows as 4 shards, repeated), each lane its own ids
(25% dummies, slots in the engine's layout); then G = 32 with each lane's
ids sorted, and with 2048 consecutive rows a lane, to show what bounds the
random case. A tree whose kernels have no
lane form (the parent) runs a lane case flattened: db viewed as (G N, d),
ids offset by g N, slots by g R, one launch over G T tasks: the same work.
Every time is ``chip_smoke.device_ms`` of l2 calls: the median CUDA-event
pair around a launch and the back-to-back time (one event pair around 240
launches, over the count), with the launch floor (a one-element add) and
a streaming read of as many bytes (``torch.sum``) beside them. The inputs are made on the card from fixed seeds, so every turn sees
the same data.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (device_ms, distance_bound, floor_ms,  # noqa: E402
                        lane_sets)

LANES = (1, 4, 16, 32)
OUT_DIR = ROOT / "build" / "profile"


def cases():
    """[(label, dbs (G, N, d), queries (G, R, d), sets)] on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    db = torch.randn((10 ** 6, 128), generator=gen, device="cuda")
    q = torch.randn((32 * 64, 128), generator=gen, device="cuda").view(32, 64, 128)
    out = [("engine G=1", db[None], q[:1], lane_sets(db[None], q[:1], 2048, 128, 1))]
    sdb = torch.randn((1, 2000, 64), generator=gen, device="cuda")
    sq = torch.randn((1, 16, 64), generator=gen, device="cuda")
    out.append(("serve pool G=1", sdb, sq, lane_sets(sdb, sq, 512, 32, 2)))
    dbs = db.view(4, 250_000, 128).repeat(8, 1, 1)  # 4 shards x 8 replicas
    for G in LANES:
        out.append((f"lanes G={G}", dbs[:G], q[:G],
                    lane_sets(dbs[:G], q[:G], 2048, max(8, 128 // G), 10 + G)))
    # what bounds G = 32: the same rows with each lane's ids sorted (nearby
    # rows share DRAM pages), and 2048 consecutive rows a lane (the 8 sets
    # start at 8 places) with no dummies
    G, sets = 32, out[-1][3]
    out.append(("lanes G=32 sorted", dbs, q[:G], [
        (a, b, ids.sort(dim=1).values, slot) for a, b, ids, slot in sets]))
    step = torch.arange(2048, device="cuda", dtype=torch.int32)
    out.append(("lanes G=32 consecutive", dbs, q[:G], [
        (a, b, (step + 30_000 * k).expand(G, 2048).contiguous(), slot)
        for k, (a, b, _, slot) in enumerate(sets)]))
    return out


def worker(args):
    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's src
    import torch

    from repro_torch.kernels import distance

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (CUDA is not available)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    lanes = hasattr(distance, "distance_slot_gather_group")
    res = {"label": args.label, "src": args.src, "card": smi,
           "form": "lanes" if lanes else "flattened", "cases": []}
    saved = {}
    for label, dbs, q, sets in cases():
        G, N, d = dbs.shape
        R = q.shape[1]
        bound, _, nbytes = distance_bound(sets, 3)  # bytes bind at every case
        # a yardstick: one streaming read (torch.sum) of as many bytes
        flat = dbs.view(-1)[:int(nbytes) // 4]
        stream_ms, stream_b2b = device_ms(lambda x: x.sum(), [(flat,)],
                                          hold_cycles=500_000_000)
        res.setdefault("bounds", {})[label] = dict(
            bound_ms=bound, bytes=nbytes, stream_ms=stream_ms,
            stream_b2b_ms=stream_b2b)
        if not lanes:  # the same work as one launch over G T tasks
            lane = torch.arange(G, device="cuda", dtype=torch.int32)[:, None]
            sets = [(db.reshape(G * N, d), qq.reshape(G * R, d),
                     torch.where(ids >= 0, ids + lane * N, ids).flatten(),
                     (slot + lane * R).flatten()) for db, qq, ids, slot in sets]
        for name in ("distance_slot_gather", "distance_onehot"):
            fn = getattr(distance, name + ("_group" if lanes else ""))
            for metric in ("l2", "ip"):
                saved[label, name, metric] = fn(
                    *sets[0], metric=metric).view(G, -1).cpu()
            ms, b2b = device_ms(lambda *a: fn(*a, metric="l2"), sets,
                                hold_cycles=500_000_000)
            res["cases"].append(dict(case=label, kernel=name, G=G, ms=ms,
                                     b2b_ms=b2b))
        del sets
    res["floor_ms"], res["floor_b2b_ms"] = floor_ms()
    if args.out:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        torch.save(saved, args.out)
    print(json.dumps(res), flush=True)


def run_turns(args):
    import torch

    turns = [("old", args.src), ("new", str(ROOT / "src")),
             ("new", str(ROOT / "src")), ("old", args.src)]
    runs = []
    for i, (label, src) in enumerate(turns):
        out = OUT_DIR / f"distance_{i}_{label}.pt"
        cmd = [sys.executable, __file__, "--worker", "--src", src,
               "--label", label, "--out", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"turn {i} ({label}) failed:\n{proc.stdout}{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1]),
                     torch.load(out)))
    old, new = runs[0][2], runs[1][2]
    unequal = [key for key in new if not torch.equal(new[key], old[key])]
    rows = {}
    for label, r, _ in runs:
        for c in r["cases"]:
            row = rows.setdefault((c["case"], c["kernel"]), dict(
                case=c["case"], kernel=c["kernel"], **r["bounds"][c["case"]]))
            for k in ("ms", "b2b_ms"):
                row.setdefault(f"{label}_{k}", []).append(c[k])
    print(json.dumps({"card": runs[0][1]["card"], "old_form": runs[0][1]["form"],
                      "floor": [(r["floor_ms"], r["floor_b2b_ms"]) for _, r, _ in runs],
                      "outputs_equal": not unequal,
                      "unequal": [list(k) for k in unequal],
                      "table": list(rows.values())}))
    if unequal:
        raise SystemExit(f"old and new outputs differ: {unequal}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed (the "
                         "old tree, when running the four turns)")
    ap.add_argument("--worker", action="store_true",
                    help="time one tree once instead of four turns")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="worker: save the outputs here (torch.save)")
    args = ap.parse_args()
    if args.worker:
        worker(args)
    else:
        run_turns(args)


if __name__ == "__main__":
    main()
