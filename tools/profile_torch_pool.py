#!/usr/bin/env python3
"""Where the port's pool spends a chunk on the card: a ``torch.profiler``
trace over a steady window of the sift1m-shape cell (the corpus, graph,
engine and stream of ``chip_smoke.py`` phase 3).

    python3 tools/profile_torch_pool.py     # one NVIDIA GPU

Prints the window's wall time, the device busy share (union of kernel and
copy intervals over the window), kernels launched per extend step, the
kernels that take the most device time, and the distance kernels' launches
and mean device time per launch. The trace itself is written under
``build/profile/`` (not kept in the repository).
"""
import json
import re
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import N, NUM_QUERIES, quickstart_stream
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core import VectorPool, VectorRequest
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.graph import make_cagra_graph

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: CUDA is not available")
    cfg = VectorPoolConfig(num_vectors=N, dim=128)
    db, queries = make_dataset(N, 128, seed=0, num_queries=NUM_QUERIES)
    graph = make_cagra_graph(db, cfg.graph_degree, exact_threshold=N,
                             device="cuda")
    stream = quickstart_stream(NUM_QUERIES)
    pool = VectorPool(cfg, db, graph, device="cuda", seed=0)
    for rid, kind, t, ddl in stream:
        pool.submit(VectorRequest(rid, kind, queries[rid], t, ddl))
    t_mid = stream[NUM_QUERIES // 3][2]
    pool.run_until(t_mid)  # warm: kernels built, allocator primed
    steps0 = pool.metrics.extend_steps
    torch.cuda.synchronize()
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pool.run_until(t_mid + 3e-3)  # ~3 ms of simulated time
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = pool.metrics.extend_steps - steps0
    trace = out_dir / "pool_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = Counter()
    for e in kernels:
        by_name[e["name"][:60]] += e["dur"]
    top = "; ".join(f"{n} {us:.0f} us" for n, us in by_name.most_common(6))
    dist = [e["dur"] for e in kernels if "distance_" in e["name"]]
    dist_names = sorted({re.search(r"distance_\w+", e["name"]).group()
                         for e in kernels if "distance_" in e["name"]})
    print(f"profile: window {wall_us / 1e3:.1f} ms wall, {steps} extend "
          f"steps ({wall_us / max(steps, 1):.0f} us wall per step), device "
          f"busy {busy / 1e3:.2f} ms = {busy / wall_us:.4f} of the window, "
          f"{len(kernels)} kernels ({len(kernels) / max(steps, 1):.1f} per "
          f"step), {len(dev) - len(kernels)} copies/memsets | top device "
          f"time: {top} | distance kernels {dist_names}: {len(dist)} "
          f"launches, {sum(dist) / max(len(dist), 1):.3f} us each on the "
          "card", flush=True)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
