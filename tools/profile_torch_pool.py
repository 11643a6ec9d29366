#!/usr/bin/env python3
"""Where the port's pool spends a chunk on the card: a ``torch.profiler``
trace over a steady window of the sift1m-shape cell (the corpus, graph,
engine and stream of ``chip_smoke.py`` phase 3), or with ``--sharded`` of
the sharded-sift1m-shape cell (``chip_smoke.py`` phase 10: 4 shards x 2
replicas, 8 lanes of one grouped engine, inserts interleaved), or with
``--cluster`` of the rag-cluster-sift1m-shape cell (``chip_smoke.py`` phase
11: ``ClusterSim`` over that pool with rebalancing, the cache backup and the
sanitizer on, the drifting-mix trace and phase 11's faults).

    python3 tools/profile_torch_pool.py [--sharded | --cluster]  # one GPU

Prints the window's wall time, the device busy share (union of kernel and
copy intervals over the window), kernels launched per extend step, the
kernels that take the most device time, and the distance kernels' launches
and mean device time per launch. With ``--sharded`` it also reports the
double buffer: the host time spent releasing arrivals while a grouped
chunk is in flight, the share of it during which the card was busy, and
the synchronising CUDA calls inside it (none, if the overlap is real).
With ``--cluster`` the window is 50 ms of simulated time in the trace's
RAG-heavy middle: it reports the wall per poll of the pool (the cluster
polls it every 200 simulated microseconds), the share of the wall spent
inside the pool's ``run_until`` against the simulator's own Python, the
kernels per grouped extend and the card's busy share. The trace itself is
written under ``build/profile/`` (not kept in the repository).
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


def overlap_us(spans, intervals):
    """Length of the parts of ``spans`` covered by the union of
    ``intervals``."""
    merged, end = [], float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = end = b
    total = 0.0
    for a, b in spans:
        for c, d in merged:
            total += max(0.0, min(b, d) - max(a, c))
    return total


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaStreamWaitEvent")


def sharded_pool(db, queries, stream):
    """chip_smoke.py phase 10's pool and traffic (inserts interleaved),
    submitted and not yet run."""
    from chip_smoke import (N, N_INSERT, N_LOOKUP, SHARDED, SHARDS, D_IM,
                            sharded_stream)
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core import ShardedVectorPool, VectorRequest
    from repro_torch.vector.dataset import make_dataset

    cfg = VectorPoolConfig(num_vectors=N, dim=D_IM, **SHARDED)
    pool = ShardedVectorPool(cfg, db, device="cuda", seed=0,
                             exact_threshold=-(-N // SHARDS))
    inserts, fresh = make_dataset(N_INSERT, D_IM, seed=7,
                                  num_queries=N_LOOKUP // 2)
    events, _ = sharded_stream(stream, queries, inserts, fresh, N_INSERT,
                               N_LOOKUP)
    for t, what, x in events:
        if what == "probe":
            rid, kind, q, ddl = x
            pool.submit(VectorRequest(rid, kind, q, t, ddl))
        else:
            pool.submit_insert(inserts[x], meta={"insert": x}, t_now=t)
    return pool


def cluster_sim(db):
    """chip_smoke.py phase 11's cluster (shards and exact graphs built on
    the card), its trace offered and its faults armed, not yet run.
    Returns (sim, the trace's length in simulated seconds)."""
    from chip_smoke import (CLUSTER_POOL, CLUSTER_RPS, CLUSTER_SEED,
                            CLUSTER_T_TRACE, D_IM, N, SHARDS, cluster_faults)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.serving import chaos
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.traffic import drifting_mix_trace

    cfg = VectorPoolConfig(num_vectors=N, dim=D_IM, **CLUSTER_POOL)
    sim = ClusterSim(get_config("phi3-medium-14b"), cfg, db, None,
                     placement="disaggregated", policy="trinity",
                     n_prefill=2, n_decode=2, decode_batch=8,
                     vector_replicas=2, device="cuda", seed=0,
                     exact_threshold=-(-N // SHARDS))
    chaos.ChaosInjector(cluster_faults(chaos, CLUSTER_T_TRACE),
                        seed=CLUSTER_SEED).arm(sim)
    for r in drifting_mix_trace(CLUSTER_T_TRACE, CLUSTER_RPS,
                                seed=CLUSTER_SEED).generate(CLUSTER_T_TRACE):
        sim.arrive(r)
    return sim, CLUSTER_T_TRACE


def advance(sim, until):
    """``ClusterSim.run(until)`` without arming another poll chain: every
    ``run`` call schedules a poll of its own, so a second call would poll
    the pool twice as often as phase 11's single ``run`` does."""
    import heapq

    while sim._events and sim._events[0][0] <= until:
        t, _, fn = heapq.heappop(sim._events)
        sim.t_now = t
        fn()
    sim.t_now = until


def profile_cluster(db):
    """The --cluster mode: see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sim, T = cluster_sim(db)
    pool = sim.vector_pool
    state = {"extends": 0, "polls": 0, "pool_s": 0.0}
    launch, run_until = pool._group.step_lanes_async, pool.run_until

    def launch_counted(lanes, k):
        state["extends"] += k
        return launch(lanes, k)

    def run_until_timed(t):
        state["polls"] += 1
        t0 = time.perf_counter()
        out = run_until(t)
        state["pool_s"] += time.perf_counter() - t0
        return out

    pool._group.step_lanes_async = launch_counted
    pool.run_until = run_until_timed
    san = pool.sanitizer  # its checks after each run_until, timed apart
    for name in ("_scan_completions", "_check_gids", "_check_cache_meta"):
        state[name] = 0.0

        def timed(inner=getattr(san, name), name=name):
            t0 = time.perf_counter()
            inner()
            state[name] += time.perf_counter() - t0

        setattr(san, name, timed)
    t_w = 0.5 * T  # the RAG-decode-heavy middle of the drifting mix
    sim.run(t_w)  # warm: kernels built, allocator primed
    torch.cuda.synchronize()
    e0, p0, s0 = state["extends"], state["polls"], state["pool_s"]
    c0 = {k: v for k, v in state.items() if k.startswith("_")}
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance(sim, t_w + 0.05)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ext = state["extends"] - e0
    polls = state["polls"] - p0
    pool_us = (state["pool_s"] - s0) * 1e6
    checks = {k.strip("_"): (state[k] - c0[k]) * 1e3 for k in c0}
    trace = out_dir / "cluster_trace.json"
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
    print(f"profile rag-cluster-sift1m-shape: window of 50 ms simulated from"
          f" t={t_w:.3f} s, {wall_us / 1e3:.1f} ms wall, {polls} pool polls "
          f"({wall_us / max(polls, 1):.0f} us wall a poll), inside the pool's "
          f"run_until (the sanitizer's checks included) {pool_us / 1e3:.1f} "
          f"ms = {pool_us / wall_us:.4f} of the wall, the simulator's own "
          f"Python outside it {(wall_us - pool_us) / 1e3:.1f} ms, {ext} "
          f"grouped extends, "
          f"{len(kernels)} kernels ({len(kernels) / max(ext, 1):.1f} a "
          f"grouped extend), {len(dev) - len(kernels)} copies/memsets, device"
          f" busy {busy / 1e3:.2f} ms = {busy / wall_us:.4f} of the window | "
          f"top device time: {top} | distance kernels: {len(dist)} launches,"
          f" {sum(dist) / max(len(dist), 1):.3f} us each on the card | the "
          f"sanitizer's checks (ms in the window): " + ", ".join(
              f"{k} {v:.1f}" for k, v in checks.items()), flush=True)
    print(torch.cuda.get_device_name(0))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import N, NUM_QUERIES, quickstart_stream
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core import VectorPool, VectorRequest
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.graph import make_cagra_graph

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: CUDA is not available")
    sharded = "--sharded" in sys.argv[1:]
    cfg = VectorPoolConfig(num_vectors=N, dim=128)
    db, queries = make_dataset(N, 128, seed=0, num_queries=NUM_QUERIES)
    if "--cluster" in sys.argv[1:]:
        return profile_cluster(db)
    stream = quickstart_stream(NUM_QUERIES)
    if sharded:
        pool = sharded_pool(db, queries, stream)
        release, group = pool._release_pending, pool._group
        launch = group.step_lanes_async
        state = {"in_flight": False, "extends": 0}

        def launch_marked(lanes, k):
            state["in_flight"] = True
            state["extends"] += k  # grouped extends: one launch each
            return launch(lanes, k)

        def release_marked(t):
            # only the release the double buffer runs with a chunk in flight
            if not state["in_flight"]:
                return release(t)
            state["in_flight"] = False
            with record_function("host: release arrivals (chunk in flight)"):
                return release(t)

        pool._release_pending = release_marked
        group.step_lanes_async = launch_marked
    else:
        graph = make_cagra_graph(db, cfg.graph_degree, exact_threshold=N,
                                 device="cuda")
        pool = VectorPool(cfg, db, graph, device="cuda", seed=0)
        for rid, kind, t, ddl in stream:
            pool.submit(VectorRequest(rid, kind, queries[rid], t, ddl))
    t_mid = stream[NUM_QUERIES // 3][2]
    pool.run_until(t_mid)  # warm: kernels built, allocator primed
    steps0 = pool.metrics.extend_steps
    g0 = state["extends"] if sharded else 0
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
    if sharded:  # a grouped extend steps every lane: count it once
        steps = state["extends"] - g0
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
    mode = "sharded-sift1m-shape (grouped chunks over 8 lanes)" if sharded \
        else "sift1m-shape"
    print(f"profile {mode}: window {wall_us / 1e3:.1f} ms wall, {steps} extend "
          f"steps ({wall_us / max(steps, 1):.0f} us wall per step), device "
          f"busy {busy / 1e3:.2f} ms = {busy / wall_us:.4f} of the window, "
          f"{len(kernels)} kernels ({len(kernels) / max(steps, 1):.1f} per "
          f"step), {len(dev) - len(kernels)} copies/memsets | top device "
          f"time: {top} | distance kernels {dist_names}: {len(dist)} "
          f"launches, {sum(dist) / max(len(dist), 1):.3f} us each on the "
          "card", flush=True)
    if sharded:
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name", "").startswith(
                     "host: release arrivals")]
        syncs = [e for e in events if e.get("ph") == "X"
                 and e.get("name") in SYNCS
                 and any(a <= e["ts"] < b for a, b in spans)]
        host = sum(b - a for a, b in spans)
        covered = overlap_us(spans, [(e["ts"], e["ts"] + e["dur"])
                                     for e in dev])
        print(f"double buffer: {len(spans)} arrival releases with a grouped "
              f"chunk in flight, {host:.0f} us of host time, the card busy "
              f"{covered:.0f} us of it ({covered / max(host, 1e-9):.4f}), "
              f"{len(syncs)} synchronising CUDA calls inside them "
              f"({sorted({e['name'] for e in syncs})})", flush=True)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
