#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — ``VectorPool`` → ``LaneScheduler`` →
``ContinuousBatchingEngine`` → the hand-written distance kernels — through
its public entry points at the shape of the public SIFT1M /
ann-benchmarks ``sift-128-euclidean`` set (10^6 base vectors × 128 dims,
L2; the vectors are synthetic, made from a seed), and holds every kernel
against its plain-PyTorch version on the card.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (one line each; any failure exits non-zero, and the final ``ok``
line is printed only when every phase passed):

  1 environment: the card and its power limit, the kernels' build time
  2 each kernel vs its plain version at the engine shape (T=2048 tasks,
    R=64 slots, d=128, N=10^6; ~25% dummies), both metrics, then a padded
    T; per-launch device time (CUDA events, median of 240 launches over
    128 task sets, so gathered rows are not served from the 50 MB L2),
    the plain version's time and the bound
  3 the pool at full size: the quickstart's stream over 1024 queries,
    drained; recall@10 against exact kNN on the card; the same stream
    through the port on the CPU over the same index for comparison
  4 the same pool with distance_mode="matmul_onehot" on the first 256
    queries; recall within 0.01 of phase 3's on the same queries
  5 launch counts: each kernel launched on its path (counts set to 0
    just before the path is driven and read just after)

The pool's clock is simulated and priced by the JAX package's V5E model;
no latency from that clock is printed. Every time printed here is a host
wall clock or a CUDA-event time measured on the card in this run.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, D_IM, NUM_QUERIES = 1_000_000, 128, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
KERNELS = {
    "distance_slot_gather": ("slot_gather", "src/repro/kernels/distance.py:102"),
    "distance_onehot": ("matmul_onehot", "src/repro/kernels/distance.py:42"),
}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def quickstart_stream(n, seed=0):
    """examples/quickstart.py's traffic: Poisson arrivals (mean gap 100 us
    of simulated time), 30% prefill (5 ms deadline), the rest decode
    (50 ms). Returns [(rid, kind, t_arrival, deadline)]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1e-4))
        kind = "prefill" if rng.random() < 0.3 else "decode"
        out.append((i, kind, t, t + (0.005 if kind == "prefill" else 0.05)))
    return out


def device_ms(fn, arg_sets, n=240):
    """Device time per call (ms): (median of a CUDA event pair around each
    call, first start to last end over ``n``). The stream is held by a
    sleep kernel while the host enqueues, so the events time the device
    work back to back, not the host's launch gaps."""
    import torch

    for args in arg_sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    # ~1 s of GPU clock: longer than the host takes to enqueue n calls of
    # the slowest function timed here (~0.1 s for 240 plain one-hot calls)
    torch.cuda._sleep(2_000_000_000)
    for i, (a, b) in enumerate(ev):
        a.record()
        fn(*arg_sets[i % len(arg_sets)])
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in ev)
    return times[n // 2], ev[0][0].elapsed_time(ev[-1][1]) / n


def host_ms(fn, arg_sets, n=240):
    """Wall time per call, host issue included (calls back to back)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_kernels(db_t, queries):
    """Phase 2: both kernels vs their plain versions at the engine shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import distance, ref

    dev = db_t.device
    R, T = 64, 2048
    rng = np.random.default_rng(2)
    q_t = torch.as_tensor(queries[:R], device=dev)
    slot_np = np.repeat(np.arange(R, dtype=np.int32), T // R)  # engine layout
    slot = torch.as_tensor(slot_np, device=dev)
    sets = []
    for _ in range(128):
        ids = rng.integers(0, N, size=T).astype(np.int32)
        ids[rng.random(T) < 0.25] = -1
        sets.append((db_t, q_t, torch.as_tensor(ids, device=dev), slot))
    plain = {"distance_slot_gather": ref.distance_tasks_ref,
             "distance_onehot": ref.distance_tasks_onehot_ref}
    kern = {"distance_slot_gather": distance.distance_slot_gather,
            "distance_onehot": distance.distance_onehot}
    dummy = torch.tensor(1e30, dtype=torch.float32, device=dev)
    results, outs = {}, {}
    for name in KERNELS:
        max_err = 0.0
        for metric in ("l2", "ip"):
            for args in sets[:8]:
                ids = args[2]
                valid = ids >= 0
                out = kern[name](*args, metric=metric)
                want = plain[name](*args, metric=metric)
                again = kern[name](*args, metric=metric)
                torch.cuda.synchronize()
                err = (out - want)[valid].abs()
                check(bool((err <= 1e-3 + 1e-5 * want[valid].abs()).all()),
                      f"{name} {metric}: max |kernel - plain| "
                      f"{err.max().item()}")
                check(bool((out[~valid] == dummy).all()),
                      f"{name} {metric}: dummies are not exactly 1e30")
                check(torch.equal(out, again),
                      f"{name} {metric}: two runs differ")
                max_err = max(max_err, err.max().item())
                outs[name, metric, id(args)] = out
            # padded T: appended dummies change nothing before them
            args = sets[0]
            pad_ids = torch.cat([args[2], args[2].new_full((256,), -1)])
            pad_slot = torch.cat([slot, slot.new_zeros((256,))])
            padded = kern[name](db_t, q_t, pad_ids, pad_slot, metric=metric)
            torch.cuda.synchronize()
            check(torch.equal(padded[:T], outs[name, metric, id(args)])
                  and bool((padded[T:] == dummy).all()),
                  f"{name} {metric}: padded T changes the results")
        results[name] = {"max_abs_err": max_err}
    for metric in ("l2", "ip"):  # B1 vs B2 (tests/test_kernels.py's bound)
        for args in sets[:8]:
            a = outs["distance_slot_gather", metric, id(args)]
            b = outs["distance_onehot", metric, id(args)]
            valid = args[2] >= 0
            check(torch.allclose(a[valid], b[valid], rtol=1e-4, atol=1e-4),
                  f"slot_gather vs onehot ({metric}) differ by "
                  f"{(a - b)[valid].abs().max().item()}")

    # the bound: bytes the function must move for these inputs (the rows
    # its valid tasks reference, once; the query rows they use; ids,
    # slots and output) over HBM rate, vs its flops over fp32 peak
    nbytes, nflops = [], []
    for _, _, ids, _ in sets:
        v = ids >= 0
        rows = torch.unique(ids[v]).numel()
        qrows = torch.unique(slot[v]).numel()
        nbytes.append((rows + qrows) * D_IM * 4 + 3 * T * 4)
        nflops.append(int(v.sum()) * D_IM)
    nbytes, nflops = float(np.mean(nbytes)), float(np.mean(nflops))
    flop_per_elem = {"distance_slot_gather": 3, "distance_onehot": 6}  # l2
    for name in KERNELS:
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flop_per_elem[name] * nflops / FP32_FLOPS * 1e3
        fn_k = lambda *a, f=kern[name]: f(*a, metric="l2")  # noqa: E731
        fn_p = lambda *a, f=plain[name]: f(*a, metric="l2")  # noqa: E731
        (k_ms, k_b2b), (p_ms, p_b2b) = (device_ms(fn_k, sets),
                                        device_ms(fn_p, sets))
        results[name].update(
            ms=k_ms, b2b_ms=k_b2b, plain_ms=p_ms, plain_b2b_ms=p_b2b,
            ms_again=device_ms(fn_k, sets)[0],
            wall_ms=host_ms(fn_k, sets), plain_wall_ms=host_ms(fn_p, sets),
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            bytes=nbytes)
    return results


def drive_pool(cfg, db, graph, queries, stream, device):
    """Submit ``stream`` to a fresh pool on ``device`` and drain it.
    Returns (pool, wall seconds, per-chunk wall seconds)."""
    import torch

    from repro_torch.core import VectorPool, VectorRequest

    pool = VectorPool(cfg, db, graph, device=device, seed=0)
    eng = pool.replicas[0].engine
    chunk_s, step = [], eng.step_multi

    def timed_step(*a, **kw):
        t0 = time.perf_counter()
        out = step(*a, **kw)  # ends in the chunk's one host sync
        chunk_s.append(time.perf_counter() - t0)
        return out

    eng.step_multi = timed_step
    for rid, kind, t, ddl in stream:
        pool.submit(VectorRequest(rid, kind, queries[rid], t, ddl))
    t0 = time.perf_counter()
    pool.run_until(stream[-1][2] + 1.0)
    if device == "cuda":
        torch.cuda.synchronize()
    return pool, time.perf_counter() - t0, chunk_s


def results_of(pool, n):
    import numpy as np

    done = pool.metrics.completed
    rids = sorted(r.rid for r in done)
    check(rids == list(range(n)),
          f"{len(done)} completions for {n} requests (each exactly once)")
    by = {r.rid: r for r in done}
    ids = np.stack([by[i].result_ids for i in range(n)])
    dists = np.stack([by[i].result_dists for i in range(n)])
    check(ids.shape == (n, 10) and (ids >= 0).all() and (ids < N).all(),
          "results are not 10 valid ids per request")
    check(np.isfinite(dists).all() and (np.diff(dists, axis=1) >= 0).all(),
          "result distances are not finite and ascending")
    return ids, np.asarray([by[i].extends_used for i in range(n)])


def main():
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import _build, distance
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.graph import make_cagra_graph
    from repro_torch.vector.ref import exact_knn, recall_at_k

    # ---- phase 1: environment + build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 references
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load("distance")  # csrc/distance.cu: both kernels
    build_s = time.perf_counter() - t0
    print(f"phase 1 environment: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"kernels built in {build_s:.2f} s (distance)", flush=True)

    t0 = time.perf_counter()
    db, queries = make_dataset(N, D_IM, seed=0, num_queries=NUM_QUERIES)
    data_s = time.perf_counter() - t0

    # ---- phase 2: kernels vs plain versions at the engine shape ----------
    db_t = torch.as_tensor(db, device="cuda")
    kres = phase_kernels(db_t, queries)
    del db_t
    print("phase 2 kernels: " + "; ".join(
        f"{n} max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.5f} "
        f"(again {r['ms_again']:.5f}, back to back {r['b2b_ms']:.5f}) "
        f"plain_ms={r['plain_ms']:.5f} (back to back "
        f"{r['plain_b2b_ms']:.5f}) "
        f"wall_ms={r['wall_ms']:.5f} plain_wall_ms={r['plain_wall_ms']:.5f} "
        f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, "
        f"{r['bytes']:.0f} B)" for n, r in kres.items())
        + " | library_ms none: no single PyTorch call gathers rows by id "
        "and reduces each against its own slot's query", flush=True)

    # ---- phase 3: the pool at full size ------------------------------------
    cfg = VectorPoolConfig(num_vectors=N, dim=D_IM)
    t0 = time.perf_counter()
    graph = make_cagra_graph(db, cfg.graph_degree, exact_threshold=N,
                             device="cuda")
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    true_ids, _ = exact_knn(db, queries, cfg.top_k, device="cuda")
    gt_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    stream = quickstart_stream(NUM_QUERIES)

    torch.cuda.reset_peak_memory_stats()
    distance.reset_launches()
    pool, wall_s, chunk_s = drive_pool(cfg, db, graph, queries, stream,
                                       "cuda")
    main_launches = dict(distance.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ids_gpu, ext_gpu = results_of(pool, NUM_QUERIES)
    recall = recall_at_k(ids_gpu, true_ids)
    m = pool.metrics
    check(recall >= 0.3, f"recall@10 {recall:.4f} under the 0.3 floor")

    pool_cpu, wall_cpu, _ = drive_pool(cfg, db, graph, queries, stream, "cpu")
    ids_cpu, ext_cpu = results_of(pool_cpu, NUM_QUERIES)
    recall_cpu = recall_at_k(ids_cpu, true_ids)
    same = float((ids_gpu == ids_cpu).all(axis=1).mean())
    check(same >= 0.99, f"only {same:.4f} of top-10 lists equal the CPU run")
    check(abs(recall - recall_cpu) <= 0.005,
          f"recall@10 {recall:.4f} (card) vs {recall_cpu:.4f} (CPU)")
    p50, p95 = np.percentile(np.asarray(chunk_s) * 1e3, [50, 95])
    print(f"phase 3 pool: N={N} d={D_IM} dataset {data_s:.1f} s, graph "
          f"(exact kNN on the card) {graph_s:.1f} s, ground truth {gt_s:.2f} s"
          f" | {len(m.completed)}/{NUM_QUERIES} completed, recall@10="
          f"{recall:.4f}, {len(chunk_s)} chunks of {cfg.extend_chunk} extends"
          f", step_multi wall p50={p50:.3f} ms p95={p95:.3f} ms, "
          f"{NUM_QUERIES / wall_s:.1f} completed requests per wall-second "
          f"({wall_s:.2f} s), peak allocated {peak_mb:.0f} MiB, occupancy "
          f"{m.occupancy:.4f}, preemptions {m.preemptions}, launches "
          f"{main_launches} | CPU run: recall@10={recall_cpu:.4f}, "
          f"top-10 lists equal {same:.4f}, extends equal "
          f"{float((ext_gpu == ext_cpu).mean()):.4f}, {wall_cpu:.1f} s",
          flush=True)

    # ---- phase 4: the one-hot form on the first 256 queries ---------------
    n4 = 256
    cfg4 = dataclasses.replace(cfg, distance_mode="matmul_onehot")
    distance.reset_launches()
    pool4, wall4, _ = drive_pool(cfg4, db, graph, queries, stream[:n4],
                                 "cuda")
    onehot_launches = dict(distance.launches)
    ids4, _ = results_of(pool4, n4)
    recall4 = recall_at_k(ids4, true_ids[:n4])
    recall3 = recall_at_k(ids_gpu[:n4], true_ids[:n4])
    check(abs(recall4 - recall3) <= 0.01,
          f"matmul_onehot recall@10 {recall4:.4f} vs {recall3:.4f}")
    print(f"phase 4 matmul_onehot: {n4} requests, recall@10={recall4:.4f} "
          f"(slot_gather on the same queries {recall3:.4f}), top-10 lists "
          f"equal {float((ids4 == ids_gpu[:n4]).all(axis=1).mean()):.4f}, "
          f"{wall4:.2f} s, launches {onehot_launches}", flush=True)

    # ---- phase 5: the paths went through the kernels -----------------------
    launches = {"distance_slot_gather":
                main_launches["distance_slot_gather"],
                "distance_onehot": onehot_launches["distance_onehot"]}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on its path")
    check(main_launches["distance_onehot"] == 0
          and onehot_launches["distance_slot_gather"] == 0,
          "a path launched the other mode's kernel")
    print(f"phase 5 kernels: launches {launches} (extend steps "
          f"{m.extend_steps} slot_gather, {pool4.metrics.extend_steps} "
          f"onehot)", flush=True)

    line = [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/distance.cu",
             "replaces": KERNELS[name][1], "launches": launches[name],
             "max_abs_err": kres[name]["max_abs_err"],
             "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
             "bound_ms": kres[name]["bound_ms"],
             "bound_by": kres[name]["bound_by"], "library_ms": None}
            for name in KERNELS]
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
