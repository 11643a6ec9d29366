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
    (phase 3's dataset, exact graph and ground truth are made meanwhile)
  2 each kernel vs its plain version at the engine shape (T=2048 tasks,
    R=64 slots, d=128, N=10^6; ~25% dummies), both metrics, then a padded
    T; per-launch device time (CUDA events, median of 240 launches over
    128 task sets, so gathered rows are not served from the 50 MB L2, and
    back to back: one event pair around the 240, over the count), the plain
    version's time and the bound; the same at the serving pool's shape
    (N=2000, d=64, R=16, T=512); then the lane sweep, G in {1, 4, 8, 16,
    32} lanes in one launch (8: phase 10's; each lane 250,000 rows of the
    corpus, its own ids), with lane g of each launch held bit-equal to a
    G=1 launch on lane g; and the launch floor, a one-element add timed
    both ways; then the hold check: B1 at the engine shape, B3 at phi3's
    prefill and B4 cold at phi3's decode timed under the fixed hold this
    script used before and under the sized hold, medians within 5%
  3 the pool at full size: the quickstart's stream over 1024 queries,
    drained; recall@10 against exact kNN on the card; the stream's first
    512 requests through the port on the CPU over the same index for
    comparison
  4 the same pool with distance_mode="matmul_onehot" on the first 256
    queries; recall within 0.01 of phase 3's on the same queries
  5 launch counts: each kernel launched on its path (counts set to 0
    just before the path is driven and read just after)
  6 the attention kernels vs their plain versions on the card: prefill
    (B=4, S in {512, 2048}, 40 heads over 10 kv heads, hd=128, bf16 and
    f32, causal; a ragged S=1000; internvl2's 14-over-2 heads at hd=64,
    bf16 and f32; gemma-7b's 16-over-16 heads at hd=256, S in {512, 2048},
    and once through views of a fused projection whose row stride TMA
    cannot take; 16-over-16 heads at hd=32, S=2048, contiguous and through
    such a view; deepseek-moe-16b's 16-over-16 heads at hd=128, S=512,
    bf16; seamless-m4t's 16-over-16 heads at hd=64, causal, non-causal and
    non-causal over Sk=300; jamba's 64-over-8 heads at hd=128), each with
    the B3 variant it ran (flash_wgmma, flash_wgmma256, flash_mma or
    flash_fp32), and decode (B=4, S_max=544, cur_len in {0, 271, 543},
    garbage and NaN past cur_len; gemma-7b's 16/16 heads at hd=256,
    deepseek-moe-16b's 16/16 at hd=128, seamless-m4t's 16/16 at hd=64 and
    jamba's 64/8 at hd=128, cur_len 543);
    per-launch device time, the plain version's time, the time of torch's
    scaled_dot_product_attention on the same inputs (a yardstick only: the
    port never calls it) and the bound (bytes, operations or exps, each
    over the card's rate; f32 operations at the 3xTF32 rate, with the
    fp32-core bound beside it); decode timed with a cold L2 (10
    rotating input sets, 111 MB) and a warm one (one set), each call
    replayed from a CUDA graph of it (SDPA's and the plain version's
    several kernels then run without the host's gaps between them)
  7 the serving path at full width: RealServer on phi3-medium-14b (its 40
    layers cut to 20, d_model 5120, bf16, random weights from seed 0) with
    serve.py's pool, 4 requests of 512 prompt tokens, 32 new tokens, a RAG
    probe every 8 tokens; launches of every kernel on that path (all 20
    prefill launches on flash_wgmma)
  8 the same entry point on the card and on the CPU: phi3's widths cut to
    2 layers, float32, one set of weights; equal tokens, close logits; the
    card's prefill on flash_fp32
  9 the serving path at gemma-7b's full width: RealServer on gemma-7b (28
    layers cut to 14, d_model 3072, 16 heads over 16 kv heads at hd 256,
    GeGLU, bf16, random weights from seed 0), the same pool and traffic as
    phase 7; every logit finite, all 14 prefill launches on
    flash_wgmma256, B4 launched 14 x (512 + 32) times
 10 the sharded, megabatched pool at full size (sharded-sift1m-shape): the
    same corpus in 4 balanced-k-means shards (exact graphs built on the
    card) x 2 replicas = 8 lanes of one GroupEngine, the answer cache on;
    the quickstart stream's first 512 requests with 128 inserts of fresh
    vectors interleaved, then 128 cache lookups (half repeat an insert);
    every request completed
    once, recall@10 >= 0.3, inserts broadcast to their owning shard's two
    replicas only, at least half the repeats hit, every grouped extend's
    distance stage one 8-lane launch of B1; the first 128 probes, 32
    inserts and 32 repeat lookups again on the card and on the CPU over
    clones of the shards (>= 99% equal lists, recall within 0.005, equal
    hits); the first 64 probes with matmul_onehot (B2's lane form, recall
    within 0.01)
 11 the Trinity cluster (rag-cluster-sift1m-shape): ClusterSim with
    phi3-medium-14b at its published widths priced on V5E, disaggregated,
    2 prefill + 2 decode instances, over phase 10's pool (a clone of its
    shards) with rebalancing, the cache backup and the sanitizer on; the
    drifting-mix trace (bulk prefill, RAG decode with a probe every token,
    repeat chat) and a fixed fault list (a replica killed, a straggler, a
    shard lost, a decode instance killed) armed on the sim; every request
    finished once, every vector request completed once (or cancelled with
    its instance), the sanitizer clean, every cache entry of the lost shard
    recovered, repeats hit the answer cache, every grouped extend one lane
    launch of B1; then the fixture cluster (make_sharded_pool_sim, 6,000 x
    64 in 4 shards) with the autoscaler and the same kinds of faults, on
    the card and on the CPU: equal summaries, signals, scale events and
    vector results
 12 the serving path on deepseek-moe-16b at its published widths (MoE: 28
    layers cut to 14, d_model 2048, 16/16 heads at hd 128, 64 routed
    experts of 1408 top-6 and 2 shared, bf16, 16.88e9 parameters whole,
    random weights from seed 0), phase 7's pool and traffic: every logit
    finite, all 14 prefill launches on flash_wgmma, B4 launched 14 x 544
    times, the (token,
    expert) pairs capacity drops at prefill, the kernels of a decode step
    (profiler), peak memory
 13 the same on deepseek-v3-671b at its published widths cut to depth 1
    (MLA, 256 routed experts top-8 and 1 shared, the MTP block made but
    not run, 25.0e9 parameters: two layers would not fit the card in
    bf16): every logit finite, no B3/B4 launch (MLA is torch ops); then
    MLA's prefill attention at its widths (the port's torch ops) timed
    beside SDPA on the same inputs
 14 the DeepSeek family on the card and on the CPU through RealServer:
    deepseek-moe-16b's widths cut to 2 layers, then deepseek-v3's smoke
    config, float32, one set of weights each (equal tokens, close logits);
    one deepseek-v3 MLA layer at its published widths, forward and 8
    decode steps
 15 CAGRA's per-request lockstep search (search_batch, A4) on phase 3's
    index and queries at the pool's top_m / parents_per_step: recall@10,
    extends and the iterations the batch held, beside phase 3's pool
 16 the serving path on xlstm-350m whole (24 layers in 3 groups of 7 mLSTM
    + 1 sLSTM, d_model 1024, bf16, random weights from seed 0), phase 7's
    pool and traffic: every logit finite, B1 on its probes and no B3/B4
    launch (the recurrences are torch ops), the weights equal to the
    analytic count, peak memory, kernels a decode step
 17 the same on seamless-m4t-large-v2 whole (12 encoder + 12 decoder
    layers, 16/16 heads at hd 64, vocab 256,206 padded to 258,048, bf16,
    the stub frames in bf16): 36 prefill launches of B3 on flash_wgmma
    (encoder, decoder, cross-attention), B4 12 x 544
 18 the same on jamba-1.5-large-398b at its published widths cut to one
    group of 8 layers (7 mamba + 1 attention, 64/8 heads at hd 128) and 8
    of its 16 experts (top-2 kept; 25,910,362,112 parameters): 1 B3 launch
    on flash_wgmma, B4 544, 4 MoE layers with the pairs capacity drops
 19 the three families on the card and on the CPU through RealServer:
    xlstm-350m's widths cut to 8 layers, seamless-m4t's to 1 + 1 layers,
    jamba's smoke config, float32 (equal tokens, close logits); one jamba
    mamba layer and one xLSTM mLSTM + sLSTM pair at published widths,
    forward and 8 decode steps
 20 training: the port's Trainer on xlstm-350m whole (launch/train.py's
    default arch and flags: 24 layers, d_model 1024, bf16, batch 8 x 128
    tokens of the synthetic pipeline, AdamW lr 1e-3, warm-up 20), 20 steps
    with a checkpoint every 10, then a fresh Trainer on the same directory,
    step 20's checkpoint removed, resumes at 10 and runs to 20, both runs
    with deterministic algorithms: the loss falls, the restored
    params and moments equal the saved ones bit for bit, the resumed losses
    within 1e-3 (relative) of the uninterrupted run's; s/step, kernels a
    step (profiler), peak memory, the checkpoint's bytes and write time
 21 training examples/train_100m.py's --full-100m config (lm-100m: 12
    layers, d_model 768, 12/12 heads, f32) for 200 steps at the example's
    defaults: the loss falls by at least 1.0; s/step, kernels a step; then
    attend_blocked forward + backward at its shape (8, 128, 12, 64) f32
    beside scaled_dot_product_attention forward + backward (a yardstick)
 22 training on the card against the CPU on five float32 smoke configs
    (gemma-7b, deepseek-v3-671b, jamba-1.5-large-398b, xlstm-350m,
    seamless-m4t-large-v2), one set of weights and one batch: loss and
    metrics within 1e-4 (relative), every gradient leaf within 1e-3 of its
    leaf's max |g|, three Trainer steps' losses within 1e-4
    No kernel of B1-B4 launches in phases 20-22, by design: training
    attends through attend_blocked (torch ops under autograd), the kernels
    having no backward.
 23 the mesh code: make_host_mesh's (1, 1) NCCL mesh over a one-rank
    in-memory group; phi3-medium-14b at full width (d_model 5120, 40/10
    heads at hd 128, bf16) cut to 2 of 40 layers prefills 4 x 512 tokens,
    then decodes 32 tokens twice, with seq_axis="model" inside
    activation_sharding(mesh) and without: equal tokens, logits within
    1e-3, every sharded decode attention a B4 launch with its log-sum-exp
    (counted); B4's lse against its plain version at phi3's, gemma-7b's
    (hd 256) and jamba's (g 8) decode shapes, and over 2, 4 and 8 slices of
    phi3's cache (boundaries inside a tile, slices wholly past cur_len
    launching nothing) combined by the sharded decode's own arithmetic
    (sharding.merge_stacked), equal to one launch over the whole within
    1e-3, and timed beside one ATen call that also returns the
    log-sum-exp (FlashAttention-2's forward; a yardstick); one dry-run cell
    (phi3-medium-14b x decode_32k on the 16 x 16 production mesh, meta
    tensors over the fake backend) through the dry run's CLI, its counts
    printed

Every device time is taken behind holds: a sleep kernel keeps the stream
waiting while the host enqueues the timed calls. The launch queue takes
about 1,000 kernels and timing events, so the calls go in batches of at
most 64 calls and 3 ms of projected enqueue (the host's fastest call so
far), each behind a hold of twice that plus 2 ms (2 ms alone where the
device has not finished the batch two back), enqueued right behind the
batch before. An event recorded after each hold must still be pending when the
host has enqueued the batch: the device had not reached the calls, so it
never waited for the host. Where it is not, the batch is timed again
behind a hold twice as long, up to 1 s, and then the phase fails. Each
phase ends with a line ``phase N took X s, held Y s, Z guard
re-timings``.

The pool's and the cluster's clocks are simulated and priced by the JAX
package's V5E model; phase 11 prints its simulated TTFT and TPOT labelled
so, and no other latency from that clock is printed. Every time printed here is a host
wall clock or a CUDA-event time measured on the card in this run.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, D_IM, NUM_QUERIES = 1_000_000, 128, 1024
N_CPU = 512  # phase 3's requests run again on the CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOPS = 494.7e12  # H100 SXM data sheet, dense TF32 tensor cores
EXP_PER_CLOCK_SM = 16  # special-function unit: CUDA C Programming Guide, cc 9.0
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "distance_slot_gather": ("src/repro_torch/csrc/distance.cu",
                             "src/repro/kernels/distance.py:102"),
    "distance_onehot": ("src/repro_torch/csrc/distance.cu",
                        "src/repro/kernels/distance.py:42"),
    # B3: the total over its variants, then each variant
    "flash_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/flash_attention.py:21"),
    "flash_wgmma": ("src/repro_torch/csrc/attention.cu",
                    "src/repro/kernels/flash_attention.py:21"),
    "flash_wgmma256": ("src/repro_torch/csrc/attention.cu",
                       "src/repro/kernels/flash_attention.py:21"),
    "flash_mma": ("src/repro_torch/csrc/attention.cu",
                  "src/repro/kernels/flash_attention.py:21"),
    "flash_fp32": ("src/repro_torch/csrc/attention.cu",
                   "src/repro/kernels/flash_attention.py:21"),
    "decode_attention": ("src/repro_torch/csrc/attention.cu",
                         "src/repro/kernels/decode_attention.py:22"),
}
DISTANCE = ("distance_slot_gather", "distance_onehot")
# checkpoints of the training phases (build/ is git-ignored; removed after)
CKPT = ROOT / "build" / "chip_smoke_ckpt"
# the serving path's pool: launch/serve.py's main()
SERVE_POOL = dict(num_vectors=2000, dim=64, max_requests=16, top_m=16,
                  task_batch=512, visited_slots=256, top_k=5)


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


# The hold: while the host enqueues timed calls, a sleep kernel holds the
# stream, so the events time the device's work and not the host's launch
# gaps. The launch queue takes ~1,000 kernels and timing events; past that
# the host waits for the device, so no hold covers more. The calls go in
# batches of at most BATCH_CALLS calls and BATCH_S of projected enqueue (a
# few hundred entries), each behind its own hold of HOLD_MULT times that
# enqueue plus HOLD_MARGIN_S (HOLD_MARGIN_S alone where the device has not
# finished the batch two back), enqueued right behind the batch before it.
# The guard doubles a batch's hold up to HOLD_CAP_S (about the fixed
# 2e9-cycle hold this script used before) when the host outran it, then
# fails.
HOLD_MULT, HOLD_MARGIN_S, HOLD_CAP_S = 2.0, 0.002, 1.0
BATCH_CALLS, BATCH_S = 64, 0.003
# seconds held and the guard's re-timings, summed over the run
HELD = {"s": 0.0, "retimes": 0}


def mark():
    """A phase's start: the wall clock, the seconds held and the guard's
    re-timings so far."""
    return time.perf_counter(), HELD["s"], HELD["retimes"]


def took(label, since):
    """Print ``<label> took X s`` with the seconds held and the guard's
    re-timings since ``since`` (a ``mark``)."""
    t, held_s, retimes = since
    print(f"{label} took {time.perf_counter() - t:.1f} s, held "
          f"{HELD['s'] - held_s:.3f} s, {HELD['retimes'] - retimes} guard "
          "re-timings", flush=True)


@functools.lru_cache(maxsize=None)
def sm_clock_hz():
    """The card's maximum SM clock (Hz), read by nvidia-smi. A hold of s
    seconds sleeps s times this many cycles: at a lower clock it lasts
    longer, never shorter."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    return float(mhz) * 1e6


def hold_seconds(enqueue_s):
    """The hold that covers ``enqueue_s`` of projected host enqueue."""
    return min(HOLD_MULT * enqueue_s + HOLD_MARGIN_S, HOLD_CAP_S)


def hold_cycles(seconds, clock_hz):
    """A hold of ``seconds`` in cycles of ``clock_hz``, for ``_sleep``."""
    return math.ceil(seconds * clock_hz)


def batch_calls(call_s):
    """Calls in a batch, at ``call_s`` of projected enqueue a call."""
    return max(1, min(BATCH_CALLS, int(BATCH_S / max(call_s, 1e-9))))


def covered_run(hold_s, enqueue, sleep, event):
    """Hold the stream for ``hold_s`` (``sleep``), record ``event`` behind
    the hold, then ``enqueue`` the timed calls. True when the event was
    still pending once the host had enqueued the last call: the device
    had not reached the calls yet, so it never waited for the host
    between them."""
    sleep(hold_s)
    event.record()
    enqueue()
    return not event.query()


def guarded(run, hold_s, name):
    """``run(hold_s)`` (a ``covered_run``) until it is covered, doubling
    the hold each time it is not; a run the cap does not cover fails
    ``name``'s phase."""
    while True:
        covered = run(hold_s)
        HELD["s"] += hold_s
        if covered:
            return
        check(hold_s < HOLD_CAP_S,
              f"{name}: the host's enqueue outran a {hold_s:.3f} s hold")
        hold_s = min(2 * hold_s, HOLD_CAP_S)
        HELD["retimes"] += 1


def fn_name(fn):
    """A timed function's name, a lambda's with its line in this file."""
    code = getattr(fn, "__code__", None)
    where = f" (line {code.co_firstlineno})" if code else ""
    return getattr(fn, "__qualname__", repr(fn)) + where


def device_ms(fn, arg_sets, n=240, hold_s=None, name=None):
    """Device time per call (ms): (median of a CUDA event pair around each
    call, back to back: an event pair around each batch of calls, summed
    over the batches, over ``n``). Each batch waits behind a hold of
    ``hold_seconds`` of its projected enqueue, or of HOLD_MARGIN_S alone
    where the device has not finished the batch two back, checked by
    ``guarded``. The projection is the host's fastest enqueue of a call so
    far: a warm-up call inside its event pair (as the first loop makes
    it), then each batch's calls. ``hold_s`` instead puts all ``n`` calls
    of the first loop behind one hold of that length and skips the second
    (the hold check's old hold: the check compares medians)."""
    import torch

    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    enqueue = []
    for args in arg_sets[:4]:
        t0 = time.perf_counter()
        pair[0].record()
        fn(*args)
        pair[1].record()
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    call_s = min(enqueue)
    name = name or fn_name(fn)
    clock = sm_clock_hz()
    held = torch.cuda.Event()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    b2b = []

    def sleep(s):
        torch.cuda._sleep(hold_cycles(s, clock))

    def pairs(i0, i1):
        for i in range(i0, i1):
            ev[i][0].record()
            fn(*arg_sets[i % len(arg_sets)])
            ev[i][1].record()

    def back_to_back(i0, i1):
        b2b[-1][0].record()
        for i in range(i0, i1):
            fn(*arg_sets[i % len(arg_sets)])
        b2b[-1][1].record()

    for loop in (pairs,) if hold_s else (pairs, back_to_back):
        i0, ends = 0, []  # ends: the event closing each batch so far
        while i0 < n:
            i1 = n if hold_s else min(n, i0 + batch_calls(call_s))
            spent = []

            def enqueue_batch(i0=i0, i1=i1):
                t0 = time.perf_counter()
                loop(i0, i1)
                spent.append(time.perf_counter() - t0)

            # the device has not finished the batch two back (the host is
            # two batches ahead, as where the device is the slower): it
            # reaches this batch's calls only after all of the batch
            # before, so the hold is the margin alone
            behind = len(ends) > 1 and not ends[-2].query()
            if loop is back_to_back:
                b2b.append((torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)))
            guarded(lambda h: covered_run(h, enqueue_batch, sleep, held),
                    hold_s or (HOLD_MARGIN_S if behind else
                               hold_seconds((i1 - i0) * call_s)), name)
            ends.append(ev[i1 - 1][1] if loop is pairs else b2b[-1][1])
            call_s = min([call_s] + [t / (i1 - i0) for t in spent])
            i0 = i1
        torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in ev)
    if hold_s:
        return times[n // 2], None
    return times[n // 2], sum(a.elapsed_time(b) for a, b in b2b) / n


def graph_ms(fn, arg_sets, n, hold_s=None):
    """``device_ms`` of replaying one CUDA graph of ``fn`` per arg set: the
    device time of a call made of several kernels, without the host's gaps
    between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for args in arg_sets:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(*args)
        graphs.append((g,))
    return device_ms(lambda g: g.replay(), graphs, n, hold_s, fn_name(fn))


def host_ms(fn, arg_sets, n=240):
    """Wall time per call, host issue included (calls back to back)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def floor_ms():
    """The launch floor: a one-element in-place add on the card, timed as
    the kernels are (median event pair, back to back)."""
    import torch

    one = torch.zeros(1, device="cuda")
    return device_ms(lambda x: x.add_(1.0), [(one,)])


def lane_sets(dbs, q, T, n_sets, seed):
    """``n_sets`` task sets over the lanes of ``dbs`` (G, N, d): each lane
    its own random ids in [0, N) with 25% dummies, slots in the engine's
    layout (slot s owns T / R consecutive tasks)."""
    import torch

    G, N = dbs.shape[:2]
    R = q.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slot = torch.arange(R, dtype=torch.int32, device="cuda").repeat_interleave(
        T // R).expand(G, T).contiguous()
    sets = []
    for _ in range(n_sets):
        ids = torch.randint(0, N, (G, T), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids[torch.rand((G, T), generator=gen, device="cuda") < 0.25] = -1
        sets.append((dbs, q, ids, slot))
    return sets


def distance_bound(sets, flop_per_elem):
    """(bound ms, what binds, bytes): the bytes the function must move for
    these inputs (each lane's rows its valid tasks reference, once; the
    query rows they use; ids, slots and output) over the HBM rate, vs its
    flops over the fp32 peak; averaged over the sets."""
    import numpy as np
    import torch

    nbytes, nflops = [], []
    for db, q, ids, slot in sets:
        ids2 = ids.reshape(-1, ids.shape[-1])  # (G, T); (1, T) for (T,)
        slot2 = slot.reshape(ids2.shape)
        lane = torch.arange(ids2.shape[0], device=ids.device)[:, None]
        v = ids2 >= 0
        rows = torch.unique((lane * db.shape[-2] + ids2)[v]).numel()
        qrows = torch.unique((lane * q.shape[-2] + slot2)[v]).numel()
        d = db.shape[-1]
        nbytes.append((rows + qrows) * d * 4 + 3 * ids.numel() * 4)
        nflops.append(int(v.sum()) * d * flop_per_elem)
    nbytes, nflops = float(np.mean(nbytes)), float(np.mean(nflops))
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nflops / FP32_FLOPS * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations", nbytes)


def check_distance(name, kern, plain, sets, metric):
    """Kernel against its plain version on the first 8 sets: within atol
    1e-3 + rtol 1e-5 (float32 sums of d terms in another order), dummies
    exactly 1e30, two runs the same bits; then the first set padded with
    256 dummies a lane changes nothing before them; and, for lanes, lane g
    of the launch has the bits of a G = 1 launch on lane g. Returns the
    largest error."""
    import torch

    max_err, first = 0.0, None
    for args in sets[:8]:
        valid = args[2] >= 0
        out = kern(*args, metric=metric)
        want = plain(*args, metric=metric)
        again = kern(*args, metric=metric)
        torch.cuda.synchronize()
        err = (out - want)[valid].abs()
        check(bool((err <= 1e-3 + 1e-5 * want[valid].abs()).all()),
              f"{name} {metric}: max |kernel - plain| {err.max().item()}")
        check(bool((out[~valid] == 1e30).all()),
              f"{name} {metric}: dummies are not exactly 1e30")
        check(torch.equal(out, again), f"{name} {metric}: two runs differ")
        max_err = max(max_err, err.max().item())
        first = out if first is None else first
    db, q, ids, slot = sets[0]
    T = ids.shape[-1]
    pad_ids = torch.cat([ids, ids.new_full(ids.shape[:-1] + (256,), -1)], -1)
    pad_slot = torch.cat([slot, slot.new_zeros(slot.shape[:-1] + (256,))], -1)
    padded = kern(db, q, pad_ids, pad_slot, metric=metric)
    torch.cuda.synchronize()
    check(torch.equal(padded[..., :T], first)
          and bool((padded[..., T:] == 1e30).all()),
          f"{name} {metric}: padded T changes the results")
    if ids.dim() == 2:
        for g in range(ids.shape[0]):
            one = kern(db[g:g + 1], q[g:g + 1], ids[g:g + 1], slot[g:g + 1],
                       metric=metric)
            torch.cuda.synchronize()
            check(torch.equal(one[0], first[g]),
                  f"{name} {metric}: lane {g} of {ids.shape[0]} differs from "
                  "its own launch")
    return max_err


def time_distance(fn, sets):
    """``device_ms`` of l2 calls of ``fn`` over the sets."""
    return device_ms(lambda *a: fn(*a, metric="l2"), sets, name=fn_name(fn))


LANES = (1, 4, 8, 16, 32)  # phase 2's lane sweep (8: phase 10's launch)
SHARDS = 4  # phase 3's corpus cut into 4 shards of 250,000 rows
# the fixed holds (cycles) this script used before its holds were sized:
# time_distance's, device_ms's default and the decode replays'
OLD_HOLDS = {"B1": 500_000_000, "B3": 2_000_000_000, "B4": 1_000_000_000}


def engine_sets(db_t, queries, R=64, T=2048):
    """Phase 2's 128 task sets at the engine shape: R query slots, T tasks
    of random ids with 25% dummies, slots in the engine's layout."""
    import numpy as np
    import torch

    dev = db_t.device
    rng = np.random.default_rng(2)
    q_t = torch.as_tensor(queries[:R], device=dev)
    slot_np = np.repeat(np.arange(R, dtype=np.int32), T // R)  # engine layout
    slot = torch.as_tensor(slot_np, device=dev)
    sets = []
    for _ in range(128):
        ids = rng.integers(0, N, size=T).astype(np.int32)
        ids[rng.random(T) < 0.25] = -1
        sets.append((db_t, q_t, torch.as_tensor(ids, device=dev), slot))
    return sets


def hold_check(db_t, queries):
    """The sized hold against the fixed one it replaced, in turns on three
    cases: B1 at the engine shape (phase 2's sets), B3 at phi3's prefill
    (4, 512, 40/10, 128) bf16 (phase 6's first case) and B4 cold at phi3's
    decode (4, 544, 40/10, 128) bf16, cur_len 543 (graph replay over 10
    sets), each timed under its old hold (one hold around the event-pair
    loop, which the old holds covered: at most ~720 launch-queue entries),
    then under the sized one, the guard on both; the two event-pair
    medians within 5%. Returns [(case, old ms, sized ms)]."""
    import torch

    from repro_torch.kernels import decode_attention, distance, flash_attention

    def randn(shape, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    prefill = [prefill_inputs(4, 512, 40, 10, 128, torch.bfloat16, False, 0)]
    decode = [(randn((4, 40, 128), 3 * c), randn((4, 544, 10, 128), 3 * c + 1),
               randn((4, 544, 10, 128), 3 * c + 2)) for c in range(10)]
    cases = (
        ("B1 (2048, 64, 128) l2", "B1", device_ms, lambda *a: (
            distance.distance_slot_gather(*a, metric="l2")),
         engine_sets(db_t, queries), 240),
        ("B3 (4, 512, 40/10, 128) bf16", "B3", device_ms, lambda q, k, v: (
            flash_attention.flash_attention(q, k, v, causal=True)), prefill, 40),
        ("B4 (4, 544, 40/10, 128) bf16 cur_len 543 cold", "B4", graph_ms,
         lambda q, k, v: decode_attention.decode_attention(q, k, v, 543),
         decode, 200))
    out = []
    for label, key, timer, fn, arg_sets, n in cases:
        old = timer(fn, arg_sets, n, OLD_HOLDS[key] / sm_clock_hz())[0]
        new = timer(fn, arg_sets, n)[0]
        check(abs(new - old) <= 0.05 * old,
              f"hold check {label}: {new:.6f} ms under the sized hold vs "
              f"{old:.6f} ms under the old")
        out.append((label, old, new))
    del prefill, decode
    torch.cuda.empty_cache()
    return out


def phase_kernels(db_t, queries):
    """Phase 2: both kernels vs their plain versions. G = 1 at the engine
    shape (T=2048 tasks, R=64 slots, d=128, N=10^6; ~25% dummies, 128 task
    sets so gathered rows are not served from the 50 MB L2) and at the
    serving pool's (N=2000, d=64, R=16, T=512); then the lane sweep, G in
    {1, 4, 8, 16, 32} lanes in one launch at T=2048, R=64, d=128, the lanes
    the 4 shards of the corpus (250,000 rows each) repeated up to 8 times
    (4 shards x 8 replicas; G=32 holds 4.1 GB), each lane its own ids; G = 8
    is phase 10's launch (4 shards x 2 replicas)."""
    import torch

    from repro_torch.kernels import distance, ref

    dev = db_t.device
    R, T = 64, 2048
    sets = engine_sets(db_t, queries)
    plain = {"distance_slot_gather": ref.distance_tasks_ref,
             "distance_onehot": ref.distance_tasks_onehot_ref}
    kern = {"distance_slot_gather": distance.distance_slot_gather,
            "distance_onehot": distance.distance_onehot}
    plain_g = {"distance_slot_gather": ref.distance_tasks_group_ref,
               "distance_onehot": ref.distance_tasks_onehot_group_ref}
    kern_g = {"distance_slot_gather": distance.distance_slot_gather_group,
              "distance_onehot": distance.distance_onehot_group}
    flop_per_elem = {"distance_slot_gather": 3, "distance_onehot": 6}  # l2
    results = {name: {"max_abs_err": 0.0} for name in DISTANCE}

    def run(name, kernels, plains, case_sets):
        """One kernel on one case: held to the plain version at both metrics
        (``check_distance``), timed, with the case's bound."""
        for metric in ("l2", "ip"):
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"],
                check_distance(name, kernels[name], plains[name], case_sets,
                               metric))
        ms, b2b = time_distance(kernels[name], case_sets)
        bound, by, nbytes = distance_bound(case_sets, flop_per_elem[name])
        p_ms, p_b2b = time_distance(plains[name], case_sets)
        return dict(ms=ms, b2b_ms=b2b, plain_ms=p_ms, plain_b2b_ms=p_b2b,
                    bound_ms=bound, bound_by=by, bytes=nbytes)

    for metric in ("l2", "ip"):  # B1 vs B2 (tests/test_kernels.py's bound)
        for args in sets[:8]:
            a = kern["distance_slot_gather"](*args, metric=metric)
            b = kern["distance_onehot"](*args, metric=metric)
            valid = args[2] >= 0
            check(torch.allclose(a[valid], b[valid], rtol=1e-4, atol=1e-4),
                  f"slot_gather vs onehot ({metric}) differ by "
                  f"{(a - b)[valid].abs().max().item()}")
    fl_ms, fl_b2b = floor_ms()
    # the serving pool's shape (launch/serve.py's VectorPoolConfig), G = 1
    sp = SERVE_POOL
    gen = torch.Generator(device=dev).manual_seed(5)
    sdb = torch.randn((sp["num_vectors"], sp["dim"]), generator=gen, device=dev)
    sq = torch.randn((sp["max_requests"], sp["dim"]), generator=gen, device=dev)
    serve_sets = [(sdb, sq, ids[0], sl[0]) for _, _, ids, sl in lane_sets(
        sdb[None], sq[None], sp["task_batch"], 32, seed=6)]
    # the lane sweep: lanes of 250,000 rows, 4 shards x up to 8 replicas
    shards = db_t.view(SHARDS, N // SHARDS, D_IM)
    dbs = shards.repeat(max(LANES) // SHARDS, 1, 1)  # (32, 250000, 128)
    qs = torch.as_tensor(queries, device=dev).view(-1, R, D_IM)  # 16 sets of R
    qs = qs.repeat(max(1, max(LANES) // qs.shape[0]), 1, 1)[:max(LANES)]
    for name in DISTANCE:
        r = results[name]
        r.update(run(name, kern, plain, sets))
        r.update(ms_again=device_ms(lambda *a, f=kern[name]: f(*a, metric="l2"),
                                    sets)[0],
                 wall_ms=host_ms(lambda *a, f=kern[name]: f(*a, metric="l2"),
                                 sets),
                 plain_wall_ms=host_ms(
                     lambda *a, f=plain[name]: f(*a, metric="l2"), sets),
                 floor_ms=fl_ms, floor_b2b_ms=fl_b2b)
        r["serve_pool"] = run(name, kern, plain, serve_sets)
        r["lanes"] = []
        for G in LANES:
            case = lane_sets(dbs[:G], qs[:G], T, max(8, 128 // G), seed=10 + G)
            lane = run(name, kern_g, plain_g, case)
            r["lanes"].append(dict(G=G, **lane))
            del case
    del dbs
    torch.cuda.empty_cache()
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


def close(out, want, tol):
    """(max |out - want|, within atol = rtol = tol), both in float32."""
    err = (out.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return err.max().item(), ok


def exp_rate():
    """Exps a second the card's special-function units can do: 16 a clock
    an SM, times the SM count and the maximum SM clock, both read from the
    card."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_CLOCK_SM * sms * sm_clock_hz()


def prefill_inputs(B, S, H, Hkv, hd, dtype, view, seed, Sk=None):
    """q (B, S, H, hd) and k, v (B, Sk, Hkv, hd) (Sk = S unless given) on
    the card, from seeds seed .. seed + 2: contiguous, or (``view``) three
    views of one fused projection whose row stride, (H + 2 Hkv) hd + 4
    elements, is no multiple of 8, which TMA cannot take."""
    import torch

    def randn(shape, sd):
        g = torch.Generator(device="cuda").manual_seed(sd)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if not view:
        Sk = Sk or S
        return (randn((B, S, H, hd), seed), randn((B, Sk, Hkv, hd), seed + 1),
                randn((B, Sk, Hkv, hd), seed + 2))
    width = (H + 2 * Hkv) * hd
    heads = randn((B, S, width + 4), seed)[..., :width].unflatten(-1, (H + 2 * Hkv, hd))
    return heads[:, :, :H], heads[:, :, H:H + Hkv], heads[:, :, H + Hkv:]


def attention_bound(nbytes, flops, n_exp, rate_exp, dtype):
    """Least time (ms) and what bounds it: bytes over the HBM rate, flops
    over the peak for the type (bf16 tensor cores; float32 as 3xTF32, three
    TF32 products a product), or exps over ``rate_exp``."""
    import torch

    peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS / 3
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / peak * 1e3, "exp": n_exp / rate_exp * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def phase_attention():
    """Phase 6: both attention kernels vs their plain versions on the card.
    Tolerance (atol = rtol): f32 1e-4, the kernels sum up to 2048 terms in
    another order than the plain version; bf16 2e-2, tests/test_kernels.py's
    (the output rounds to bf16). Two runs must give the same bits. Each
    prefill case records the B3 variant it ran; decode is timed warm (one
    (q, k, v) set, its cache of 11 MB (phi3) or 36 MB (gemma-7b) held in
    the 50 MB L2 across calls) and cold (calls rotate over 10 sets, 111 MB
    or 357 MB, as the layers of a decode step find their caches). Float32
    cases also give the bound on the fp32 cores (``bound_fp32_cores_ms``),
    which 3xTF32 leaves behind."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, decode_attention, ref

    dev = torch.device("cuda")
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rate_exp = exp_rate()

    def randn(shape, seed, dtype):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    res = {"flash_attention": {"max_abs_err": 0.0, "cases": []},
           "decode_attention": {"max_abs_err": 0.0, "cases": []}}
    for mod in (flash_attention, decode_attention):
        mod.reset_launches()
    # ---- B3: prefill flash attention, causal. A case is (B, S, H, Hkv,
    # hd, dtype, view) (``prefill_inputs``); a view case is the flash_mma
    # variant's (8-byte pieces); hd 32 goes to flash_mma contiguous or not
    flash_cases = [(4, S, 40, 10, 128, dt, False) for S in (512, 2048)
                   for dt in (torch.bfloat16, torch.float32)]
    flash_cases += [(4, 1000, 40, 10, 128, torch.bfloat16, False),
                    (4, 512, 14, 2, 64, torch.bfloat16, False)]
    flash_cases += [(4, S, 16, 16, 256, torch.bfloat16, view)  # gemma-7b's heads
                    for S, view in ((512, False), (2048, False), (512, True))]
    flash_cases += [(4, 2048, 16, 16, 32, torch.bfloat16, view)
                    for view in (False, True)]
    flash_cases.append((4, 512, 14, 2, 64, torch.float32, False))
    flash_cases.append((4, 512, 16, 16, 128, torch.bfloat16, False))  # deepseek-moe-16b
    # every case so far is causal over Sk = S; then seamless-m4t's decoder
    # (causal), encoder and cross-attention (not causal; the server's
    # cross-attention has Sk = S, Sk = 300 shows Sq != Sk) at hd 64, g 1,
    # and jamba's attention at hd 128, g 8 (an entry: B, S, H, Hkv, hd,
    # dtype, view, causal, Sk)
    flash_cases = [c + (True, c[1]) for c in flash_cases]
    bf = torch.bfloat16
    flash_cases += [(4, 512, 16, 16, 64, bf, False, causal, Sk)
                    for causal, Sk in ((True, 512), (False, 512), (False, 300))]
    flash_cases.append((4, 512, 64, 8, 128, bf, False, True, 512))
    for i, (B, S, H, Hkv, hd, dt, view, causal, Sk) in enumerate(flash_cases):
        q, k, v = prefill_inputs(B, S, H, Hkv, hd, dt, view, 3 * i, Sk)
        label = (B, S, H, Hkv, hd, dt) + (("view",) if view else ()) + (
            () if causal else ("non-causal", Sk))
        before = dict(flash_attention.launches)
        out = flash_attention.flash_attention(q, k, v, causal=causal)
        again = flash_attention.flash_attention(q, k, v, causal=causal)
        ran = [n for n in flash_attention.VARIANTS
               if flash_attention.launches[n] > before[n]]
        want = ref.mha_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(len(ran) == 1 and ran[0] == flash_attention.variant_of(q, k, v),
              f"flash_attention {label} ran {ran}")
        err, ok = close(out, want, tol[dt])
        check(ok, f"flash_attention {label}: max |kernel - plain| {err} "
                  f"above {tol[dt]}")
        check(torch.equal(out, again), f"flash_attention {label}: two runs differ")

        def sdpa(q, k, v, causal=causal):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        lib_err = (sdpa(q, k, v).transpose(1, 2).float()
                   - want.float()).abs().max().item()
        args = [(q, k, v)]
        n = 10 if S > 1000 else 40
        ms = device_ms(lambda *a, c=causal: flash_attention.flash_attention(
            *a, causal=c), args, n)[0]
        plain_ms = device_ms(lambda *a, c=causal: ref.mha_ref(*a, causal=c),
                             args, n)[0]
        lib_ms = device_ms(sdpa, args, n)[0]
        elt = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
        # causal (Sk = S): row i sees i + 1 keys; else every row all Sk
        pairs = S * (S + 1) // 2 if causal else S * Sk
        flops = 4 * B * H * hd * pairs
        n_exp = B * H * pairs
        bound, by = attention_bound(nbytes, flops, n_exp, rate_exp, dt)
        extra = ({"bound_fp32_cores_ms": flops / FP32_FLOPS * 1e3}
                 if dt == torch.float32 else {})
        res["flash_attention"]["max_abs_err"] = max(
            res["flash_attention"]["max_abs_err"], err)
        res["flash_attention"]["cases"].append(dict(
            shape=(B, S, H, Hkv, hd) + (("view",) if view else ()) + (
                () if causal else ("non-causal", Sk)),
            dtype=str(dt).split(".")[-1],
            variant=ran[0], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, library_err=lib_err, bound_ms=bound,
            bound_by=by, **extra))
        del q, k, v, out, again, want
    # ---- B4: decode attention over the serving caches (S_max = 512 + 32):
    # phi3's 40/10 heads at hd 128 (bf16 and f32, cur_len 0, 271, 543),
    # then gemma-7b's 16/16 at hd 256, deepseek-moe-16b's 16/16 at hd 128,
    # seamless-m4t's 16/16 at hd 64 and jamba's 64/8 at hd 128 (bf16, the
    # longest step)
    decode_cases = [((4, 544, 40, 10, 128), dt, (0, 271, 543))
                    for dt in (torch.bfloat16, torch.float32)]
    decode_cases.append(((4, 544, 16, 16, 256), torch.bfloat16, (543,)))
    decode_cases.append(((4, 544, 16, 16, 128), torch.bfloat16, (543,)))  # deepseek-moe-16b
    decode_cases.append(((4, 544, 16, 16, 64), torch.bfloat16, (543,)))  # seamless-m4t
    decode_cases.append(((4, 544, 64, 8, 128), torch.bfloat16, (543,)))  # jamba
    for j, ((B, S, H, Hkv, hd), dt, curs) in enumerate(decode_cases):
        q = randn((B, H, hd), 100 + j, dt)
        k = randn((B, S, Hkv, hd), 110 + j, dt)
        v = randn((B, S, Hkv, hd), 120 + j, dt)
        cold = [(q, k, v)] + [
            (randn((B, H, hd), 130 + c, dt), randn((B, S, Hkv, hd), 140 + c, dt),
             randn((B, S, Hkv, hd), 150 + c, dt)) for c in range(9)
        ] if dt == torch.bfloat16 else []
        for cur in curs:
            out = decode_attention.decode_attention(q, k, v, cur)
            again = decode_attention.decode_attention(q, k, v, cur)
            want = ref.decode_attn_ref(q, k, v, cur)
            torch.cuda.synchronize()
            err, ok = close(out, want, tol[dt])
            check(ok, f"decode_attention {(B, S, H, Hkv, hd)} {dt} cur_len={cur}: "
                      f"max |kernel - plain| {err} above {tol[dt]}")
            check(torch.equal(out, again), "decode_attention: two runs differ")
            res["decode_attention"]["max_abs_err"] = max(
                res["decode_attention"]["max_abs_err"], err)
            if cur < S - 1:  # garbage, then NaN, past cur_len changes nothing
                for fill in (1e6, float("nan")):
                    k2, v2 = k.clone(), v.clone()
                    k2[:, cur + 1:] = fill
                    v2[:, cur + 1:] = -fill
                    out2 = decode_attention.decode_attention(q, k2, v2, cur)
                    torch.cuda.synchronize()
                    check(torch.equal(out, out2),
                          f"decode_attention reads past cur_len={cur} "
                          f"(fill {fill})")
                del k2, v2
            if dt != torch.bfloat16:
                continue
            mask = (torch.arange(S, device=dev) <= cur)[None, None, None, :]

            def sdpa(q, k, v, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)[:, :, 0]

            lib_err = (sdpa(q, k, v).float() - want.float()).abs().max().item()
            fns = {"ms": lambda q, k, v, c=cur: decode_attention.decode_attention(
                       q, k, v, c),
                   "plain_ms": lambda q, k, v, c=cur: ref.decode_attn_ref(q, k, v, c),
                   "library_ms": sdpa}
            times = {}  # each call replayed from a CUDA graph of it
            for key, fn in fns.items():
                times["warm_" + key] = graph_ms(fn, cold[:1], 200)[0]
                times[key] = graph_ms(fn, cold, 200)[0]  # cold: main figure
            n_valid = cur + 1
            nbytes = (2 * q.numel() + 2 * B * n_valid * Hkv * hd) * q.element_size()
            bound, by = attention_bound(nbytes, 4 * B * H * hd * n_valid,
                                        B * H * n_valid, rate_exp, dt)
            res["decode_attention"]["cases"].append(dict(
                shape=(B, S, H, Hkv, hd), cur_len=cur,
                dtype=str(dt).split(".")[-1], max_abs_err=err, **times,
                library_err=lib_err, bound_ms=bound, bound_by=by))
        del q, k, v, cold
    # every launch of phase 6, the timing loops' included: flash_mma is on
    # no served path (every served config's prefill is TMA-aligned), so its
    # launches in the kernels line are these
    res["launches"] = {**flash_attention.launches, **decode_attention.launches}
    res["exp_per_s"] = rate_exp
    return res


def leaves(tree):
    """Every tensor of a parameter tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def kernels_per_call(fn, n, cpu=True):
    """Device kernels launched per call of ``fn`` over ``n`` calls, read
    from a ``torch.profiler`` trace (written under build/profile/).
    ``cpu=False`` records the device's activity alone (a train step's
    host ops would make the trace several times larger)."""
    return kernel_stats(fn, n, cpu)[0]


def kernel_stats(fn, n, cpu=True):
    """(kernels a call, ms a call the device spent in them: the sum of
    their durations) of ``fn`` over ``n`` calls, from a ``torch.profiler``
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "chip_smoke_decode_trace.json"
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return len(kernels) / n, sum(e["dur"] for e in kernels) / 1e3 / n


# leaves the analytic parameter count leaves out: norms, biases, the conv
# biases (the JAX package's ``analytic_param_count``)
UNCOUNTED = ("ln1", "ln2", "lnx", "bq", "bk", "bv", "conv_b", "b_if", "bias",
             "dt_bias")


def counted_weights(tree, name=""):
    """The weights of a parameter tree that the analytic count covers."""
    if isinstance(tree, dict):
        return sum(counted_weights(v, k) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(counted_weights(v) for v in tree)
    if name.endswith("norm") or name in UNCOUNTED:
        return 0
    return tree.numel()


def analytic_excess(cfg):
    """What the JAX package's count adds beyond the weights its init makes:
    its sLSTM term reads ``d * (4 * d) // 3 * 2`` as ((4d²) // 3) · 2, the
    gated MLP being 2 · d · (4d // 3) (682 a sLSTM layer at d 1024)."""
    if cfg.block_kind != "xlstm":
        return 0
    d = cfg.d_model
    per = d * (4 * d) // 3 * 2 - 2 * d * ((4 * d) // 3)
    n = cfg.xlstm_pattern.count("slstm") * (cfg.num_layers
                                            // len(cfg.xlstm_pattern))
    return per * n


def serve_counts(cfg):
    """(B3 launches a prefill, B4 launches a decoded token, MoE layers) of
    ``cfg``'s stack: under GQA one B3 and one B4 an attention layer, under
    encdec B3 also once an encoder layer and once a cross-attention (B4 only
    on the decoder's self-attention); MLA and xLSTM launch neither."""
    from repro_torch.models import transformer

    if cfg.block_kind == "encdec":
        n_dec = cfg.num_layers - cfg.encoder_layers
        return cfg.encoder_layers + 2 * n_dec, n_dec, 0
    kinds = transformer.group_layer_kinds(cfg)
    n = transformer.num_groups(cfg)
    attn = kinds.count("attn") * n if cfg.attn_kind == "gqa" else 0
    moe_layers = n * sum(transformer._uses_moe(cfg, i)
                         for i, k in enumerate(kinds) if k in ("attn", "mamba"))
    return attn, attn, moe_layers


def half_cut(arch):
    """serve_line's note for a phase run at half its published depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo

    cfg = get_config(arch)
    return (f" ({cfg.num_layers} layers cut to {cfg.num_layers // 2}, widths "
            f"kept; the whole model: analytic "
            f"{model_zoo.analytic_param_count(cfg):,} parameters)")


def phase_serve(arch, variant, **cut):
    """Phases 7, 9, 12, 13 and 16–18: RealServer at ``arch``'s full width on
    the card (``cut`` replaces config fields: depth, experts), 4 requests of
    512 prompt tokens and 32 new ones. B3 runs ``serve_counts``'s launches
    a prefill, each on ``variant``, and B4 its launches a decoded token (the
    prompt re-fed included). Under MoE the (token, choice) pairs that
    capacity drops at prefill are counted, once a MoE layer. The weights
    the analytic count covers equal it (``analytic_excess`` aside).
    Afterwards the kernels of one decode step (cur_len 512 on) are counted
    under the profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import decode_attention, distance, flash_attention
    from repro_torch.launch.serve import RealServer
    from repro_torch.models import model_zoo, moe

    cfg = dataclasses.replace(get_config(arch), **cut)
    n_b3, n_b4, n_moe = serve_counts(cfg)
    B, S, NEW = 4, 512, 32
    t0 = time.perf_counter()
    server = RealServer(cfg, VectorPoolConfig(**SERVE_POOL), rag_interval=8,
                        seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(server.params))
    counted = counted_weights(server.params)
    finite = {"all": torch.ones((), dtype=torch.bool, device="cuda"),
              "steps": 0}
    dropped = {"pairs": torch.zeros((), dtype=torch.long, device="cuda"),
               "calls": 0}
    prefill, decode = server._prefill, server._decode
    moe_forward = moe.moe_forward

    def watched(fn):
        def run(*a):
            lg, caches = fn(*a)
            finite["all"] &= torch.isfinite(lg).all()  # no host sync
            finite["steps"] += 1
            return lg, caches
        return run

    def counted_moe(params, x, mcfg, capacity=0):
        if x.shape[0] > B:  # a prefill call: count what capacity drops
            C = capacity or moe.capacity_for(x.shape[0], mcfg)
            _, idx = moe.route_topk(x.float() @ params["router"],
                                    mcfg.moe.top_k)
            occ = torch.bincount(idx.reshape(-1),
                                 minlength=mcfg.moe.num_experts)
            dropped["pairs"] += (occ - C).clamp(min=0).sum()
            dropped["calls"] += 1
        return moe_forward(params, x, mcfg, capacity)

    server._prefill, server._decode = watched(prefill), watched(decode)
    moe.moe_forward = counted_moe
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    for mod in (distance, flash_attention, decode_attention):
        mod.reset_launches()
    try:
        toks, stats = server.generate(prompts, max_new=NEW)
        torch.cuda.synchronize()
    finally:
        moe.moe_forward = moe_forward
    launches = {**distance.launches, **flash_attention.launches,
                **decode_attention.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(toks.shape == (B, NEW), f"tokens shape {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a generated token is out of the vocabulary")
    check(bool(finite["all"].item()) and finite["steps"] == 1 + S + NEW,
          f"{arch}: non-finite logits (or {finite['steps']} model calls)")
    check(launches["flash_attention"] == n_b3
          and (n_b3 == 0 or launches[variant] == n_b3),
          f"{arch}: flash_attention launched {launches['flash_attention']}"
          f" times ({launches.get(variant)} on {variant}), not {n_b3} on "
          f"{variant}")
    check(launches["decode_attention"] == n_b4 * (S + NEW),
          f"{arch}: decode_attention launched {launches['decode_attention']}"
          f" times, not {n_b4 * (S + NEW)}")
    check(dropped["calls"] == n_moe,
          f"{arch}: {dropped['calls']} MoE prefill calls, not {n_moe}")
    analytic = model_zoo.analytic_param_count(cfg)
    check(counted + analytic_excess(cfg) == analytic,
          f"{arch}: {counted} counted weights (+ {analytic_excess(cfg)}) != "
          f"the analytic count {analytic}")
    check(launches["distance_slot_gather"] >= B,
          f"{arch}: distance_slot_gather launched "
          f"{launches['distance_slot_gather']} times on the serving path")
    caches = model_zoo.init_decode_caches(cfg, B, S + NEW, "cuda")
    tok = server._tokens(toks[:, :1])
    pos = iter(range(S, S + NEW))
    step = lambda: decode(server.params, tok, caches, next(pos))  # noqa: E731
    for _ in range(2):
        step()
    k_step = kernels_per_call(step, 4)
    out = dict(cfg=cfg, init_s=init_s, params=n_params, analytic=analytic,
               toks=toks, stats=stats, launches=launches, peak_gib=peak_gib,
               tok_per_s=B * NEW / stats["decode_s"], kernels_step=k_step,
               dropped=int(dropped["pairs"].item()),
               routed=n_moe * B * S * cfg.moe.top_k if n_moe else 0)
    del server, prefill, decode, watched, caches, step
    gc.collect()  # the watched calls and the server refer to each other
    torch.cuda.empty_cache()
    return out


SHARDED = dict(num_shards=SHARDS, replicas_per_shard=2,
               semantic_cache_enabled=True)  # phase 10's pool
P10_PROBES = 512  # phase 10's probes: the quickstart stream's first 512
N_INSERT, N_LOOKUP = 128, 128  # phase 10's inserts and cache lookups


def sharded_stream(stream, queries, inserts, fresh, n_insert, n_lookup):
    """Phase 10's traffic: the quickstart stream, with insert i of
    ``n_insert`` at the arrival of request 4i; then, once drained,
    ``n_lookup`` cache lookups: lookup j repeats insert j // 2 when j is
    even and is fresh vector j // 2 when odd. Returns (events [(t, what,
    payload)] in submission order, lookups [(rid, vector)])."""
    events = []
    for rid, kind, t, ddl in stream:
        events.append((t, "probe", (rid, kind, queries[rid], ddl)))
        if rid % 4 == 0 and rid // 4 < n_insert:
            events.append((t, "insert", rid // 4))
    lookups = [(1_000_000 + j, inserts[j // 2] if j % 2 == 0
                else fresh[j // 2]) for j in range(n_lookup)]
    return events, lookups


def drive_sharded(cfg, shards, db, inserts, events, lookups, device):
    """Submit phase 10's traffic to a ShardedVectorPool over ``shards`` on
    ``device``, drain the probes and inserts, then the lookups. Returns
    (pool, wall seconds, chunks launched, insert wall seconds)."""
    import torch

    from repro_torch.core import ShardedVectorPool, VectorRequest

    pool = ShardedVectorPool(cfg, db, device=device, seed=0,
                             shard_index=shards)
    chunks, insert_s = [], []
    step, insert_local = pool._group.step_lanes_async, shards.insert_local

    def counted_step(lanes, k):
        chunks.append(k)
        return step(lanes, k)

    def timed_insert(*a, **kw):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = insert_local(*a, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        insert_s.append(time.perf_counter() - t0)
        return out

    pool._group.step_lanes_async = counted_step
    shards.insert_local = timed_insert
    t0 = time.perf_counter()
    for t, what, x in events:
        if what == "probe":
            rid, kind, q, ddl = x
            pool.submit(VectorRequest(rid, kind, q, t, ddl))
        else:
            pool.submit_insert(inserts[x], meta={"insert": x}, t_now=t)
    t_end = events[-1][0] + 1.0
    pool.run_until(t_end)
    ddl = cfg.prefill_deadline_ms / 1e3  # the cache_lookup class's
    for j, (rid, q) in enumerate(lookups):
        t = t_end + j * 1e-4
        pool.submit(VectorRequest(rid, "cache_lookup", q, t, t + ddl))
    pool.run_until(t_end + 1.0)
    if device == "cuda":
        torch.cuda.synchronize()
    del shards.insert_local  # the clone's method again
    return pool, time.perf_counter() - t0, chunks, insert_s


def sharded_results(pool, n_probe, n_insert, lookups):
    """Phase 10's checks on one run: every probe, insert and lookup
    completed exactly once. Returns (probe ids (n, 10), hits: one bool a
    lookup — its nearest entry within ``cache_hit_threshold`` and its
    answer served by ``meta_at``)."""
    import numpy as np

    done = pool.metrics.completed
    rids = [r.rid for r in done]
    check(len(rids) == len(set(rids)), "a request completed twice")
    probes = {r.rid: r for r in done if r.kind in ("prefill", "decode")}
    check(sorted(probes) == list(range(n_probe)),
          f"{len(probes)} probe completions for {n_probe} probes")
    check(pool.metrics.inserts == n_insert,
          f"{pool.metrics.inserts} inserts placed for {n_insert}")
    n_queued = sum(r.kind == "insert" for r in done)
    check(n_queued <= n_insert and n_queued >= n_insert - SHARDS,
          f"{n_queued} searched inserts completed (at most one insert a "
          "shard is placed without a search)")
    look = {r.rid: r for r in done if r.kind == "cache_lookup"}
    check(sorted(look) == sorted(rid for rid, _ in lookups),
          f"{len(look)} lookup completions for {len(lookups)} lookups")
    thr = pool.cfg.cache_hit_threshold
    hits = np.asarray([
        look[rid].result_ids is not None
        and look[rid].result_dists[0] <= thr
        and pool.meta_at(int(look[rid].result_ids[0]),
                         look[rid].t_completed) is not None
        for rid, _ in lookups], bool)
    ids = np.stack([probes[i].result_ids for i in range(n_probe)])
    check(ids.shape == (n_probe, 10) and (ids >= 0).all() and (ids < N).all(),
          "sharded results are not 10 valid global ids per probe")
    return ids, hits


def phase_sharded(db, queries, stream, true_ids):
    """Phase 10: the sharded, megabatched pool at full size
    (sharded-sift1m-shape): the 10^6 x 128 corpus in 4 shards x 2 replicas
    (8 lanes of one GroupEngine), the answer cache on, exact shard graphs
    built on the card; the stream it is given (the quickstart stream's
    first 512 requests) with 128 inserts, then 128 cache lookups; every
    grouped chunk's distance stage one lane launch.
    The first 128 probes with the first 32 inserts and their 32 repeat
    lookups run again on the card and on the CPU over clones of the same
    shards (equal lists and hits), and the first 64 probes with their 16
    inserts on the card with distance_mode="matmul_onehot" (B2's lane
    form; recall within 0.01 of the slot-gather run's)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import distance
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.ref import recall_at_k
    from repro_torch.vector.shards import ShardedIndex

    t_phase = time.perf_counter()
    cfg = VectorPoolConfig(num_vectors=N, dim=D_IM, **SHARDED)
    t0 = time.perf_counter()
    shards = ShardedIndex(
        db, num_shards=SHARDS, degree=cfg.graph_degree, metric=cfg.metric,
        cache_capacity=cfg.cache_capacity,
        kmeans_iters=cfg.shard_kmeans_iters, seed=0,
        route_centroids=cfg.shard_route_centroids,
        exact_threshold=-(-N // SHARDS), device="cuda")
    build_s = time.perf_counter() - t0
    sizes = [len(r) for r in shards.shard_rows]
    reduced_card, onehot_card = shards.clone(), shards.clone()
    reduced_cpu = shards.clone("cpu")
    cluster_card = shards.clone()  # phase 11's pool
    inserts, fresh = make_dataset(N_INSERT, D_IM, seed=7,
                                  num_queries=N_LOOKUP // 2)
    events, lookups = sharded_stream(stream, queries, inserts, fresh,
                                     N_INSERT, N_LOOKUP)
    torch.cuda.reset_peak_memory_stats()
    distance.reset_launches()
    pool, wall, chunks, insert_s = drive_sharded(
        cfg, shards, db, inserts, events, lookups, "cuda")
    launches = dict(distance.launches)
    lanes = {k: dict(v) for k, v in distance.lane_launches.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m = pool.metrics
    ids, hits = sharded_results(pool, len(stream), N_INSERT, lookups)
    hit_rep, hit_fresh = int(hits[0::2].sum()), int(hits[1::2].sum())
    recall = recall_at_k(ids, true_ids)
    check(recall >= 0.3, f"sharded recall@10 {recall:.4f} under 0.3")
    check(m.broadcasts == 2 * m.inserts,
          f"{m.broadcasts} broadcasts for {m.inserts} inserts (want 2 each:"
          " the owning shard's two replicas only)")
    check(2 * hit_rep >= N_INSERT // 2,
          f"{hit_rep} of {N_INSERT // 2} repeated lookups hit")
    G = pool._group.g_cap
    check(G == 8 and lanes["distance_slot_gather"] == {G: sum(chunks)}
          and launches["distance_slot_gather"] == sum(chunks)
          and launches["distance_onehot"] == 0,
          f"distance launches {launches} by G {lanes} for {len(chunks)} "
          f"grouped chunks of {sum(chunks)} extends: not one {G}-lane launch"
          " a grouped extend")
    bcast_b = pool.broadcast_bytes / max(m.broadcasts, 1)
    lane_copy_b = pool._group.n_max * (cfg.dim + cfg.graph_degree) * 4
    out = dict(
        wall_s=wall, build_s=build_s, sizes=sizes, recall=recall,
        hit_rep=hit_rep, hit_fresh=hit_fresh, launches=launches,
        lanes=lanes, chunks=len(chunks), extends=sum(chunks), G=G,
        completed=len(m.completed), inserts=m.inserts,
        broadcasts=m.broadcasts, merges=m.merges, evictions=m.cache_evictions,
        sub_searches=m.sub_searches, bcast_bytes=bcast_b,
        lane_copy_bytes=lane_copy_b, peak_gib=peak_gib,
        insert_ms=np.percentile(np.asarray(insert_s) * 1e3, [50, 95]),
        n_max=pool._group.n_max, occupancy=m.occupancy)
    del pool, shards
    gc.collect()
    torch.cuda.empty_cache()

    # the first 128 probes + first 32 inserts + their 32 repeat lookups,
    # on the card and on the CPU over clones of the same shards
    n_red = 128  # the CPU run of these is the phase's largest cost
    red_events = [e for e in events
                  if (e[1] == "probe" and e[2][0] < n_red)
                  or (e[1] == "insert" and e[2] < n_red // 4)]
    red_lookups = lookups[:2 * (n_red // 4):2]  # the repeats
    runs = {}
    for dev, sh in (("cuda", reduced_card), ("cpu", reduced_cpu)):
        p, w, _, _ = drive_sharded(cfg, sh, db, inserts, red_events,
                                   red_lookups, dev)
        r_ids, r_hits = sharded_results(p, n_red, n_red // 4, red_lookups)
        runs[dev] = dict(ids=r_ids, hits=int(r_hits.sum()), wall=w,
                         recall=recall_at_k(r_ids, true_ids[:n_red]))
        del p, sh
        gc.collect()
    torch.cuda.empty_cache()
    same = float((runs["cuda"]["ids"] == runs["cpu"]["ids"]).all(1).mean())
    check(same >= 0.99, f"only {same:.4f} of the sharded top-10 lists equal "
          "the CPU run")
    check(abs(runs["cuda"]["recall"] - runs["cpu"]["recall"]) <= 0.005,
          f"sharded recall {runs['cuda']['recall']:.4f} (card) vs "
          f"{runs['cpu']['recall']:.4f} (CPU)")
    check(runs["cuda"]["hits"] == runs["cpu"]["hits"],
          f"repeat hits {runs['cuda']['hits']} (card) vs "
          f"{runs['cpu']['hits']} (CPU)")
    out.update(red_same=same, red=runs, n_red=n_red,
               red_vs_full=float((runs["cuda"]["ids"] == ids[:n_red])
                                 .all(1).mean()))

    # B2's lane form on the same path: the first 64 probes + 16 inserts
    n_oh = 64
    cfg_oh = dataclasses.replace(cfg, distance_mode="matmul_onehot")
    oh_events = [e for e in red_events
                 if (e[1] == "probe" and e[2][0] < n_oh)
                 or (e[1] == "insert" and e[2] < n_oh // 4)]
    distance.reset_launches()
    p, w, oh_chunks, _ = drive_sharded(cfg_oh, onehot_card, db, inserts,
                                       oh_events, [], "cuda")
    oh_launches = dict(distance.launches)
    oh_lanes = {k: dict(v) for k, v in distance.lane_launches.items()}
    oh_ids, _ = sharded_results(p, n_oh, n_oh // 4, [])
    del p, onehot_card
    gc.collect()
    torch.cuda.empty_cache()
    check(oh_lanes["distance_onehot"] == {G: sum(oh_chunks)}
          and oh_launches["distance_slot_gather"] == 0,
          f"matmul_onehot launches {oh_launches} by G {oh_lanes}")
    oh_recall = recall_at_k(oh_ids, true_ids[:n_oh])
    sg_recall = recall_at_k(runs["cuda"]["ids"][:n_oh], true_ids[:n_oh])
    check(abs(oh_recall - sg_recall) <= 0.01,
          f"matmul_onehot sharded recall {oh_recall:.4f} vs {sg_recall:.4f}")
    out.update(oh_recall=oh_recall, sg_recall=sg_recall, oh_wall=w,
               oh_launches=oh_launches, oh_lanes=oh_lanes,
               oh_same=float((oh_ids == runs["cuda"]["ids"][:n_oh])
                             .all(1).mean()),
               cluster_shards=cluster_card,
               phase_s=time.perf_counter() - t_phase)
    return out


# phase 11's cluster (rag-cluster-sift1m-shape): phi3-medium-14b priced on
# V5E, 2 prefill + 2 decode instances, phase 10's pool with rebalancing,
# the cache backup and the sanitizer on, the drifting-mix trace and a fixed
# fault list; the fixture run (make_sharded_pool_sim) on the card and the CPU
CLUSTER_T_TRACE, CLUSTER_RPS, CLUSTER_SEED = 1.5, 30.0, 0
CLUSTER_TAIL = 1.0  # simulated seconds after the last arrival
CLUSTER_POOL = dict(SHARDED, rebalance_enabled=True, cache_backup_enabled=True,
                    sanitizer_enabled=True)
# benchmarks/bench_autoscale.py's controller (its --smoke budget raised to
# the fixture cluster's 2 + 2 + 6 units plus 2 to grant)
FIXTURE_CONTROLLER = dict(
    epoch_s=0.02, window_s=0.3, ttft_slo_s=0.150, tpot_slo_s=0.008,
    probe_miss_budget=0.1, gpu_budget=12, queue_target=2.0,
    queue_target_vector=4.0, hot_factor=1.0, cold_factor=0.5,
    cooldown_up_s=0.06, cooldown_down_s=0.12, itl_protect_factor=1.2)
FIXTURE_RPS, FIXTURE_T_TRACE, FIXTURE_T_END = 80.0, 0.25, 0.8


def cluster_faults(chaos, t_trace):
    """Phase 11's fixed fault list over a trace of ``t_trace`` simulated
    seconds: a replica killed (respawned after its downtime), a straggler,
    the fullest cache-holding shard lost, a decode instance killed. The
    decode instance is not revived within the run: a revive while the
    instance had a decode step pending leaves it marked as stepping, and
    requests admitted to it afterwards never decode, in the JAX package as
    here (ROADMAP Queue C)."""
    T = t_trace
    return [chaos.FaultEvent(0.30 * T, "kill_replica", duration=0.10 * T),
            chaos.FaultEvent(0.45 * T, "straggle_replica", factor=8.0,
                             duration=0.10 * T),
            chaos.FaultEvent(0.70 * T, "lose_shard", duration=0.10 * T),
            chaos.FaultEvent(0.80 * T, "kill_decode", duration=1e3)]


def drive_cluster(sim, reqs, faults, t_end):
    """Arm ``faults`` on ``sim``, offer ``reqs`` and run it to ``t_end``,
    recording every vector request the pool took, every cancel, every
    shard loss (with the cache entries the shard held), every grouped
    chunk and the wall of every poll. Returns a dict of the records."""
    import torch

    from repro_torch.serving.chaos import ChaosInjector

    pool = sim.vector_pool
    card = pool.device.type == "cuda"
    rec = dict(submitted=[], placed=[], cancelled=[], losses=[], chunks=[],
               polls=[], idle_polls=[])
    submit, submit_insert = pool.submit, pool.submit_insert
    cancel, lose_shard = pool.cancel, pool.lose_shard
    poll = sim._poll_pool

    def rec_submit(req):
        rec["submitted"].append((req.rid, req.kind))
        return submit(req)

    def rec_insert(*a, **kw):
        gid = submit_insert(*a, **kw)
        if gid is not None:  # placed at once: no search to run
            rec["placed"].append(gid)
        return gid

    def rec_cancel(rid):
        found = cancel(rid)
        if found:
            rec["cancelled"].append(rid)
        return found

    def rec_lose(s):
        rec["losses"].append((s, pool.shards.shards[s].cache_size))
        return lose_shard(s)

    def rec_poll():
        n = len(rec["chunks"])
        t0 = time.perf_counter()
        poll()
        dt = time.perf_counter() - t0
        rec["polls"].append(dt)
        if len(rec["chunks"]) == n:
            rec["idle_polls"].append(dt)

    pool.submit, pool.submit_insert = rec_submit, rec_insert
    pool.cancel, pool.lose_shard = rec_cancel, rec_lose
    sim._poll_pool = rec_poll
    if pool._group is not None:
        step = pool._group.step_lanes_async

        def counted_step(lanes, k):
            rec["chunks"].append(k)
            return step(lanes, k)

        pool._group.step_lanes_async = counted_step
    inj = ChaosInjector(faults, seed=CLUSTER_SEED)
    inj.arm(sim)
    for r in reqs:
        sim.arrive(r)
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(t_end)
    if card:
        torch.cuda.synchronize()
    rec.update(wall_s=time.perf_counter() - t0, log=inj.log,
               injected=inj.injected)
    return rec


def check_cluster(sim, reqs, rec):
    """Phase 11's checks on one cluster run: every offered request finished
    once, every vector request the pool took completed once (or was
    cancelled by its dead instance), the sanitizer clean, each shard loss
    recovered every cache entry it held. Returns the vector requests'
    counts by kind."""
    pool = sim.vector_pool
    fin = [r.rid for r in sim.metrics.finished]
    check(sorted(fin) == sorted(r.rid for r in reqs),
          f"{len(fin)} requests finished ({len(set(fin))} distinct) for "
          f"{len(reqs)} offered")
    done = [r.rid for r in pool.metrics.completed]
    took = [rid for rid, _ in rec["submitted"]]
    check(len(done) == len(set(done)), "a vector request completed twice")
    check(len(took) == len(set(took)), "a vector rid was submitted twice")
    check(not set(done) & set(rec["cancelled"])
          and set(done) | set(rec["cancelled"]) == set(took),
          f"{len(took)} vector requests taken, {len(done)} completed, "
          f"{len(rec['cancelled'])} cancelled: not each exactly once")
    pool.sanitizer.assert_clean()
    m = pool.metrics
    held = sum(n for _, n in rec["losses"])
    check(rec["losses"] and held > 0 and m.cache_lost == 0
          and m.cache_recovered == held,
          f"shard losses {rec['losses']}: cache_lost {m.cache_lost}, "
          f"recovered {m.cache_recovered} of {held}")
    counts = {}
    for _, kind in rec["submitted"]:
        counts[kind] = counts.get(kind, 0) + 1
    counts["insert_placed"] = len(rec["placed"])
    return counts


def phase_cluster(db, shards, device="cuda"):
    """Phase 11: the Trinity cluster (rag-cluster-sift1m-shape). ClusterSim
    with phi3-medium-14b at its published widths (priced on V5E),
    disaggregated, trinity policy, 2 prefill + 2 decode instances, decode
    batch 8, over phase 10's pool (``shards``: a clone of its index) with
    rebalancing, the cache backup and the sanitizer on; the drifting-mix
    trace and a fixed fault list armed on the sim. Then the fixture cluster
    (``make_sharded_pool_sim``, 6,000 x 64 in 4 shards) with the autoscaler
    and a short fault list, on the card and on the CPU: equal summaries,
    signals, scale events and probe results."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import AutoscalerConfig, VectorPoolConfig
    from repro_torch.kernels import distance
    from repro_torch.serving import chaos
    from repro_torch.serving.cluster import ClusterSim, make_sharded_pool_sim
    from repro_torch.serving.traffic import (BULK_PREFILL, TenantSpec,
                                             TrafficGenerator, constant,
                                             drifting_mix_trace)

    t_phase = time.perf_counter()
    model = get_config("phi3-medium-14b")
    cfg = VectorPoolConfig(num_vectors=db.shape[0], dim=db.shape[1],
                           **CLUSTER_POOL)
    t0 = time.perf_counter()
    sim = ClusterSim(model, cfg, db, None, placement="disaggregated",
                     policy="trinity", n_prefill=2, n_decode=2,
                     decode_batch=8, vector_replicas=2, device=device,
                     shard_index=shards, seed=0)
    setup_s = time.perf_counter() - t0
    reqs = drifting_mix_trace(CLUSTER_T_TRACE, CLUSTER_RPS,
                              seed=CLUSTER_SEED).generate(CLUSTER_T_TRACE)
    t_end = CLUSTER_T_TRACE + CLUSTER_TAIL
    distance.reset_launches()
    rec = drive_cluster(sim, reqs, cluster_faults(chaos, CLUSTER_T_TRACE),
                        t_end)
    launches = dict(distance.launches)
    lanes = {k: dict(v) for k, v in distance.lane_launches.items()}
    counts = check_cluster(sim, reqs, rec)
    n_vec = sum(counts.values())
    s = sim.metrics.summary(t_end)
    check(s["cache_hits"] >= 1, "no repeat prompt hit the answer cache")
    check(rec["injected"] == 4, f"faults applied: {rec['log']}")
    pool = sim.vector_pool
    ext = sum(rec["chunks"])
    if device == "cuda":
        by_g = lanes["distance_slot_gather"]
        check(launches["distance_slot_gather"] == ext and ext > 0
              and sum(by_g.values()) == ext and 1 not in by_g
              and launches["distance_onehot"] == 0,
              f"distance launches {launches} by G {by_g} for {ext} grouped "
              "extends: not one lane launch a grouped extend")
    copies = [c for c in pool.lane_copies if c[0] != "build"]
    idle = np.asarray(rec["idle_polls"]) * 1e6
    out = dict(
        setup_s=setup_s, wall_s=rec["wall_s"], requests=len(reqs),
        counts=counts, n_vec=n_vec, summary=s, launches=launches,
        lanes=lanes, chunks=len(rec["chunks"]), extends=ext,
        polls=len(rec["polls"]), idle_polls=len(idle),
        idle_us=(float(np.median(idle)), float(idle.mean())) if len(idle)
        else (0.0, 0.0), poll_wall_s=float(np.sum(rec["polls"])),
        copies=copies, log=rec["log"], losses=rec["losses"],
        rebalances=pool.metrics.rebalances,
        deaths=pool.metrics.replica_deaths,
        recovered=pool.metrics.cache_recovered,
        bcast_bytes=pool.broadcast_bytes, broadcasts=pool.metrics.broadcasts,
        replicas=[(r.rid, r.shard) for r in pool.replicas])
    check(600 <= n_vec <= 1000, f"{n_vec} vector requests {counts}: the "
          "phase is sized for 600-1,000")
    del sim, pool
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the fixture cluster with the autoscaler and a short fault list, on
    # the card and on the CPU over the same shard graphs (built once on the
    # CPU; the card's run takes a clone)
    def fixture(dev, shard_index=None):
        over = dict(sanitizer_enabled=True, rebalance_enabled=True,
                    cache_backup_enabled=True)
        fsim, _, _ = make_sharded_pool_sim(
            model, pool_overrides=over, device=dev, shard_index=shard_index,
            autoscaler=AutoscalerConfig(**FIXTURE_CONTROLLER))
        # RAG chat with repeats beside bulk summarisation: the bulk
        # prompts press prefill, and the controller takes a vector unit
        gen = TrafficGenerator(constant(FIXTURE_RPS), [TenantSpec(
            "rag_chat", prompt_len=(64, 512), max_new_tokens=(8, 16),
            rag_interval=4, repeat_p=0.5, prompt_pool=3), BULK_PREFILL],
            seed=CLUSTER_SEED)
        return fsim, gen.generate(FIXTURE_T_TRACE)

    f_cpu, f_reqs = fixture("cpu")
    f_card, f_reqs2 = fixture(device, f_cpu.vector_pool.shards.clone(device))
    runs = {}
    for name, fsim, frq in (("card", f_card, f_reqs2), ("cpu", f_cpu, f_reqs)):
        frec = drive_cluster(fsim, frq, cluster_faults(chaos, FIXTURE_T_TRACE),
                             FIXTURE_T_END)
        check_cluster(fsim, frq, frec)
        probes = {r.rid: (r.t_completed, None if r.result_ids is None
                          else np.asarray(r.result_ids).tolist())
                  for r in fsim.vector_pool.metrics.completed}
        runs[name] = dict(
            summary=fsim.metrics.summary(FIXTURE_T_END),
            signals=[dataclasses.asdict(x)
                     for x in fsim.autoscaler.signals_log],
            events=[dataclasses.asdict(e) for e in fsim.metrics.scale_events],
            probes=probes, wall_s=frec["wall_s"], log=frec["log"])
    a, b = runs["card"], runs["cpu"]
    for key in ("summary", "signals", "events", "probes", "log"):
        check(a[key] == b[key], f"fixture cluster: card and CPU {key} differ")
    out.update(fixture=dict(
        requests=len(f_reqs), vec=len(b["probes"]), wall_card=a["wall_s"],
        wall_cpu=b["wall_s"], events=len(b["events"]),
        signals=len(b["signals"]), hits=b["summary"]["cache_hits"]),
        phase_s=time.perf_counter() - t_phase)
    return out


def prefill_batch(cfg, prompts, device):
    """RealServer's prefill batch: the prompts, and under encdec its stub
    frames (ones x 0.1 in the model's dtype)."""
    import torch

    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import DTYPES

    batch = {"tokens": torch.as_tensor(prompts, device=device)}
    if model_zoo.is_encdec(cfg):
        batch["frames"] = torch.ones(
            prompts.shape + (cfg.d_model,), dtype=DTYPES[cfg.dtype],
            device=device) * 0.1
    return batch


def servers_card_vs_cpu(name, cfg, n_new=8):
    """RealServer on the CPU and on the card over one set of weights: 2
    prompts of 32 tokens, ``n_new`` new. Tokens must be equal and the
    prefill logits within atol = rtol = 1e-3 (float32 sums in other orders:
    cuBLAS and the kernels against the CPU's BLAS). Returns the B3 launches
    of the card's generate beside the timings."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import RealServer
    from repro_torch.models import model_zoo

    pool = VectorPoolConfig(**SERVE_POOL)
    t0 = time.perf_counter()
    cpu = RealServer(cfg, pool, rag_interval=8, seed=0, device="cpu")
    card = RealServer(cfg, pool, rag_interval=8, seed=0, device="cuda",
                      params=convert.lm_params_from_numpy(
                          cfg, convert.lm_params_to_numpy(cpu.params), "cuda"))
    setup_s = time.perf_counter() - t0
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    flash_attention.reset_launches()
    t0 = time.perf_counter()
    toks_card, _ = card.generate(prompts, max_new=n_new)
    card_s = time.perf_counter() - t0
    launches = dict(flash_attention.launches)
    t0 = time.perf_counter()
    toks_cpu, _ = cpu.generate(prompts, max_new=n_new)
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(toks_card, toks_cpu),
          f"{name}: card tokens {toks_card.tolist()} != CPU tokens "
          f"{toks_cpu.tolist()}")
    lg = {dev: model_zoo.prefill_fn(cfg, server.params, prefill_batch(
              cfg, prompts, server.device))[0].cpu()
          for dev, server in (("card", card), ("cpu", cpu))}
    err, ok = close(lg["card"], lg["cpu"], 1e-3)
    check(ok, f"{name}: prefill logits card vs CPU differ by {err}")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(toks=toks_card, logit_err=err, setup_s=setup_s,
                card_s=card_s, cpu_s=cpu_s, launches=launches)


def phase_card_vs_cpu():
    """Phase 8: one set of weights at phi3's widths (2 layers, float32)
    through RealServer on the card and on the CPU; the card's prefill on
    flash_fp32 once a layer."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("phi3-medium-14b"), num_layers=2,
                              dtype="float32")
    out = servers_card_vs_cpu("phi3 x 2 layers", cfg)
    check(out["launches"]["flash_fp32"] == cfg.num_layers,
          f"f32 prefill ran {out['launches']}, not flash_fp32 once per layer")
    return out


def phase_mla_attention():
    """MLA's prefill attention at deepseek-v3's published widths (B=4,
    S=512, 128 heads, q/k head dim 192, v 128, bf16, causal): the port's
    torch ops (``attention.attend_blocked``; no TPU kernel and no hand-written
    one) beside torch's scaled_dot_product_attention on the same inputs (a
    yardstick only; the port never calls it), each per call by CUDA events;
    the bound is bytes (q, k, v read once, the output written once) or bf16
    operations, whichever is larger."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import attention

    B, S, H, hd, hd_v = 4, 512, 128, 192, 128
    g = torch.Generator(device="cuda").manual_seed(40)
    q, k = (torch.randn((B, S, H, hd), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    v = torch.randn((B, S, H, hd_v), generator=g, device="cuda").bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device="cuda")

    def port(q, k, v):
        return attention.attend_blocked(q, k, v, pos, pos, causal=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)

    out = port(q, k, v)
    want = port(q.float(), k.float(), v.float())  # the same ops in float32
    torch.cuda.synchronize()
    # 5e-2: the reference forms q.k in bf16 before the softmax (|q.k| ~ 14
    # here, so a score moves by up to ~2^-8 of it)
    err, ok = close(out, want, 5e-2)
    check(ok, f"MLA attend_blocked bf16 vs float32: max err {err}")
    args = [(q, k, v)]
    ms = device_ms(port, args, 20)[0]
    try:  # SDPA may refuse a v head dim other than q's
        lib_err = (sdpa(q, k, v).float() - want).abs().max().item()
        lib_ms = device_ms(sdpa, args, 20)[0]
    except RuntimeError:
        lib_err = lib_ms = None
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
    flops = 2 * B * H * (hd + hd_v) * S * (S + 1) // 2
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(terms, key=terms.get)
    return dict(ms=ms, library_ms=lib_ms, bound_ms=terms[by], bound_by=by,
                err=err, library_err=lib_err)


def phase_deepseek_card_vs_cpu():
    """Phase 14: the DeepSeek family through RealServer on the card and on
    the CPU, one set of weights each: deepseek-moe-16b's published widths
    cut to 2 layers, then deepseek-v3's smoke config, float32, 2 prompts of
    32 tokens and 8 new (equal tokens, prefill logits within 1e-3); then one
    layer of deepseek-v3's MLA at its published widths, float32: forward
    over 2 x 32 tokens and 8 absorbed decode steps, card against CPU
    (1e-3)."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import mla

    out = {}
    for name, cfg in (
            ("deepseek-moe-16b x 2 layers", dataclasses.replace(
                get_config("deepseek-moe-16b"), num_layers=2,
                dtype="float32")),
            ("deepseek-v3-671b smoke", get_smoke_config("deepseek-v3-671b"))):
        out[name] = servers_card_vs_cpu(name, cfg)

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), dtype="float32")
    cpu_p = mla.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    card_p = {k: v.cuda() for k, v in cpu_p.items()}
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    errs = []
    fwd = [mla.mla_forward(p, x.to(dev), cfg)[0].cpu()
           for p, dev in ((card_p, "cuda"), (cpu_p, "cpu"))]
    errs.append(close(fwd[0], fwd[1], 1e-3))
    caches = [mla.init_mla_cache(cfg, 2, 8, torch.float32, dev)
              for dev in ("cuda", "cpu")]
    for i in range(8):
        step = [mla.mla_decode_step(p, x[:, i:i + 1].to(dev), c, i, cfg)[0]
                .cpu() for p, c, dev in ((card_p, caches[0], "cuda"),
                                         (cpu_p, caches[1], "cpu"))]
        errs.append(close(step[0], step[1], 1e-3))
    check(all(ok for _, ok in errs),
          f"MLA layer card vs CPU: max errors {[e for e, _ in errs]}")
    out["mla_layer_err"] = max(e for e, _ in errs)
    del card_p, caches
    torch.cuda.empty_cache()
    return out


def phase_family_card_vs_cpu():
    """Phase 19: xLSTM, the encoder-decoder and the mamba hybrid through
    RealServer on the card and on the CPU, float32, one set of weights each:
    xlstm-350m's widths cut to one group of 8 layers, seamless-m4t's cut to
    one encoder and one decoder layer, jamba's smoke config (equal tokens,
    prefill logits within 1e-3). Then one jamba mamba layer and one xLSTM
    mLSTM + sLSTM pair at their published widths, float32: forward over
    2 x 32 tokens and 8 decode steps, card against CPU (1e-3)."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import mamba, xlstm

    out = {}
    for name, cfg in (
            ("xlstm-350m x 8 layers", dataclasses.replace(
                get_config("xlstm-350m"), num_layers=8, dtype="float32")),
            ("seamless-m4t-large-v2 x 1 + 1 layers", dataclasses.replace(
                get_config("seamless-m4t-large-v2"), num_layers=2,
                encoder_layers=1, dtype="float32")),
            ("jamba-1.5-large-398b smoke",
             get_smoke_config("jamba-1.5-large-398b"))):
        out[name] = servers_card_vs_cpu(name, cfg)

    def layer_errs(cfg, blocks, seed):
        """blocks: [(init, block, decode_step)] run in turn over x."""
        gen = torch.Generator().manual_seed(seed)
        cpu_p = [init(gen, cfg, torch.float32) for init, _, _ in blocks]
        card_p = [{k: v.cuda() for k, v in p.items()} for p in cpu_p]
        x = torch.randn((2, 40, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed + 1))
        errs, caches = [], {}
        for dev, params in (("cuda", card_p), ("cpu", cpu_p)):
            h, cs = x[:, :32].to(dev), []
            for (_, block, _), p in zip(blocks, params):
                h, c = block(p, h, cfg)
                cs.append(c)
            steps = []
            for i in range(32, 40):
                h = x[:, i:i + 1].to(dev)
                for j, ((_, _, step), p) in enumerate(zip(blocks, params)):
                    h, cs[j] = step(p, h, cs[j], cfg)
                steps.append(h.cpu())
            caches[dev] = (cs, steps)
        for a, b in zip(caches["cuda"][1], caches["cpu"][1]):
            errs.append(close(a, b, 1e-3))
        for ca, cb in zip(caches["cuda"][0], caches["cpu"][0]):
            errs += [close(ca[k].cpu(), cb[k], 1e-3) for k in cb]
        return errs

    jamba = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                dtype="float32")
    xl = dataclasses.replace(get_config("xlstm-350m"), dtype="float32")
    errs = layer_errs(jamba, [(mamba.init_mamba, mamba.mamba_block,
                               mamba.mamba_decode_step)], 7)
    errs += layer_errs(xl, [(xlstm.init_mlstm, xlstm.mlstm_block,
                             xlstm.mlstm_decode_step),
                            (xlstm.init_slstm, xlstm.slstm_block,
                             xlstm.slstm_decode_step)], 9)
    check(all(ok for _, ok in errs),
          f"mamba / xLSTM layers card vs CPU: max errors "
          f"{[e for e, _ in errs]}")
    out["layers_err"] = max(e for e, _ in errs)
    torch.cuda.empty_cache()
    return out


def phase_search_batch(db, graph, queries, true_ids, pool_ext, pool_ids, cfg):
    """Phase 15: CAGRA's per-request lockstep search (``search_batch``, the
    baseline the continuous-batching pool is measured against) on phase 3's
    10^6 x 128 index, the same 1024 queries, at the pool's top_m,
    parents_per_step and visited_slots, 8 entry points; max_iters 256 so
    the batch runs until every query has converged. recall@10, mean extends
    and the iterations the batch held, beside phase 3's pool on the same
    queries."""
    import numpy as np
    import torch

    from repro_torch.vector.cagra import search_batch
    from repro_torch.vector.ref import recall_at_k

    db_t = torch.as_tensor(db, device="cuda")
    graph_t = torch.as_tensor(graph, device="cuda")
    q_t = torch.as_tensor(queries, device="cuda")
    kw = dict(top_m=cfg.top_m, p=cfg.parents_per_step, max_iters=256,
              visited_slots=cfg.visited_slots, device="cuda")
    search_batch(db_t, graph_t, q_t[:8], **kw)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists, ext, iters = search_batch(db_t, graph_t, q_t, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ids = ids[:, :cfg.top_k].cpu().numpy()
    ext = ext.cpu().numpy()
    check(ids.shape == (len(queries), cfg.top_k) and (ids >= 0).all(),
          "search_batch results are not valid ids")
    check(iters < 256 and int(ext.max()) == iters,
          f"search_batch ran {iters} iterations, extends max {ext.max()}")
    d = dists[:, :cfg.top_k].cpu().numpy()
    check(np.isfinite(d).all() and (np.diff(d, axis=1) >= 0).all(),
          "search_batch distances are not finite and ascending")
    del db_t, graph_t, q_t
    torch.cuda.empty_cache()
    return dict(recall=recall_at_k(ids, true_ids), ext_mean=float(ext.mean()),
                ext_max=int(ext.max()), iters=iters, wall_s=wall,
                pool_recall=recall_at_k(pool_ids, true_ids),
                pool_ext_mean=float(np.mean(pool_ext)),
                pool_ext_max=int(np.max(pool_ext)),
                same=float((ids == pool_ids).all(axis=1).mean()))


def kernel_launches():
    """Launches of every kernel (B1-B4 and B3's variants) since the last
    reset."""
    from repro_torch.kernels import decode_attention, distance, flash_attention

    return {**distance.launches, **flash_attention.launches,
            **decode_attention.launches}


def reset_kernel_launches():
    from repro_torch.kernels import decode_attention, distance, flash_attention

    for mod in (distance, flash_attention, decode_attention):
        mod.reset_launches()


def check_no_kernel_launch(phase):
    n = kernel_launches()
    check(not any(n.values()), f"phase {phase}: training launched {n}")
    return sum(n.values())


def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def tree_copy(tree):
    from repro_torch.training.optimizer import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def trees_equal(a, b):
    """Every leaf of ``a`` equal to ``b``'s bit for bit, dtypes included."""
    import torch

    from repro_torch.training.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def train_step_kernels(tr):
    """(kernels, the device's busy ms) of one train step on ``tr``'s state
    (profiler; the step's result is dropped, so the trainer's state is left
    as it was)."""
    batch = tr.batch(tr.step)
    tr.step_fn(tr.params, tr.opt_state, batch)  # warm
    return kernel_stats(
        lambda: tr.step_fn(tr.params, tr.opt_state, batch), 1, cpu=False)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside the block, the
    previous mode after. Without it the card's backward accumulates some
    gradients (the embedding's by index among them) in no fixed order, so
    two identical steps differ in their last bits and Adam grows that into
    a different run. cuBLAS on one stream repeats by itself, so its warning
    is silenced (warn_only)."""
    import warnings

    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def phase_train_xlstm():
    """Phase 20: xlstm-350m whole trained by the port's Trainer, a
    checkpoint every 10 steps, and a fresh Trainer on the same directory
    with step 20's checkpoint removed, which resumes at step 10; both runs
    with deterministic algorithms, so the resume can repeat the
    run bit for bit. Then three steps timed and one profiled in the
    default mode."""
    import shutil
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.training.data import SyntheticLMData
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import Trainer

    cfg = get_config("xlstm-350m")
    data = SyntheticLMData(cfg.vocab_size, 128, 8, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20)
    run_dir = CKPT / "xlstm"
    shutil.rmtree(CKPT, ignore_errors=True)
    reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = Trainer(cfg, data, opt, checkpoint_dir=str(run_dir),
                checkpoint_every=10, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(a.params))
    save, saves = a.ckpt.save, []

    def timed_save(*args):
        t = time.perf_counter()
        save(*args)
        saves.append(time.perf_counter() - t)

    a.ckpt.save = timed_save
    with deterministic_algorithms():
        hist = a.run(10, log=None)
        # the trainer's own peak, before the snapshot below joins it
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        snap = tree_copy({"params": a.params, "m": a.opt_state["m"],
                          "v": a.opt_state["v"]})
        ckpt_bytes = dir_bytes(run_dir / "step_00000010")
        hist += a.run(20, log=None)
    step_s = list(a.step_s)
    # the default mode (atomic accumulations allowed): wall and kernels of
    # a step on the step-20 state, the results dropped
    k_step, busy_ms = train_step_kernels(a)
    default_s = []
    for _ in range(3):
        t = time.perf_counter()
        float(a.step_fn(a.params, a.opt_state, a.batch(a.step))[2]["loss"])
        default_s.append(time.perf_counter() - t)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    # a run killed after its step-10 commit: step 20's checkpoint is gone
    shutil.rmtree(run_dir / "step_00000020")
    t0 = time.perf_counter()
    b = Trainer(cfg, data, opt, checkpoint_dir=str(run_dir),
                checkpoint_every=10, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(b.step == 10 and int(b.opt_state["step"]) == 10,
          f"the resumed trainer is at step {b.step}, not 10")
    check(trees_equal(b.params, snap["params"])
          and trees_equal(b.opt_state["m"], snap["m"])
          and trees_equal(b.opt_state["v"], snap["v"]),
          "the restored params or moments differ from the saved ones")
    del snap
    with deterministic_algorithms():
        resumed = b.run(20, log=None)
    launched = check_no_kernel_launch(20)
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, hist[10:]))
    check(len(hist) == 20 and len(resumed) == 10, "step counts")
    check(all(math.isfinite(x) for x in hist + resumed),
          "a loss is not finite")
    check(hist[19] < hist[0] and sum(hist[15:]) < sum(hist[:5]),
          f"the loss did not fall: steps 1, 10, 20: {hist[0]}, {hist[9]}, "
          f"{hist[19]}; first five {hist[:5]}, last five {hist[15:]}")
    check(rel <= 1e-3, f"resumed losses {rel:.3g} (relative) off the "
          "uninterrupted run's")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT, ignore_errors=True)
    return dict(cfg=cfg, n_params=n_params,
                analytic=model_zoo.analytic_param_count(cfg), init_s=init_s,
                hist=hist, resumed=resumed, rel=rel,
                bitwise=resumed == hist[10:],
                step_med=statistics.median(step_s), step_mean=sum(step_s)
                / len(step_s), step_first=step_s[0], k_step=k_step,
                default_med=statistics.median(default_s), busy_ms=busy_ms,
                peak_gib=peak_gib, ckpt_bytes=ckpt_bytes, saves=saves,
                restore_s=restore_s, launched=launched)


def attend_yardstick(B=8, S=128, H=12, hd=64):
    """attend_blocked forward + backward against SDPA forward + backward
    on the same f32 inputs (causal): the device's busy ms a call (the sum
    of its kernels' durations, profiler: the host issues these calls
    slower than the card runs them, so CUDA events would time the host),
    kernels a call, the host wall a call, and their outputs' and
    gradients' largest difference."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.attention import attend_blocked

    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, gout = (torch.randn((B, S, H, hd), generator=g, device="cuda")
                     for _ in range(4))
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def blocked(q_, k_, v_):
        out = attend_blocked(q_, k_, v_, pos, pos, causal=True)
        return (out, *torch.autograd.grad(out, (q_, k_, v_), gout))

    def sdpa(q_, k_, v_):
        out = F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            is_causal=True).transpose(1, 2)
        return (out, *torch.autograd.grad(out, (q_, k_, v_), gout))

    err = max((a - b).abs().max().item()
              for a, b in zip(blocked(*leaves), sdpa(*leaves)))
    out = dict(err=err, shape=(B, S, H, hd))
    for key, fn in (("blocked", blocked), ("sdpa", sdpa)):
        for _ in range(5):
            fn(*leaves)
        out[key + "_wall_ms"] = host_ms(fn, [leaves], n=50)
        out[key + "_kernels"], out[key + "_ms"] = kernel_stats(
            lambda: fn(*leaves), 10)
    return out


def phase_train_100m():
    """Phase 21: examples/train_100m.py's --full-100m config, 200 steps at
    the example's defaults (batch 8 x 128, AdamW 6e-4, warm-up 50, a
    checkpoint every 50), then the attention yardstick at its shape."""
    import shutil
    import statistics

    import torch

    from repro_torch.examples import train_100m
    from repro_torch.training.optimizer import tree_leaves

    cfg = train_100m.make_cfg(True)
    shutil.rmtree(CKPT, ignore_errors=True)
    reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = train_100m.make_trainer(cfg, 8, 128, str(CKPT / "lm100m"), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    hist = tr.run(200, log=None)
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    k_step, busy_ms = train_step_kernels(tr)
    launched = check_no_kernel_launch(21)
    check(all(math.isfinite(x) for x in hist), "a loss is not finite")
    check(hist[-1] <= hist[0] - 1.0,
          f"lm-100m's loss fell from {hist[0]} to {hist[-1]}, not by 1.0")
    steps = sorted(CKPT.joinpath("lm100m").glob("step_*"))
    step_s = list(tr.step_s)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT, ignore_errors=True)
    return dict(cfg=cfg, n_params=n_params, hist=hist, wall_s=wall_s,
                step_med=statistics.median(step_s), k_step=k_step,
                busy_ms=busy_ms, peak_gib=peak_gib, launched=launched,
                ckpts=[p.name for p in steps], yard=attend_yardstick())


def phase_train_card_vs_cpu():
    """Phase 22: loss, metrics and gradients, then three Trainer steps, on
    the card and on the CPU from one set of weights, on five float32 smoke
    configs (tied head and GeGLU; MLA, MoE aux and MTP; mamba with
    moe_every; xLSTM; the encoder-decoder)."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_zoo
    from repro_torch.training.data import SyntheticEncDecData, SyntheticLMData
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import Trainer, value_and_grad

    def data(cfg, seq, batch, seed):
        if model_zoo.is_encdec(cfg):
            return SyntheticEncDecData(cfg.vocab_size, seq, batch,
                                       cfg.d_model, seed=seed)
        return SyntheticLMData(cfg.vocab_size, seq, batch, seed=seed)

    reset_kernel_launches()
    out = {}
    for arch in ("gemma-7b", "deepseek-v3-671b", "jamba-1.5-large-398b",
                 "xlstm-350m", "seamless-m4t-large-v2"):
        cfg = get_smoke_config(arch)
        t0 = time.perf_counter()
        weights = convert.lm_params_to_numpy(
            model_zoo.init_params(cfg, 0, device="cpu"))
        params = {dev: convert.lm_params_from_numpy(cfg, weights, dev)
                  for dev in ("cuda", "cpu")}
        batch = data(cfg, 24, 2, 1).batch_at(0)
        res = {dev: value_and_grad(cfg, params[dev], {
            k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            for dev in ("cuda", "cpu")}
        (lg, mg, gg), (lc, mc, gc_) = res["cuda"], res["cpu"]
        rel = {k: abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])),
                                                          1e-30)
               for k in mc}
        check(mg.keys() == mc.keys() and all(
            r <= 1e-4 or abs(float(mc[k])) < 1e-7 for k, r in rel.items()),
            f"{arch}: metrics card vs CPU {rel}")
        g_err = max(
            ((a.cpu().float() - b.float()).abs().max()
             / b.float().abs().max().clamp(min=1e-30)).item()
            for a, b in zip(tree_leaves(gg), tree_leaves(gc_)))
        check(g_err <= 1e-3, f"{arch}: a gradient leaf {g_err:.3g} of its "
              "max |g| off the CPU's")
        hists = {dev: Trainer(cfg, data(cfg, 16, 4, 2),
                              AdamWConfig(lr=1e-3, warmup_steps=2),
                              device=dev, params=params[dev]).run(3, log=None)
                 for dev in ("cuda", "cpu")}
        h_rel = max(abs(x - y) / abs(y)
                    for x, y in zip(hists["cuda"], hists["cpu"]))
        check(h_rel <= 1e-4, f"{arch}: Trainer losses card {hists['cuda']} "
              f"vs CPU {hists['cpu']}")
        out[arch] = dict(loss=float(lg), rel=max(rel.values()), g_err=g_err,
                         h_rel=h_rel, hist=hists["cuda"],
                         wall_s=time.perf_counter() - t0)
    out["launched"] = check_no_kernel_launch(22)
    torch.cuda.empty_cache()
    return out


MESH_NEW = 32  # phase 23's decoded tokens
# phase 23's B4 lse shapes: phi3's, gemma-7b's (hd 256) and jamba's (g 8)
LSE_CASES = ((4, 544, 40, 10, 128), (4, 544, 16, 16, 256),
             (4, 544, 64, 8, 128))
LSE_SLICES = (2, 4, 8)  # M of the sliced combine
LSE_CUR = 300  # its cur_len: slices past it hold no valid position


def combine_slices(parts):
    """The seqshard core's combine (``sharding.merge_partials``, which
    ``combine_partials`` runs between its all_reduces), over a list instead
    of ranks: [(out (B, H, hd), lse (B, H))] of the slices that hold a
    valid position -> out in float32."""
    import torch

    from repro_torch.distributed import sharding

    lse = torch.stack([p[1] for p in parts])
    o = torch.stack([p[0].float() for p in parts])
    return sharding.merge_stacked(lse, torch.ones_like(lse), o)


def lse_library(q, k, v):
    """One PyTorch call that returns decode attention's output and its
    log-sum-exp over every position (B4 with lse at cur_len = S - 1; a
    yardstick, never called by the port): FlashAttention-2's forward as
    ATen binds it (``_scaled_dot_product_flash_attention``: GQA in the
    kernel, the lse in natural log, float32). q (B, H, hd); k, v (B, S,
    Hkv, hd) -> (out (B, H, hd), lse (B, H))."""
    import torch

    res = torch.ops.aten._scaled_dot_product_flash_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), 0.0, False,
        False)
    return res[0][:, :, 0], res[1][:, :, 0]


def phase_lse():
    """B4 with its log-sum-exp against the plain version at phi3's,
    gemma-7b's and jamba's decode shapes (bf16, cur_len 543; out, float32
    in this mode, within 2e-2 as phase 6, lse within 1e-3), out rounded to
    bf16 equal to the launch without lse bit for bit; then M in {2, 4, 8}
    slices of phi3's cache (boundaries at multiples of 544 / M, inside a
    32-position tile; cur_len 300, so the last slices hold nothing and
    launch nothing), combined by ``sharding.merge_stacked`` (the seqshard
    core's arithmetic), against one launch with lse over the whole
    (float32, 1e-3); times of the lse launch beside the launch without
    lse, the plain version and ``lse_library`` (cold L2, CUDA-graph
    replay)."""
    import torch

    from repro_torch.kernels import decode_attention, ref

    dev = torch.device("cuda")
    res = {"cases": [], "max_abs_err": 0.0, "lse_err": 0.0, "slices": []}

    def randn(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    for j, (B, S, H, Hkv, hd) in enumerate(LSE_CASES):
        sets = [(randn((B, H, hd), 300 + 3 * c + 10 * j),
                 randn((B, S, Hkv, hd), 301 + 3 * c + 10 * j),
                 randn((B, S, Hkv, hd), 302 + 3 * c + 10 * j))
                for c in range(10)]
        q, k, v = sets[0]
        cur = S - 1
        out, lse = decode_attention.decode_attention(q, k, v, cur,
                                                     return_lse=True)
        plain = decode_attention.decode_attention(q, k, v, cur)
        want, want_lse = ref.decode_attn_ref(q, k, v, cur, return_lse=True)
        torch.cuda.synchronize()
        err, ok = close(out, want, 2e-2)
        lerr, lok = close(lse, want_lse, 1e-3)
        check(ok and lok, f"B4 with lse {(B, S, H, Hkv, hd)}: out err {err}, "
              f"lse err {lerr}")
        check(torch.equal(out.bfloat16(), plain), "B4: out with lse (f32) "
              "rounded to bf16 differs from out without")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["lse_err"] = max(res["lse_err"], lerr)
        lib = lse_library(q, k, v)
        torch.cuda.synchronize()
        lib_err = max(close(lib[0], want, 2e-2)[0],
                      close(lib[1], want_lse, 1e-3)[0])
        times = {
            "ms": graph_ms(lambda q, k, v: decode_attention.decode_attention(
                q, k, v, cur, return_lse=True), sets, 200)[0],
            "no_lse_ms": graph_ms(lambda q, k, v: decode_attention
                                  .decode_attention(q, k, v, cur), sets,
                                  200)[0],
            "plain_ms": graph_ms(lambda q, k, v: ref.decode_attn_ref(
                q, k, v, cur, return_lse=True), sets, 200)[0],
            "library_ms": graph_ms(lse_library, sets, 200)[0]}
        nbytes = ((2 * q.numel() + 2 * B * S * Hkv * hd) * 2 + B * H * 4)
        bound, by = attention_bound(nbytes, 4 * B * H * hd * S, 0, 1.0,
                                    torch.bfloat16)
        res["cases"].append(dict(shape=(B, S, H, Hkv, hd), cur_len=cur,
                                 max_abs_err=err, lse_err=lerr, bound_ms=bound,
                                 bound_by=by, library_err=lib_err, **times))
        if j == 0:  # the sliced combine on phi3's cache
            whole = decode_attention.decode_attention(
                q, k, v, LSE_CUR, return_lse=True)[0]
            pw = ref.decode_attn_ref(q, k, v, LSE_CUR, True)[0]
            for M in LSE_SLICES:
                S_loc = S // M
                parts, plain_parts = [], []
                for i in range(M):
                    local = LSE_CUR - i * S_loc
                    if local < 0:
                        continue  # past cur_len: nothing launched
                    ks, vs = (t[:, i * S_loc:(i + 1) * S_loc] for t in (k, v))
                    parts.append(decode_attention.decode_attention(
                        q, ks, vs, local, return_lse=True))
                    plain_parts.append(ref.decode_attn_ref(q, ks, vs, local,
                                                           True))
                got = combine_slices(parts)
                got_plain = combine_slices(plain_parts)
                torch.cuda.synchronize()
                serr, sok = close(got, whole, 1e-3)
                perr, _ = close(got_plain, pw, 1e-3)
                check(sok, f"B4 over {M} slices combined vs one launch with "
                      f"lse: max err {serr} above 1e-3")
                res["slices"].append(dict(M=M, launched=len(parts),
                                          max_abs_err=serr, plain_err=perr))
        del sets, q, k, v
    torch.cuda.empty_cache()
    return res


def phase_mesh():
    """Phase 23: the mesh code on the card. ``make_host_mesh`` makes a
    (1, 1) NCCL mesh over a one-rank in-memory group; phi3-medium-14b at
    full width (d_model 5120, 40/10 heads at hd 128, bf16, random weights
    from seed 0) cut to 2 of its 40 layers prefills 4 x 512 tokens, the
    caches are padded to 544 (the handoff), and 32 tokens are decoded
    greedily twice from copies of them: with seq_axis="model" inside
    activation_sharding(mesh) and without. Tokens equal, logits within
    1e-3; every decode attention of the first a B4 launch with lse, none of
    the second. Then B4's lse (``phase_lse``), and one dry-run cell of a
    published config on the production mesh through the dry run's CLI in a
    process of its own (meta tensors over the fake backend: the planning
    path imports and runs on this torch build)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import decode_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.serving.kv_cache import pad_prefill_caches

    t_phase = time.perf_counter()
    mesh = make_host_mesh(device="cuda")
    check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
          f"host mesh {mesh} on {dist.get_backend()}")
    try:
        cfg = dataclasses.replace(get_config("phi3-medium-14b"), num_layers=2)
        params = model_zoo.init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(23)
        toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=g,
                             device="cuda", dtype=torch.int32)
        with torch.no_grad():
            logits0, caches = model_zoo.prefill_fn(cfg, params,
                                                   {"tokens": toks})
        caches = pad_prefill_caches(caches, 512 + MESH_NEW)
        runs = {}
        with torch.no_grad(), sharding.activation_sharding(mesh):
            # warm-up: the first sharded step imports the DTensor module
            model_zoo.decode_fn(cfg, params, toks[:, :1],
                                [{k: t.clone() for k, t in layer.items()}
                                 for layer in caches], 512, seq_axis="model")
        for name, ctx, seq_axis in (
                ("seqshard", sharding.activation_sharding(mesh), "model"),
                ("plain", contextlib.nullcontext(), None)):
            c = [{k: t.clone() for k, t in layer.items()} for layer in caches]
            tok = logits0[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out_toks, out_logits = [], []
            decode_attention.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad(), ctx:
                for i in range(MESH_NEW):
                    lg, c = model_zoo.decode_fn(cfg, params, tok, c, 512 + i,
                                                seq_axis=seq_axis)
                    tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                    out_toks.append(tok)
                    out_logits.append(lg)
            torch.cuda.synchronize()
            runs[name] = dict(toks=torch.cat(out_toks, 1).cpu(),
                              logits=torch.cat(out_logits, 1),
                              wall_s=time.perf_counter() - t0,
                              launches=dict(decode_attention.launches))
        n_b4 = cfg.num_layers * MESH_NEW
        ss, pl = runs["seqshard"], runs["plain"]
        check(ss["launches"] == {"decode_attention": n_b4,
                                 "decode_attention_lse": n_b4},
              f"seqshard decode launched {ss['launches']}, want {n_b4} B4 "
              "launches, each with lse")
        check(pl["launches"] == {"decode_attention": n_b4,
                                 "decode_attention_lse": 0},
              f"plain decode launched {pl['launches']}")
        check(torch.equal(ss["toks"], pl["toks"]),
              "seqshard tokens differ from the plain decode's")
        err, ok = close(ss["logits"], pl["logits"], 1e-3)
        check(ok, f"seqshard logits vs plain: max err {err} above 1e-3")
        check(bool(torch.isfinite(ss["logits"]).all()), "non-finite logits")
        out = dict(toks=ss["toks"][0].tolist(), logit_err=err,
                   launches=ss["launches"], wall_seq=ss["wall_s"],
                   wall_plain=pl["wall_s"])
        del params, caches, runs, ss, pl, logits0
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["lse"] = phase_lse()

    # one cell of the dry run on the production mesh, the CLI in a process
    # of its own (the fake backend becomes its default group)
    rdir = ROOT / "build" / "chip_smoke_dryrun"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi3-medium-14b", "--shape", "decode_32k", "--force",
         "--results-dir", str(rdir)], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0, f"dry run failed: {proc.stderr[-2000:]}")
    rec = json.loads((rdir / "phi3-medium-14b__decode_32k__pod_16x16.json")
                     .read_text())
    check(rec["status"] == "ok", f"dry-run cell: {rec.get('error')}")
    check(rec["per_device"]["flops"] > 0
          and rec["memory_analysis"]["argument_size"] > 0,
          f"dry-run cell counted nothing: {rec['per_device']}")
    out.update(dryrun=rec, dryrun_s=time.perf_counter() - t0,
               phase_s=time.perf_counter() - t_phase)
    return out


def training_phases(smi):
    """Phases 20-22, each printed on a line of its own. Returns the
    kernels' launches over the three (0: checked in each phase)."""
    no_kernel = ("B1-B4 launches 0 (by design: training attends through "
                 "attend_blocked, torch ops under autograd; the kernels have "
                 "no backward)")
    t0 = time.perf_counter()
    since = mark()
    tx = phase_train_xlstm()
    h = tx["hist"]
    same = ("bit for bit" if tx["bitwise"] else "not bit for bit") + \
        ", both runs with deterministic algorithms"
    print(f"phase 20 train {tx['cfg'].name} whole (24 layers, d_model 1024, "
          f"{tx['cfg'].dtype}; analytic {tx['analytic']:,} parameters, "
          f"{tx['n_params']:,} weights with norms and biases, made in "
          f"{tx['init_s']:.1f} s): Trainer on SyntheticLMData("
          f"{tx['cfg'].vocab_size}, 128, 8, seed 0), AdamW lr 1e-3 warm-up "
          f"20, a checkpoint every 10"
          f" | loss at steps 1, 10, 20: {h[0]:.4f}, {h[9]:.4f}, {h[19]:.4f} "
          f"(falls: step 20 below step 1, steps 16-20 below steps 1-5 on "
          f"average: {sum(h[15:]) / 5:.4f} vs {sum(h[:5]) / 5:.4f}) | s/step "
          f"with deterministic algorithms median {tx['step_med']:.4f}, mean "
          f"{tx['step_mean']:.4f}, first {tx['step_first']:.4f}; in the "
          f"default mode {tx['default_med']:.4f} (median of 3), "
          f"{tx['k_step']:.0f} kernels a step, the device busy "
          f"{tx['busy_ms']:.1f} ms of it (profiler; busy share "
          f"{tx['busy_ms'] / 1e3 / tx['default_med']:.4f}); peak allocated "
          f"{tx['peak_gib']:.2f} GiB | checkpoint {tx['ckpt_bytes']:,} B, "
          f"written in {', '.join(f'{x:.2f}' for x in tx['saves'])} s, "
          f"restored in {tx['restore_s']:.2f} s: params and moments equal to "
          f"the saved ones bit for bit | resumed at step 10, steps 11-20: "
          f"losses within {tx['rel']:.3g} (relative; 1e-3) of the "
          f"uninterrupted run's ({same}) "
          f"| {no_kernel} | {smi} | {time.perf_counter() - t0:.1f} s",
          flush=True)
    took("phase 20", since)
    t0 = time.perf_counter()
    since = mark()
    t1 = phase_train_100m()
    h, y = t1["hist"], t1["yard"]
    print(f"phase 21 train {t1['cfg'].name} (examples/train_100m.py "
          f"--full-100m: 12 layers, d_model 768, 12/12 heads, f32, "
          f"{t1['n_params']:,} weights): 200 steps of 8 x 128 tokens, AdamW "
          f"6e-4 warm-up 50, checkpoints {t1['ckpts']} | loss {h[0]:.4f} -> "
          f"{h[-1]:.4f} (fell {h[0] - h[-1]:.4f}; >= 1.0), s/step median "
          f"{t1['step_med']:.4f}, {t1['wall_s']:.1f} s for 200 steps with "
          f"checkpoints, {t1['k_step']:.0f} kernels a step, the device busy "
          f"{t1['busy_ms']:.1f} ms of it (profiler; busy share "
          f"{t1['busy_ms'] / 1e3 / t1['step_med']:.4f}), peak "
          f"allocated {t1['peak_gib']:.2f} GiB | yardstick at {y['shape']} "
          f"f32 causal, forward + backward: attend_blocked device busy "
          f"{y['blocked_ms']:.5f} ms in {y['blocked_kernels']:.0f} kernels, "
          f"host wall {y['blocked_wall_ms']:.4f} ms; "
          f"scaled_dot_product_attention device busy {y['sdpa_ms']:.5f} ms "
          f"in {y['sdpa_kernels']:.0f} kernels "
          + (f"({y['blocked_ms'] / y['sdpa_ms']:.2f}x), " if y["sdpa_ms"]
             else "(the profiler saw none of its kernels: ratio not "
             "measured), ") +
          f"host wall {y['sdpa_wall_ms']:.4f} ms; outputs "
          f"and gradients within {y['err']:.3g} | {no_kernel} | {smi} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    took("phase 21", since)
    t0 = time.perf_counter()
    since = mark()
    tc = phase_train_card_vs_cpu()
    print("phase 22 train card vs cpu (f32 smoke configs, one set of weights "
          "and one batch): " + "; ".join(
              f"{arch}: loss {r['loss']:.6f}, metrics within {r['rel']:.3g} "
              f"(1e-4), gradient leaves within {r['g_err']:.3g} of their max "
              f"|g| (1e-3), 3 Trainer steps {[round(x, 5) for x in r['hist']]}"
              f" within {r['h_rel']:.3g} (1e-4), {r['wall_s']:.1f} s"
              for arch, r in tc.items() if arch != "launched")
          + f" | {no_kernel} | {time.perf_counter() - t0:.1f} s", flush=True)
    took("phase 22", since)
    return tx["launched"] + t1["launched"] + tc["launched"]


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
    run_mark = since = mark()
    sources = ("distance", "attention")  # csrc/<name>.cu, one nvcc each

    def build(name):
        _build.load(name)
        return time.perf_counter()

    # the builds run while phase 3's dataset, exact graph and ground truth
    # are made (none needs a kernel); every build is joined before phase 2
    # loads a source
    with ThreadPoolExecutor(len(sources)) as ex:
        built = [ex.submit(build, name) for name in sources]
        t1 = time.perf_counter()
        db, queries = make_dataset(N, D_IM, seed=0, num_queries=NUM_QUERIES)
        data_s = time.perf_counter() - t1
        cfg = VectorPoolConfig(num_vectors=N, dim=D_IM)
        t1 = time.perf_counter()
        graph = make_cagra_graph(db, cfg.graph_degree, exact_threshold=N,
                                 device="cuda")
        graph_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        true_ids, _ = exact_knn(db, queries, cfg.top_k, device="cuda")
        gt_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        prep_s = time.perf_counter() - t0
        build_s = max(f.result() for f in built) - t0  # a failed build raises
    print(f"phase 1 environment: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"kernels built in {build_s:.2f} s ({', '.join(sources)}, in "
          f"parallel; phase 3's dataset, graph and ground truth made beside "
          f"them in {prep_s:.1f} s)", flush=True)
    took("phase 1", since)

    # ---- phase 2: kernels vs plain versions at the engine shape ----------
    since = mark()
    db_t = torch.as_tensor(db, device="cuda")
    kres = phase_kernels(db_t, queries)
    holds = hold_check(db_t, queries)
    del db_t
    floor = kres["distance_slot_gather"]

    def case_line(c):
        return (f"ms={c['ms']:.5f} b2b={c['b2b_ms']:.5f} plain_ms="
                f"{c['plain_ms']:.5f} bound_ms={c['bound_ms']:.6f} "
                f"({c['bound_by']}, {c['bytes']:.0f} B)")

    print("phase 2 kernels: " + "; ".join(
        f"{n} max_abs_err={r['max_abs_err']:.3g} "
        f"ms={r['ms']:.5f} (again {r['ms_again']:.5f}, back to back "
        f"{r['b2b_ms']:.5f}) "
        f"plain_ms={r['plain_ms']:.5f} (back to back "
        f"{r['plain_b2b_ms']:.5f}) "
        f"wall_ms={r['wall_ms']:.5f} plain_wall_ms={r['plain_wall_ms']:.5f} "
        f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, "
        f"{r['bytes']:.0f} B) | serving pool (G=1, T=512, d=64): "
        f"{case_line(r['serve_pool'])} | lanes: " + ", ".join(
            f"G={c['G']} {case_line(c)}" for c in r["lanes"])
        for n, r in kres.items())
        + f" | launch floor (one-element add): ms={floor['floor_ms']:.5f} "
        f"b2b={floor['floor_b2b_ms']:.5f} | library_ms none: no single PyTorch "
        "call gathers rows by id and reduces each against its own slot's "
        f"query | lane g of every G-lane launch equal to its own launch | "
        f"{smi}", flush=True)
    print("phase 2 hold check (event-pair median, ms; the fixed hold this "
          "script used before, then the sized hold; within 5%): " + "; ".join(
              f"{label}: {old:.6f} vs {new:.6f} ({new / old - 1:+.2%})"
              for label, old, new in holds), flush=True)
    took("phase 2", since)

    # ---- phase 3: the pool at full size (its index made in phase 1) -------
    since = mark()
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

    # the CPU run: the stream's first N_CPU requests (to leave the time
    # limit room for phase 23), held to the card's same requests
    pool_cpu, wall_cpu, _ = drive_pool(cfg, db, graph, queries,
                                       stream[:N_CPU], "cpu")
    ids_cpu, ext_cpu = results_of(pool_cpu, N_CPU)
    recall_cpu = recall_at_k(ids_cpu, true_ids[:N_CPU])
    recall_card = recall_at_k(ids_gpu[:N_CPU], true_ids[:N_CPU])
    same = float((ids_gpu[:N_CPU] == ids_cpu).all(axis=1).mean())
    check(same >= 0.99, f"only {same:.4f} of top-10 lists equal the CPU run")
    check(abs(recall_card - recall_cpu) <= 0.005,
          f"recall@10 {recall_card:.4f} (card) vs {recall_cpu:.4f} (CPU) on "
          f"the first {N_CPU}")
    p50, p95 = np.percentile(np.asarray(chunk_s) * 1e3, [50, 95])
    print(f"phase 3 pool: N={N} d={D_IM} dataset {data_s:.1f} s, graph "
          f"(exact kNN on the card) {graph_s:.1f} s, ground truth {gt_s:.2f} s"
          f" | {len(m.completed)}/{NUM_QUERIES} completed, recall@10="
          f"{recall:.4f}, {len(chunk_s)} chunks of {cfg.extend_chunk} extends"
          f", step_multi wall p50={p50:.3f} ms p95={p95:.3f} ms, "
          f"{NUM_QUERIES / wall_s:.1f} completed requests per wall-second "
          f"({wall_s:.2f} s), peak allocated {peak_mb:.0f} MiB, occupancy "
          f"{m.occupancy:.4f}, preemptions {m.preemptions}, launches "
          f"{main_launches} | CPU run: "
          f"first {N_CPU} requests, recall@10={recall_cpu:.4f} (card "
          f"{recall_card:.4f}), "
          f"top-10 lists equal {same:.4f}, extends equal "
          f"{float((ext_gpu[:N_CPU] == ext_cpu).mean()):.4f}, {wall_cpu:.1f} s",
          flush=True)
    took("phase 3", since)

    # ---- phase 4: the one-hot form on the first 256 queries ---------------
    since = mark()
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
          f"{wall4:.2f} s, launches {onehot_launches}",
          flush=True)
    took("phase 4", since)

    # ---- phase 5: the paths went through the kernels -----------------------
    since = mark()
    launches = {"distance_slot_gather":
                main_launches["distance_slot_gather"],
                "distance_onehot": onehot_launches["distance_onehot"]}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on its path")
    check(main_launches["distance_onehot"] == 0
          and onehot_launches["distance_slot_gather"] == 0,
          "a path launched the other mode's kernel")
    print(f"phase 5 kernels: launches {launches} "
          f"(extend steps {m.extend_steps} slot_gather, "
          f"{pool4.metrics.extend_steps} onehot)", flush=True)
    took("phase 5", since)
    took("phases 1-5", run_mark)

    # ---- phase 6: attention kernels vs plain versions ----------------------
    since = mark()
    ares = phase_attention()
    fr = ares["flash_attention"]
    print(f"phase 6 flash_attention: max_abs_err={fr['max_abs_err']:.3g} | " + "; ".join(
        f"{c['shape']} {c['dtype']} on {c['variant']} err={c['max_abs_err']:.3g} "
        f"ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} library_ms(sdpa)="
        f"{c['library_ms']:.5f} (vs plain {c['library_err']:.3g}) bound_ms="
        f"{c['bound_ms']:.6f} ({c['bound_by']})" + (
            f" fp32-core bound {c['bound_fp32_cores_ms']:.6f}"
            if "bound_fp32_cores_ms" in c else "") for c in fr["cases"])
        + f" | exp rate {ares['exp_per_s']:.4g}/s", flush=True)
    dr = ares["decode_attention"]
    print(f"phase 6 decode_attention: max_abs_err={dr['max_abs_err']:.3g} | " + "; ".join(
        f"{c['shape']} cur_len={c['cur_len']} {c['dtype']} err={c['max_abs_err']:.3g}"
        f" cold L2: ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} library_ms(sdpa)="
        f"{c['library_ms']:.5f}; warm L2: ms={c['warm_ms']:.5f} plain_ms="
        f"{c['warm_plain_ms']:.5f} library_ms(sdpa)={c['warm_library_ms']:.5f}"
        f" (sdpa vs plain {c['library_err']:.3g}) bound_ms={c['bound_ms']:.6f} "
        f"({c['bound_by']})" for c in dr["cases"]), flush=True)
    took("phase 6", since)

    # ---- phase 7: the serving path at full width ---------------------------
    def serve_line(phase, srv, t0, cut=""):
        st = srv["stats"]
        drop = (f", {srv['dropped']} of {srv['routed']} routed (token, expert) "
                "pairs dropped by capacity at prefill" if srv["routed"] else "")
        return (f"phase {phase} serve {srv['cfg'].name}{cut}: analytic "
                f"{srv['analytic']:,} parameters, {srv['params'] / 1e9:.3f}e9 "
                f"weights ({srv['cfg'].dtype}, norms included) made on the card in "
                f"{srv['init_s']:.1f} s | 4 "
                f"requests x 512 prompt + 32 new tokens: ttft_s={st['ttft_s']:.3f} "
                f"decode_s={st['decode_s']:.3f} ({srv['tok_per_s']:.2f} decoded "
                f"tokens per wall-second), rag_probes={st['rag_probes']}, "
                f"stalls={st['stalls']}, every logit finite{drop}, peak allocated "
                f"{srv['peak_gib']:.2f} GiB, {srv['kernels_step']:.1f} kernels a "
                f"decode step (profiler), launches {srv['launches']} | first "
                f"request's tokens {srv['toks'][0].tolist()} | {smi} | "
                f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    since = mark()
    # phases 7, 9 and 12 run half their published depth, widths kept, to
    # leave the time limit room for the training phases 20-22
    srv = phase_serve("phi3-medium-14b", "flash_wgmma",  # frees its weights
                      num_layers=20)
    print(serve_line(7, srv, t0, cut=half_cut("phi3-medium-14b")), flush=True)
    took("phase 7", since)

    # ---- phase 8: card vs CPU through the same entry point -----------------
    t0 = time.perf_counter()
    since = mark()
    cmp_ = phase_card_vs_cpu()
    print(f"phase 8 card vs cpu (phi3 widths, 2 layers, f32): tokens equal "
          f"{cmp_['toks'].tolist()}, prefill logits max |card - cpu| "
          f"{cmp_['logit_err']:.3g} (atol = rtol = 1e-3) | set-up "
          f"{cmp_['setup_s']:.1f} s, generate on the card {cmp_['card_s']:.1f}"
          f" s, on the CPU {cmp_['cpu_s']:.1f} s | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    took("phase 8", since)

    # ---- phase 9: gemma-7b at full width, the hd-256 wgmma variant's path ---
    t0 = time.perf_counter()
    since = mark()
    gem = phase_serve("gemma-7b", "flash_wgmma256", num_layers=14)
    print(serve_line(9, gem, t0, cut=half_cut("gemma-7b")), flush=True)
    took("phase 9", since)

    # ---- phase 10: the sharded, megabatched pool at full size --------------
    # its first P10_PROBES requests (to leave room for phase 23)
    since = mark()
    sh = phase_sharded(db, queries, stream[:P10_PROBES],
                       true_ids[:P10_PROBES])
    red = sh["red"]
    print(f"phase 10 sharded pool: {N} x {D_IM} in {SHARDS} shards "
          f"{sh['sizes']} x 2 replicas = {sh['G']} lanes (stacked rows "
          f"{sh['n_max']}), shards and exact graphs built on the card in "
          f"{sh['build_s']:.1f} s | {P10_PROBES} probes + {N_INSERT} inserts "
          f"+ {N_LOOKUP} lookups: {sh['completed']} completions each once, "
          f"recall@10={sh['recall']:.4f}, repeated lookups hit "
          f"{sh['hit_rep']}/{N_INSERT // 2}, fresh lookups hit "
          f"{sh['hit_fresh']}/{N_LOOKUP // 2}, inserts {sh['inserts']} "
          f"broadcasts {sh['broadcasts']} (2 an insert: the owning shard's "
          f"replicas), {sh['bcast_bytes']:.0f} B copied a broadcast (a whole "
          f"lane: {sh['lane_copy_bytes']:.0f} B), insert wall p50/p95 "
          f"{sh['insert_ms'][0]:.3f}/{sh['insert_ms'][1]:.3f} ms, "
          f"evictions {sh['evictions']}, merges {sh['merges']}, children "
          f"{sh['sub_searches']}, occupancy {sh['occupancy']:.4f} | "
          f"{sh['chunks']} grouped chunks of {sh['extends']} extends, "
          f"distance launches {sh['launches']} by G {sh['lanes']}: one "
          f"{sh['G']}-lane launch a grouped extend, none single-lane | "
          f"{sh['wall_s']:.2f} s ({P10_PROBES / sh['wall_s']:.1f} probes per "
          f"wall-second), peak allocated {sh['peak_gib']:.2f} GiB | first "
          f"{sh['n_red']} probes + {sh['n_red'] // 4} inserts + "
          f"{sh['n_red'] // 4} repeat lookups, card vs CPU: top-10 "
          f"lists equal {sh['red_same']:.4f}, recall@10 "
          f"{red['cuda']['recall']:.4f} vs {red['cpu']['recall']:.4f}, hits "
          f"{red['cuda']['hits']} vs {red['cpu']['hits']}, "
          f"{red['cuda']['wall']:.1f} s vs {red['cpu']['wall']:.1f} s (lists"
          f" equal to the full run's {sh['red_vs_full']:.4f}) | "
          f"matmul_onehot on the first 64: recall@10={sh['oh_recall']:.4f} "
          f"(slot_gather {sh['sg_recall']:.4f}), lists equal "
          f"{sh['oh_same']:.4f}, launches {sh['oh_launches']} by G "
          f"{sh['oh_lanes']}, {sh['oh_wall']:.1f} s | {smi} | "
          f"{sh['phase_s']:.1f} s", flush=True)
    took("phase 10", since)

    # ---- phase 11: the Trinity cluster over phase 10's pool ---------------
    since = mark()
    cl = phase_cluster(db, sh.pop("cluster_shards"))
    s11, fx = cl["summary"], cl["fixture"]
    print(f"phase 11 cluster (rag-cluster-sift1m-shape): ClusterSim "
          f"disaggregated, trinity policy, phi3-medium-14b at its published "
          f"widths priced on V5E, 2 prefill + 2 decode instances (decode "
          f"batch 8), the pool {N} x {D_IM} in {SHARDS} shards x 2 replicas "
          f"with rebalancing, the cache backup and the sanitizer on (set-up "
          f"{cl['setup_s']:.2f} s over a clone of phase 10's shards) | "
          f"drifting-mix trace, {CLUSTER_T_TRACE} s at {CLUSTER_RPS} rps "
          f"base (seed {CLUSTER_SEED}), run to {CLUSTER_T_TRACE + CLUSTER_TAIL}"
          f" s: {cl['requests']} requests offered, each finished once | "
          f"{cl['n_vec']} vector requests {cl['counts']}, each completed once"
          f" or cancelled with its instance | faults "
          f"{[(e['kind'], e['target']) for e in cl['log']]}: replica deaths "
          f"{cl['deaths']}, shard loss (shard, entries held) {cl['losses']}: "
          f"recovered {cl['recovered']}, lost 0 | cache hits "
          f"{s11['cache_hits']} | rebalances {cl['rebalances']} | sanitizer "
          f"clean | {cl['chunks']} grouped chunks of {cl['extends']} extends,"
          f" B1 launches {cl['launches']['distance_slot_gather']} by G "
          f"{cl['lanes']['distance_slot_gather']}: one lane launch a grouped "
          f"extend, none single-lane | lane copies (reason, shard, bytes) "
          f"{cl['copies']}, insert broadcasts {cl['broadcasts']} of "
          f"{cl['bcast_bytes']} B in all | wall {cl['wall_s']:.2f} s, "
          f"{cl['n_vec'] / cl['wall_s']:.1f} vector requests per wall-second,"
          f" {cl['polls']} polls ({cl['poll_wall_s']:.2f} s), {cl['idle_polls']}"
          f" idle: median {cl['idle_us'][0]:.1f} us, mean "
          f"{cl['idle_us'][1]:.1f} us a poll | simulated (V5E model, not card "
          f"times): ttft p50/p95 {s11['ttft_p50']:.5f}/{s11['ttft_p95']:.5f} "
          f"s, tpot p50/p95 {s11['tpot_p50']:.6f}/{s11['tpot_p95']:.6f} s | "
          f"fixture cluster (6000 x 64, 4 shards, the autoscaler, 4 faults), "
          f"card vs CPU: summary, {fx['signals']} signal snapshots, "
          f"{fx['events']} scale events and {fx['vec']} vector results "
          f"equal, {fx['requests']} requests, cache hits {fx['hits']}, "
          f"{fx['wall_card']:.2f} s vs {fx['wall_cpu']:.2f} s | {smi} | "
          f"{cl['phase_s']:.1f} s", flush=True)
    took("phase 11", since)

    # ---- phase 12: deepseek-moe-16b at its widths, half its depth (MoE) -
    t0 = time.perf_counter()
    since = mark()
    dsm = phase_serve("deepseek-moe-16b", "flash_wgmma", num_layers=14)
    print(serve_line(12, dsm, t0, cut=half_cut("deepseek-moe-16b")),
          flush=True)
    took("phase 12", since)

    # ---- phase 13: deepseek-v3-671b at full width, depth 1 (MLA, MoE, MTP)
    t0 = time.perf_counter()
    since = mark()
    dsv = phase_serve("deepseek-v3-671b", None, num_layers=1)
    mla_t = phase_mla_attention()
    lib = ("SDPA refused these inputs" if mla_t["library_ms"] is None else
           f"library_ms(sdpa)={mla_t['library_ms']:.5f} (vs the float32 run "
           f"{mla_t['library_err']:.3g})")
    print(serve_line(13, dsv, t0, cut=" (61 layers cut to 1; the MTP block "
                     "made, not run)")
          + f" | MLA prefill attention (4, 512, 128 heads, qk 192 / v 128, "
          f"bf16, torch ops): ms={mla_t['ms']:.5f}, {lib}, bound_ms="
          f"{mla_t['bound_ms']:.6f} ({mla_t['bound_by']}), vs its float32 run "
          f"{mla_t['err']:.3g}", flush=True)
    took("phase 13", since)

    # ---- phase 14: the DeepSeek family, card vs CPU --------------------------
    t0 = time.perf_counter()
    since = mark()
    dcc = phase_deepseek_card_vs_cpu()
    print("phase 14 card vs cpu (DeepSeek, f32): " + "; ".join(
        f"{name}: tokens equal {r['toks'].tolist()}, prefill logits max "
        f"|card - cpu| {r['logit_err']:.3g} (atol = rtol = 1e-3), set-up "
        f"{r['setup_s']:.1f} s, generate {r['card_s']:.1f} s on the card, "
        f"{r['cpu_s']:.1f} s on the CPU"
        for name, r in dcc.items() if name != "mla_layer_err")
        + f"; deepseek-v3's MLA layer at its published widths: forward and 8 "
        f"decode steps within {dcc['mla_layer_err']:.3g} (1e-3) | "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
    took("phase 14", since)

    # ---- phase 15: CAGRA's per-request baseline on phase 3's index ---------
    t0 = time.perf_counter()
    since = mark()
    sb = phase_search_batch(db, graph, queries, true_ids, ext_gpu, ids_gpu, cfg)
    print(f"phase 15 search_batch (per-request lockstep, A4): {NUM_QUERIES} "
          f"queries over phase 3's {N} x {D_IM} index, top_m {cfg.top_m}, p "
          f"{cfg.parents_per_step}: recall@10={sb['recall']:.4f} (phase 3's "
          f"pool {sb['pool_recall']:.4f}), extends mean {sb['ext_mean']:.2f} "
          f"max {sb['ext_max']} (pool {sb['pool_ext_mean']:.2f} / "
          f"{sb['pool_ext_max']}), the batch held {sb['iters']} iterations, "
          f"top-10 lists equal to the pool's {sb['same']:.4f}, wall "
          f"{sb['wall_s']:.3f} s ({NUM_QUERIES / sb['wall_s']:.1f} queries per "
          f"wall-second) | {time.perf_counter() - t0:.1f} s", flush=True)
    took("phase 15", since)

    # ---- phases 16-18: xLSTM, the encoder-decoder and the mamba hybrid ----
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    since = mark()
    xls = phase_serve("xlstm-350m", None)
    print(serve_line(16, xls, t0) + " | no B3/B4 launch (xLSTM is torch ops; "
          "weights the analytic count covers: equal to it, but for the "
          f"reference's sLSTM rounding of {analytic_excess(xls['cfg'])})",
          flush=True)
    took("phase 16", since)
    t0 = time.perf_counter()
    since = mark()
    sml = phase_serve("seamless-m4t-large-v2", "flash_wgmma")
    print(serve_line(17, sml, t0) + " | bf16 stub frames (ones x 0.1); B3 on "
          "12 encoder, 12 decoder and 12 cross-attention layers; decode's "
          "cross-attention over the reference server's zero ck/cv (torch ops)",
          flush=True)
    took("phase 17", since)
    t0 = time.perf_counter()
    since = mark()
    jam_cfg = get_config("jamba-1.5-large-398b")
    jam = phase_serve("jamba-1.5-large-398b", "flash_wgmma", num_layers=8,
                      moe=dataclasses.replace(jam_cfg.moe, num_experts=8))
    print(serve_line(18, jam, t0, cut=" (72 layers cut to one group of 8, 16 "
                     "experts to 8, every width and top-2 kept)"), flush=True)
    took("phase 18", since)

    # ---- phase 19: the three families, card vs CPU ------------------------
    t0 = time.perf_counter()
    since = mark()
    fcc = phase_family_card_vs_cpu()
    print("phase 19 card vs cpu (xLSTM, encdec, mamba hybrid, f32): " + "; ".join(
        f"{name}: tokens equal {r['toks'].tolist()}, prefill logits max "
        f"|card - cpu| {r['logit_err']:.3g} (atol = rtol = 1e-3), set-up "
        f"{r['setup_s']:.1f} s, generate {r['card_s']:.1f} s on the card, "
        f"{r['cpu_s']:.1f} s on the CPU"
        for name, r in fcc.items() if name != "layers_err")
        + f"; jamba's mamba layer and xlstm-350m's mLSTM + sLSTM pair at their "
        f"published widths: forward and 8 decode steps within "
        f"{fcc['layers_err']:.3g} (1e-3) | {time.perf_counter() - t0:.1f} s",
        flush=True)
    took("phase 19", since)

    # ---- phases 20-22: training (no B1-B4 launch by design) ---------------
    train_launches = training_phases(smi)

    # ---- phase 23: the mesh code (seqshard decode, B4's lse, the dry run) --
    since = mark()
    msh = phase_mesh()
    lse, dry = msh["lse"], msh["dryrun"]
    pd_, ma = dry["per_device"], dry["memory_analysis"]
    print(f"phase 23 mesh: make_host_mesh (1, 1) NCCL over a one-rank group | "
          f"phi3-medium-14b at full width, 2 of 40 layers, 4 x 512 prompt "
          f"tokens, {MESH_NEW} decoded twice: seq_axis='model' in "
          f"activation_sharding(mesh) vs plain, tokens equal {msh['toks']}, "
          f"logits within {msh['logit_err']:.3g} (1e-3), launches "
          f"{msh['launches']} (every decode attention B4 with lse), "
          f"{msh['wall_seq']:.2f} s vs {msh['wall_plain']:.2f} s | B4 lse vs "
          f"plain: " + "; ".join(
              f"{c['shape']} out err {c['max_abs_err']:.3g} lse err "
              f"{c['lse_err']:.3g} ms={c['ms']:.5f} (without lse "
              f"{c['no_lse_ms']:.5f}) plain_ms={c['plain_ms']:.5f} "
              f"library_ms(flash)={c['library_ms']:.5f} (vs plain "
              f"{c['library_err']:.3g}) bound_ms={c['bound_ms']:.6f} "
              f"({c['bound_by']})" for c in lse["cases"])
          + " | slices of phi3's cache combined vs one launch (cur_len "
          f"{LSE_CUR}): " + ", ".join(
              f"M={c['M']} ({c['launched']} launched) err "
              f"{c['max_abs_err']:.3g} (plain {c['plain_err']:.3g})"
              for c in lse["slices"])
          + f" | dry run phi3-medium-14b x decode_32k x 16x16 (meta, fake "
          f"backend, {msh['dryrun_s']:.1f} s): per device flops "
          f"{pd_['flops']:.6g}, bytes {pd_['bytes_accessed']:.6g}, "
          f"collective {pd_['collective_bytes']}, argument "
          f"{ma['argument_size']} B, output {ma['output_size']} B, temp "
          f"{ma['temp_size']} B | {smi} | {msh['phase_s']:.1f} s", flush=True)
    took("phase 23", since)

    # launches on each kernel's path: B1/B2 on the pool (phases 3, 4); B3's
    # total, its wgmma variant and B4 on phi3's serving path (phase 7); the
    # f32 variant on phase 8's float32 server; the hd-256 wgmma variant on
    # gemma-7b's (phase 9), which also gives B4's launches at hd 256; the
    # mma.sync variant on no served path, so its count is phase 6's
    launches.update({n: srv["launches"][n] for n in
                     ("flash_attention", "flash_wgmma", "decode_attention")})
    # B1 and B2 add their lane launches on phase 10's megabatched path, and
    # B1 its lane launches on phase 11's cluster
    launches["distance_slot_gather"] += sh["launches"]["distance_slot_gather"]
    launches["distance_slot_gather"] += cl["launches"]["distance_slot_gather"]
    launches["distance_onehot"] += sh["oh_launches"]["distance_onehot"]
    # phase 12's deepseek-moe-16b adds its B3 (flash_wgmma) and B4
    # launches, phases 12 and 13 their B1 probes (deepseek-v3's MLA
    # launches neither B3 nor B4)
    # phases 17 and 18 (seamless-m4t, jamba) add theirs the same way, and
    # phases 16-18 their B1 probes (xLSTM launches neither B3 nor B4)
    for n in ("flash_attention", "flash_wgmma", "decode_attention"):
        for srv_ in (dsm, sml, jam):
            launches[n] += srv_["launches"][n]
    for srv_ in (dsm, dsv, xls, sml, jam):
        launches["distance_slot_gather"] += srv_["launches"]["distance_slot_gather"]
    # phase 23's seqshard decode: B4 with lse, every decode attention
    launches["decode_attention"] += msh["launches"]["decode_attention"]
    launches.update(flash_fp32=cmp_["launches"]["flash_fp32"],
                    flash_wgmma256=gem["launches"]["flash_wgmma256"],
                    flash_mma=ares["launches"]["flash_mma"])
    # each variant's numbers at its phase-6 case: the serving shape (prefill
    # B=4, S=512, bf16) for the total and wgmma, the same shape in f32,
    # gemma-7b's heads (hd 256, S=512) for wgmma256 and, read through the
    # unaligned view, for mma.sync; decode at the longest step (cur_len =
    # 543), bf16, cold L2 as the main figure: phi3's, with gemma-7b's beside.
    # The two mma.sync variants also list every phase-6 case they ran
    cases = fr["cases"]
    by_variant = {c["variant"]: c for c in reversed(cases)}
    var_err = {v: max(c["max_abs_err"] for c in cases if c["variant"] == v)
               for v in by_variant}
    dec = {c["shape"][2:]: c for c in dr["cases"] if c["cur_len"] == 543}
    main_case = {"flash_attention": cases[0], "flash_wgmma": cases[0],
                 "flash_wgmma256": by_variant["flash_wgmma256"],
                 "flash_fp32": by_variant["flash_fp32"],
                 "flash_mma": by_variant["flash_mma"],
                 "decode_attention": dec[(40, 10, 128)]}
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = kres.get(name) or main_case[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": kres[name]["max_abs_err"] if name in kres
            else var_err[name] if name in var_err
            else ares[name]["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            # launches in the training phases 20-22: 0 by design
            "train_launches": train_launches}
        if "warm_ms" in r:
            entry["warm_ms"] = r["warm_ms"]
        if name in DISTANCE:
            keys = ("ms", "b2b_ms", "plain_ms", "bound_ms")
            entry.update(
                b2b_ms=r["b2b_ms"], floor_ms=r["floor_ms"],
                floor_b2b_ms=r["floor_b2b_ms"],
                serve_pool={k: r["serve_pool"][k] for k in keys},
                lane_launches=(sh["lanes"] if name == "distance_slot_gather"
                               else sh["oh_lanes"])[name],
                cluster_lane_launches=cl["lanes"][name],
                lanes=[{"G": c["G"], **{k: c[k] for k in keys}}
                       for c in r["lanes"]])
        if name in ("flash_mma", "flash_fp32"):
            entry["cases"] = [
                {key: c[key] for key in ("shape", "dtype", "max_abs_err", "ms",
                                         "plain_ms", "library_ms", "bound_ms",
                                         "bound_by", "bound_fp32_cores_ms")
                 if key in c} for c in cases if c["variant"] == name]
        if name == "decode_attention":
            # phase 23: B4 with its lse, on the seqshard decode's path
            lc = lse["cases"][0]
            entry["lse"] = {
                "launches": msh["launches"]["decode_attention_lse"],
                "shape": lc["shape"], "max_abs_err": lc["max_abs_err"],
                "lse_err": lc["lse_err"], "ms": lc["ms"],
                "no_lse_ms": lc["no_lse_ms"], "plain_ms": lc["plain_ms"],
                "bound_ms": lc["bound_ms"], "bound_by": lc["bound_by"],
                # one ATen call that returns (out, lse): lse_library
                "library_ms": lc["library_ms"],
                "cases": lse["cases"], "slices": lse["slices"]}
            for key, shape, srv_ in (("gemma_7b", (16, 16, 256), gem),
                                     ("deepseek_moe_16b", (16, 16, 128), dsm),
                                     ("seamless_m4t_large_v2", (16, 16, 64),
                                      sml),
                                     ("jamba_15_large_398b", (64, 8, 128),
                                      jam)):
                g = dec[shape]
                entry[key] = {
                    "shape": g["shape"],
                    "launches": srv_["launches"]["decode_attention"],
                    "max_abs_err": g["max_abs_err"], "ms": g["ms"],
                    "warm_ms": g["warm_ms"], "plain_ms": g["plain_ms"],
                    "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                    "library_ms": g["library_ms"]}
        if name == "flash_wgmma":
            keys = ("shape", "dtype", "max_abs_err", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")
            # each served config's phase-6 cases at its heads: deepseek-moe's
            # (16/16, hd 128), seamless-m4t's causal, non-causal and Sq != Sk
            # cross cases (16/16, hd 64; the first is the main figure),
            # jamba's (64/8, hd 128)
            for key, heads, srv_ in (("deepseek_moe_16b", (16, 16, 128), dsm),
                                     ("seamless_m4t_large_v2", (16, 16, 64),
                                      sml),
                                     ("jamba_15_large_398b", (64, 8, 128),
                                      jam)):
                mine = [c for c in cases if c["shape"][2:5] == heads
                        and c["shape"][:2] == (4, 512)]
                entry[key] = {k: mine[0][k] for k in keys}
                entry[key]["launches"] = srv_["launches"]["flash_wgmma"]
                if len(mine) > 1:
                    entry[key]["cases"] = [{k: c[k] for k in keys}
                                           for c in mine]
        line.append(entry)
    took("all phases", run_mark)
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
