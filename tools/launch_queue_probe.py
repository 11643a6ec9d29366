#!/usr/bin/env python3
"""How many entries the CUDA launch queue of one stream takes before the
host waits on the device, and how the host waits, on one GPU:

  * one-element adds, then timing events, enqueued behind a 0.2 s sleep
    kernel: the index of the first enqueue that waited (> 20 ms);
  * replays of a CUDA graph of 20 adds behind the same sleep: whether a
    graph's kernels fill the queue as single launches do;
  * 64 MB multiplies (~50 us each on the device) past a full queue: after
    the wait, does the host enqueue one at the device's rate (a slot at a
    time), and is an event recorded behind 900 of them still pending once
    the host has enqueued 400 more (it is not, where the queue drains
    first)?

``chip_smoke.py``'s timing holds rest on these answers: a hold cannot
cover more calls than the queue takes, so its calls go in batches.

    python3 tools/launch_queue_probe.py
"""
import json
import subprocess
import sys
import time


def sleep_s(torch, clock_hz, seconds):
    torch.cuda._sleep(int(seconds * clock_hz))


def first_wait(ts, over=0.02):
    return next((i for i, t in enumerate(ts) if t > over), None)


def enqueue_times(fn, count):
    ts = []
    for _ in range(count):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    clock = float(mhz) * 1e6
    one = torch.zeros(1, device="cuda")
    for _ in range(10):
        one.add_(1.0)
    torch.cuda.synchronize()
    out = {}

    sleep_s(torch, clock, 0.2)
    out["adds_before_a_wait"] = first_wait(
        enqueue_times(lambda: one.add_(1.0), 3000))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3000)]
    it = iter(events)
    sleep_s(torch, clock, 0.2)
    out["timing_events_before_a_wait"] = first_wait(
        enqueue_times(lambda: next(it).record(), 3000))
    torch.cuda.synchronize()

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(20):
            one.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(20):
            one.add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    sleep_s(torch, clock, 0.2)
    ts = enqueue_times(graph.replay, 400)
    out["graph_replays_of_20_adds"] = dict(
        count=400, first_wait=first_wait(ts), enqueue_ms=sum(ts) * 1e3)
    torch.cuda.synchronize()

    x = torch.zeros(16 * 2**20, device="cuda")
    for _ in range(10):
        x.mul_(1.0)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sleep_s(torch, clock, 0.05)
    a.record()
    for _ in range(100):
        x.mul_(1.0)
    b.record()
    torch.cuda.synchronize()
    mul_us = a.elapsed_time(b) * 10  # ms over 100 calls -> us a call
    mark = torch.cuda.Event()
    sleep_s(torch, clock, 0.1)
    for _ in range(900):
        x.mul_(1.0)
    mark.record()
    ts = enqueue_times(lambda: x.mul_(1.0), 400)
    pending = not mark.query()
    w = first_wait(ts, 0.01)
    after = sorted(ts[w + 1:]) if w is not None else []
    torch.cuda.synchronize()
    out["full_queue_of_multiplies"] = dict(
        device_us_a_multiply=mul_us,
        mark_behind_900_pending_after_400_more=pending,
        enqueue_us_after_the_wait_median=(
            after[len(after) // 2] * 1e6 if after else None))
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
