#!/usr/bin/env python3
"""Where the port's serving path spends its time on the card: the model of
a serving cell (``chip_smoke.py`` phase 7, phi3-medium-14b; phase 9,
gemma-7b; phase 12, deepseek-moe-16b; phase 13, deepseek-v3-671b cut to
depth 1; phase 16, xlstm-350m; phase 17, seamless-m4t-large-v2 with its
stub frames; phase 18, jamba-1.5-large-398b cut to one group of 8 layers
and 8 experts: full width, bf16, random weights from seed 0, 4 requests of
512 prompt tokens).

    python3 tools/profile_torch_serve.py                   # phi3-serve, one NVIDIA GPU
    python3 tools/profile_torch_serve.py --arch gemma-7b   # gemma-serve
    python3 tools/profile_torch_serve.py --arch deepseek-moe-16b  # deepseek-moe-serve
    python3 tools/profile_torch_serve.py --arch deepseek-v3-671b  # deepseek-v3-L1-serve
    python3 tools/profile_torch_serve.py --arch xlstm-350m  # xlstm-serve
    python3 tools/profile_torch_serve.py --arch seamless-m4t-large-v2  # seamless-serve
    python3 tools/profile_torch_serve.py --arch jamba-1.5-large-398b  # jamba-L8-serve

For one prefill (4 x 512 tokens) and for decode steps at cur_len 512 and
on (the decode loop's new tokens) it prints the host wall per call,
synchronised and unprofiled, then, under ``torch.profiler``, the device
busy share of the window, the kernels launched per call and the kernels
that take the most device time. The traces are written under
``build/profile/`` (not kept in the repository).
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

B, S, NEW = 4, 512, 32


def profile_window(fn, n_calls, name):
    """(device busy share, kernels per call, top kernels by device us per
    call) of ``fn()`` called ``n_calls`` times under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_torch_pool import busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / f"serve_{name}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = Counter()
    for e in kernels:
        by_name[e["name"][:70]] += e["dur"] / n_calls
    return (busy / wall_us, wall_us / n_calls, busy / n_calls,
            len(kernels) / n_calls, by_name.most_common(8))


def report(name, wall_ms, prof):
    share, pwall_us, busy_call_us, k_per_call, top = prof
    print(f"{name}: wall {wall_ms:.3f} ms a call (unprofiled, synchronised) "
          f"| profiled: wall {pwall_us / 1e3:.3f} ms a call, device busy "
          f"{busy_call_us / 1e3:.3f} ms a call = {share:.4f} of the window, "
          f"{k_per_call:.1f} kernels a call | top device time a call: "
          + "; ".join(f"{n} {us:.1f} us" for n, us in top), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-medium-14b",
                    choices=["phi3-medium-14b", "gemma-7b", "deepseek-moe-16b",
                             "deepseek-v3-671b", "xlstm-350m",
                             "seamless-m4t-large-v2", "jamba-1.5-large-398b"],
                    help="the serving cell's model")
    args = ap.parse_args()
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: CUDA is not available")
    cfg = get_config(args.arch)
    if args.arch == "deepseek-v3-671b":  # two layers would not fit in bf16
        cfg = dataclasses.replace(cfg, num_layers=1)
    if args.arch == "jamba-1.5-large-398b":  # one group of 8, 8 experts
        cfg = dataclasses.replace(cfg, num_layers=8, moe=dataclasses.replace(
            cfg.moe, num_experts=8))
    params = model_zoo.init_params(cfg, seed=0, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32), device="cuda")
    batch = {"tokens": prompts}
    if model_zoo.is_encdec(cfg):  # RealServer's stub frames
        batch["frames"] = torch.ones((B, S, cfg.d_model), device="cuda",
                                     dtype=params["embed"].dtype) * 0.1

    def prefill():
        return model_zoo.prefill_fn(cfg, params, batch)

    prefill()  # warm: kernels built, allocator primed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        prefill()
    torch.cuda.synchronize()
    report(f"prefill {B}x{S}", (time.perf_counter() - t0) * 1e3 / 3,
           profile_window(prefill, 1, "prefill"))

    caches = model_zoo.init_decode_caches(cfg, B, S + NEW, device="cuda")
    tok = prompts[:, :1]
    pos = {"cur": S}

    def decode():
        model_zoo.decode_fn(cfg, params, tok, caches, pos["cur"])
        pos["cur"] = S + (pos["cur"] - S + 1) % NEW

    for _ in range(4):
        decode()
    torch.cuda.synchronize()
    n = 2 * NEW
    t0 = time.perf_counter()
    for _ in range(n):
        decode()
    torch.cuda.synchronize()
    report(f"decode step (B={B}, cur_len {S}..{S + NEW - 1})",
           (time.perf_counter() - t0) * 1e3 / n,
           profile_window(decode, 8, "decode"))
    print(cfg.name, torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
