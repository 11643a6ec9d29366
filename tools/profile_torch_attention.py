#!/usr/bin/env python3
"""Device time of the port's attention kernels (B3 prefill, B4 decode) at
the shapes of ``chip_smoke.py``'s phase 6, beside one PyTorch call for the
same function (``scaled_dot_product_attention``), on one NVIDIA GPU.

    python3 tools/profile_torch_attention.py                  # this tree
    python3 tools/profile_torch_attention.py --src OTHER/src --label old

``--src`` points at the ``src`` directory of another checkout of the repo
(for example a ``git archive`` of a parent commit unpacked under a
directory ``.gitignore`` lists), so two versions of the kernels can be
timed in turns inside one process tree on one card: old, new, new, old.
Each run prints one JSON line: the card, its power limit, and per case the
kernel's median device time per call (CUDA events, the stream held by a
sleep kernel while the host enqueues), the B3 variant it ran, and SDPA's
time. A prefill case is bf16 or f32, on contiguous tensors or on views of
one fused projection whose row stride TMA cannot take (``view``).

Decode is timed warm (one (q, k, v) set, whose cache of 11 MB (phi3) or
36 MB (gemma-7b) stays in the 50 MB L2 across calls) and cold (calls
rotate over 10 sets, 111 or 357 MB, so each call finds its cache in HBM,
as every layer of a decode step does),
each call both launched directly and replayed from a CUDA graph of it.
SDPA's decode call (a masked product with a few kernels) is timed from its
graph only, so the host's gaps between its kernels stay out of the time.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_ms, graph_ms, prefill_inputs  # noqa: E402

# B, S, H, Hkv, hd, dtype, view: phi3's serving shape and its neighbours,
# internvl2's heads, gemma-7b's heads at S = 512 (its serving prefill) and
# 2048 (the wgmma variants); gemma-7b's heads through an unaligned view and
# hd 32 (flash_mma); phi3's and internvl2's heads in float32 (flash_fp32)
FLASH_CASES = [(4, 512, 40, 10, 128, "bf16", False),
               (4, 2048, 40, 10, 128, "bf16", False),
               (4, 1000, 40, 10, 128, "bf16", False),
               (4, 512, 14, 2, 64, "bf16", False),
               (4, 512, 16, 16, 256, "bf16", False),
               (4, 2048, 16, 16, 256, "bf16", False),
               (4, 512, 16, 16, 256, "bf16", True),
               (4, 2048, 16, 16, 32, "bf16", False),
               (4, 2048, 16, 16, 32, "bf16", True),
               (4, 512, 40, 10, 128, "f32", False),
               (4, 2048, 40, 10, 128, "f32", False),
               (4, 512, 14, 2, 64, "f32", False)]
# (B, S_max, H, Hkv, hd), cur_len values: phi3's and gemma-7b's serving
# caches (S_max = 512 + 32)
DECODE_CASES = [((4, 544, 40, 10, 128), (271, 543)),
                ((4, 544, 16, 16, 256), (543,))]
COLD_SETS = 10


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's src
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (CUDA is not available)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 SDPA in full float32

    def randn(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    res = {"label": args.label, "src": args.src, "card": smi,
           "flash": [], "decode": []}
    for i, (B, S, H, Hkv, hd, dt, view) in enumerate(FLASH_CASES):
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        qkv = [prefill_inputs(B, S, H, Hkv, hd, dtype, view, 3 * i)]
        n = 20 if S > 1000 else 60

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        before = dict(flash_attention.launches)
        ms = device_ms(flash_attention.flash_attention, qkv, n, 500_000_000)[0]
        ran = [k for k, c in flash_attention.launches.items()
               if k != "flash_attention" and c > before.get(k, 0)]
        res["flash"].append(dict(shape=[B, S, H, Hkv, hd], dtype=dt, view=view, ms=ms,
                                 sdpa_ms=device_ms(sdpa, qkv, n, 500_000_000)[0],
                                 variant=ran))
        del qkv
    for (B, S, H, Hkv, hd), curs in DECODE_CASES:
        decode_rows(res, randn, B, S, H, Hkv, hd, curs, dev)
    print(json.dumps(res))


def decode_rows(res, randn, B, S, H, Hkv, hd, curs, dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention

    sets = [(randn((B, H, hd), 100 + j), randn((B, S, Hkv, hd), 200 + j),
             randn((B, S, Hkv, hd), 300 + j)) for j in range(COLD_SETS)]
    for cur in curs:
        mask = (torch.arange(S, device=dev) <= cur)[None, None, None, :]

        def sdpa(q, k, v, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)[:, :, 0]

        def kern(q, k, v, cur=cur):
            return decode_attention.decode_attention(q, k, v, cur)

        row = dict(shape=[B, S, H, Hkv, hd], cur_len=cur)
        for temp, group in (("warm", sets[:1]), ("cold", sets)):
            row[temp + "_ms"] = device_ms(kern, group, 400, 1_000_000_000)[0]
            row[temp + "_graph_ms"] = graph_ms(kern, group, 400, 1_000_000_000)[0]
            row[temp + "_sdpa_ms"] = graph_ms(sdpa, group, 400, 1_000_000_000)[0]
        res["decode"].append(row)


if __name__ == "__main__":
    main()
