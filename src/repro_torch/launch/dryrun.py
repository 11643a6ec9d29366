"""Multi-pod dry run: trace every (architecture × shape × mesh) cell's step
on the production mesh with meta stand-ins (nothing allocated, nothing
drawn), and record the per-device counts, the memory the step would hold
and the collective schedule (the JAX package's ``launch/dryrun.py``, same
CLI).

Parameters, optimizer state and inputs are meta ``DTensor``s on a mesh of
the production shape over PyTorch's fake process group
(``launch/mesh.py::planning_mesh``), laid out by the sharding rules
(``distributed/sharding.py``). The step runs eagerly under
``activation_sharding`` (the model's ``constrain`` calls pin the
reference's layouts) and ``launch/cost.py``'s counter, which counts each
op on its local shards: the counts are rank 0's, per device. Where the
reference lowers and compiles, the port traces: ``compile_s`` is null, and
the HLO-only pieces have no counterpart (``collective_bytes(hlo_text)``,
XLA's raw ``cost_analysis``, the generated code size). The roofline terms
are priced on an NVIDIA H100 (its data sheet at its 700 W limit), never on
a TPU: parity with the reference is held on counts, not seconds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.distributed import sharding as shard
from repro_torch.launch import mesh as meshes
from repro_torch.launch.cost import CostCounter
from repro_torch.models import model_zoo
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

# the card the roofline terms are priced on: NVIDIA's H100 SXM data sheet
# (dense bf16 tensor cores, HBM3, NVLink each way), at its 700 W limit
H100 = {"card": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
        "peak_flops": 989e12, "hbm_bytes_per_s": 3.35e12,
        "link_bytes_per_s": 450e9}
# a cell's trace longer than this records a TimeoutError naming the op it
# reached: the recurrent families' per-position loops (the mamba scan, the
# sLSTM) run eagerly op by op over DTensors, hours at 4k-32k positions
TRACE_BUDGET_S = 1200.0
VARIANTS = ["baseline", "seqshard", "seqpar", "micro1", "micro2",
            "seqshard_repl"]


def num_microbatches_for(cfg, shape, variant: str = "baseline") -> int:
    if shape.kind != "train":
        return 1
    if variant == "micro1":
        return 1
    if variant == "micro2":
        return 2
    if cfg.d_model >= 7000:
        return 16
    if cfg.d_model >= 4000:
        return 8
    return 4


def _distribute(tree, specs, device_mesh):
    """Meta DTensors of ``tree``'s leaves laid out by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        return distribute_tensor(t, device_mesh,
                                 shard.placements(spec, device_mesh))

    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], device_mesh)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute(v, s, device_mesh) for v, s in zip(tree, specs)]
    return one(tree, specs)


def build_step(cfg, shape, device_mesh, variant: str = "baseline"):
    """Returns (fn, args) for the cell: ``fn(*args)`` is one step on meta
    DTensors laid out on ``device_mesh``.

    variants:
      baseline — the sharding rules, DTensor's propagation between them
      seqshard — decode attention over this rank's shard of the
                 sequence-sharded cache, combined over "model"
      seqpar   — prefill/train attention's query rows split 16 ways on
                 "model" (set by ``run_cell``'s context)
      micro1 / micro2 — one or two microbatches a train step
    """
    specs = model_zoo.input_specs(cfg, shape)
    params_meta = model_zoo.param_specs(cfg)
    params = _distribute(params_meta,
                         shard.param_shardings(params_meta, device_mesh),
                         device_mesh)

    if shape.kind == "train":
        batch = _distribute(specs, shard.data_shardings(specs, device_mesh),
                            device_mesh)
        fn = make_train_step(cfg, AdamWConfig(),
                             num_microbatches_for(cfg, shape, variant))
        return fn, (params, init_opt_state(params), batch)

    if shape.kind == "prefill":
        batch = _distribute(specs, shard.data_shardings(specs, device_mesh),
                            device_mesh)

        def prefill(params, batch):
            return model_zoo.prefill_fn(cfg, params, batch)

        return prefill, (params, batch)

    # decode: the token's position is the cache's last (a host int in the
    # port; the reference traces an abstract one), so every position attends
    token = _distribute(specs["token"], shard.batch_spec_for(
        tuple(specs["token"].shape), device_mesh), device_mesh)
    caches = _distribute(specs["caches"],
                         shard.cache_shardings(specs["caches"], device_mesh),
                         device_mesh)
    seq_axis = "model" if variant == "seqshard" else None

    def decode(params, token, caches, cur_len):
        return model_zoo.decode_fn(cfg, params, token, caches, cur_len,
                                   seq_axis=seq_axis)

    return decode, (params, token, caches, shape.seq_len - 1)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for _, leaf in shard._walk(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def trace_cell(cfg, shape, abstract, variant: str = "baseline") -> dict:
    """Trace one cell's step on a planning mesh of ``abstract``'s shape.
    Returns the per-device counts and memory; an exception propagates with
    ``op`` (the ATen op that raised) set on it."""
    from torch.distributed.tensor.experimental import implicit_replication

    device_mesh = meshes.planning_mesh(abstract)
    t0 = time.time()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    fn, args = build_step(cfg, shape, device_mesh, variant=variant)
    t_build = time.time() - t0  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    seq_par = 16 if variant == "seqpar" else 0
    counter = CostCounter(deadline=time.monotonic() + TRACE_BUDGET_S,  # repro-analyze: disable=DET002 (the dry run's trace budget, not sim time)
                          device="meta")
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    fallbacks = shard.reshard_fallbacks()
    try:
        with shard.activation_sharding(device_mesh, seq_parallel=seq_par), \
                implicit_replication(), grad, counter, fallbacks:
            out = fn(*args)
    except Exception as e:  # noqa: BLE001 — name the op, then re-raise
        e.op = str(counter.last_op)
        e.fallbacks = dict(fallbacks.fired)
        raise
    t_trace = time.time() - t0 - t_build  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    totals = counter.totals()
    return {"devices": abstract.size, "build_s": t_build, "trace_s": t_trace,
            "flops": float(totals["flops"]),
            "bytes_accessed": float(totals["bytes_accessed"]),
            "collective_bytes": {k: float(v) for k, v in
                                 totals["collective_bytes"].items()},
            "argument_size": _local_bytes(args),
            "output_size": _local_bytes(out),
            "temp_size": totals["peak_bytes"],
            # the most temp_size may exceed the unrolled loops' (cost.py)
            "temp_slack": totals["held_bytes"],
            "fallbacks": dict(fallbacks.fired)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             results_dir: str = RESULTS_DIR, variant: str = "baseline") -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    os.makedirs(results_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    out_path = os.path.join(results_dir,
                            f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "status": "error"}
    t0 = time.time()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    try:
        c = trace_cell(cfg, shape, meshes.make_production_mesh(
            multi_pod=multi_pod), variant=variant)
        n_dev = c["devices"]
        coll = c["collective_bytes"]
        model_fl = model_zoo.model_flops(cfg, shape)
        terms = {"compute_s": c["flops"] / H100["peak_flops"],
                 "memory_s": c["bytes_accessed"] / H100["hbm_bytes_per_s"],
                 "collective_s": coll.get("total", 0.0)
                 / H100["link_bytes_per_s"]}
        bottleneck = max(terms, key=terms.get)
        rec.update({
            "status": "ok",
            "devices": n_dev,
            "lower_s": round(c["build_s"] + c["trace_s"], 2),
            "compile_s": None,  # eager: nothing is compiled
            "trace_s": round(c["trace_s"], 2),
            "per_device": {
                "flops": c["flops"],
                "bytes_accessed": c["bytes_accessed"],
                "collective_bytes": coll,
                "xla_cost_analysis_raw": None,  # no HLO in eager PyTorch
            },
            "memory_analysis": {
                "argument_size": c["argument_size"],
                "output_size": c["output_size"],
                "temp_size": c["temp_size"],
                "generated_code_size": None,
            },
            "roofline": {
                **terms,
                "bottleneck": bottleneck,
                "hardware": H100,
                "model_flops_global": model_fl,
                "hlo_flops_global": c["flops"] * n_dev,
                "useful_fraction": model_fl / max(c["flops"] * n_dev, 1.0),
            },
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
            # reshard_fallbacks that fired, by op: views regathered, ops
            # with no sharding strategy run replicated (counted above)
            "fallbacks": c["fallbacks"],
        })
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["op"] = getattr(e, "op", None)
        rec["fallbacks"] = getattr(e, "fallbacks", None)
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every applicable (arch × shape) cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in list_archs():
            for shp in shapes_for(get_config(arch)):
                cells.append((arch, shp.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes_ = [args.multi_pod]
    if args.both_meshes:
        meshes_ = [False, True]

    n_ok = 0
    for arch, shp in cells:
        for mp in meshes_:
            rec = run_cell(arch, shp, mp, force=args.force,
                           results_dir=args.results_dir,
                           variant=args.variant)
            tag = f"{arch} × {shp} × {'2x16x16' if mp else '16x16'}"
            if rec["status"] == "ok":
                n_ok += 1
                r, pd = rec["roofline"], rec["per_device"]
                print(f"[OK  {rec['wall_s']:7.1f}s] {tag}: flops "
                      f"{pd['flops']:.4e} bytes {pd['bytes_accessed']:.4e} "
                      f"collective {pd['collective_bytes']['total']:.4e} | "
                      f"H100-priced compute {r['compute_s']:.3e}s mem "
                      f"{r['memory_s']:.3e}s coll {r['collective_s']:.3e}s "
                      f"-> {r['bottleneck']} (useful "
                      f"{r['useful_fraction']:.2f})", flush=True)
            else:
                print(f"[FAIL {rec['wall_s']:6.1f}s] {tag}: op {rec['op']}: "
                      f"{rec['error'][:300]}", flush=True)
    print(f"done: {n_ok} ok / {len(cells) * len(meshes_)} cells")


if __name__ == "__main__":
    main()
