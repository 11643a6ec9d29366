"""End-to-end driver: a PD-disaggregated cluster with a Trinity vector pool
serving batched RAG requests — including a mid-run decode-instance failure
and a straggler, to show the fault-tolerance path. The port's counterpart
of the JAX package's ``examples/serve_rag_cluster.py``, with the same
flags and ``--device``.

The vector pool is the port's, on ``--device`` (default ``cuda``; every
retrieval runs the distance kernel there). Prefill, decode and the KV link
are priced by the roofline model on the V5E row, as in the JAX package:
the printed latencies are simulated model times, not times of the card.

  python -m repro_torch.launch.serve_rag_cluster [--placement X] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import VectorPoolConfig
from repro_torch.serving.cluster import ClusterSim
from repro_torch.serving.request import GenRequest
from repro_torch.vector.dataset import make_dataset
from repro_torch.vector.graph import make_cagra_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--placement", default="disaggregated",
                    choices=["coupled", "prefill_coloc", "disaggregated"])
    ap.add_argument("--policy", default="trinity",
                    choices=["trinity", "prefill_first", "decode_first",
                             "fifo_shared"])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--arch", default="deepseek-moe-16b",
                    choices=list_archs())
    ap.add_argument("--device", default="cuda",
                    help="device of the vector pool (cuda or cpu)")
    args = ap.parse_args(argv)

    pool_cfg = VectorPoolConfig(num_vectors=4000, dim=64, max_requests=32,
                                top_m=32, task_batch=1024, visited_slots=512,
                                top_k=10)
    db, _ = make_dataset(pool_cfg.num_vectors, pool_cfg.dim, num_queries=1)
    graph = make_cagra_graph(db, pool_cfg.graph_degree, device=args.device)
    model_cfg = get_config(args.arch)  # timing model uses analytic counts

    sim = ClusterSim(model_cfg, pool_cfg, db, graph,
                     placement=args.placement, policy=args.policy,
                     n_prefill=2, n_decode=4, decode_batch=32,
                     elastic_decode=True, device=args.device)
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(args.requests):
        t += float(rng.exponential(0.05))
        sim.arrive(GenRequest(i, prompt_len=int(rng.integers(512, 4096)),
                              max_new_tokens=64, t_arrival=t,
                              rag_interval=16))

    # fault injection: one decode instance dies, another straggles
    sim.schedule(t * 0.3, sim.kill_decode(0))
    sim.schedule(t * 0.1, sim.set_decode_slowdown(1, 8.0))

    sim.run(t + 120.0)
    s = sim.metrics.summary(t + 120.0)
    print(f"placement={args.placement} policy={args.policy} "
          f"arch={args.arch} device={sim.vector_pool.device}")
    for k, v in s.items():
        print(f"  {k:20s}: {v:.4g}" if isinstance(v, float) else
              f"  {k:20s}: {v}")
    vec = sim.vector_pool.metrics
    print(f"  retrieval p50/p95   : {vec.p(50)*1e3:.2f} / "
          f"{vec.p(95)*1e3:.2f} ms (simulated, V5E-priced) over "
          f"{len(vec.completed)} probes")
    print(f"  kv link utilisation : {sim.kv_link.utilization(sim.t_now):.2f}")
    assert s["requests"] == args.requests, "fault recovery failed"
    print("all requests completed despite failure + straggler")
    return s


if __name__ == "__main__":
    main()
