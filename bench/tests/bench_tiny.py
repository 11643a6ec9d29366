"""Small stand-ins of the benchmark's cells for the CPU tests: the same
configuration files and traffic mixes with every size cut down."""
from __future__ import annotations

import copy
from contextlib import contextmanager

import torch

from bench import manifest as mf
from bench import runner

MAN = mf.manifest()
SERVE = "jamba2-mini-rag.rag-serve"
POOL = "sift1m-pool.retrieval-backlog"


def serve_cell(dtype="float32", batch=4, capacity_factor=None):
    c = copy.deepcopy(mf.config_file(MAN, "jamba2-mini-rag"))
    c.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_key_value_heads=2, num_experts=4, vocab_size=512,
             mamba_dt_rank=4, max_position_embeddings=256)
    c["assumed"] = dict(c["assumed"], head_dim=16, torch_dtype=dtype)
    if capacity_factor is not None:
        c["assumed"]["capacity_factor"] = capacity_factor
    c["pool"] = {"num_vectors": 500, "dim": 16, "max_requests": 16,
                 "top_m": 16, "task_batch": 512, "visited_slots": 256,
                 "top_k": 5, "corpus_seed": 5}
    t = dict(mf.traffic_file("rag-serve"), batch=batch, max_new=8,
             rag_interval=4, prompt_lengths=[8, 16],
             check={"requests": batch},
             trace={"period_s": 0.2, "active_s": 0.1,
                    "tail_prompt_length": 16})
    return c, t


def pool_cell():
    c = copy.deepcopy(mf.config_file(MAN, "sift1m-pool"))
    c.update(num_vectors=3000, dim=16)
    c["pool"] = dict(c["pool"], max_requests=16, top_m=16, task_batch=512,
                     visited_slots=256, top_k=5)
    t = dict(mf.traffic_file("retrieval-backlog"),
             clients={"prefill": 10, "decode": 22}, query_bank=1024,
             warmup_s=0.2, drain_s=2.0, check={"answers": 64},
             trace={"period_s": 0.2, "active_s": 0.1, "tail_s": 0.5})
    return c, t


@contextmanager
def one_thread():
    """One host thread, as ``run.py`` runs, restored after: the tests run
    beside others in a loaded process, and a pool window in which nothing
    completes has nothing to judge."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run(name, config, traffic, seed=2**31 + 7, seconds=1.0, trace=False):
    """One run of a small cell on the CPU: (result, checks, system run)."""
    cell = mf.cell(MAN, name)
    with one_thread():
        return runner.run_cell(cell, config, traffic,
                               mf.limits_file(cell["config"]),
                               mf.metrics_of(MAN, name, trace), seed,
                               seconds, trace, "cpu")
