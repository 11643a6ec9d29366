"""Real-compute serving driver: a miniature Trinity deployment on one
device — real model prefill/decode (greedy) + real vector search through
the continuous-batching pool, PD-disaggregated at the process level
(prefill and decode are separate steps exchanging KV caches, the vector
pool serves both through the lane scheduler). The JAX package's
``launch/serve.py`` on PyTorch: on the card, prefill runs the
flash-attention kernel once per layer, every decoded token the
decode-attention kernel once per layer, and every retrieval the distance
kernel.

``python -m repro_torch.launch.serve --arch internvl2-1b --requests 8``
(smoke config; ``--device`` defaults to ``cuda``, ``--device cpu`` runs the
plain PyTorch path)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.configs.base import VectorPoolConfig
from repro_torch.core.scheduler import VectorRequest
from repro_torch.core.trinity_pool import VectorPool
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.transformer import DTYPES
from repro_torch.vector.dataset import make_dataset
from repro_torch.vector.graph import make_cagra_graph


class RealServer:
    """Prefill pool + decode pool + Trinity vector pool, real compute.

    ``params`` (optional) are the port's model parameters on ``device``
    (e.g. ``convert.lm_params_from_numpy`` of another run's weights);
    without them the weights are random from ``seed``."""

    def __init__(self, cfg, pool_cfg, *, rag_interval: int = 8, seed: int = 0,
                 device="cuda", params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else model_zoo.init_params(cfg, seed, self.device))
        db, _ = make_dataset(pool_cfg.num_vectors, pool_cfg.dim,
                             num_queries=1, seed=seed)
        graph = make_cagra_graph(db, pool_cfg.graph_degree, seed=seed,
                                 device=self.device)
        self.pool = VectorPool(pool_cfg, db, graph, policy="trinity",
                               device=self.device)
        self.rag_interval = rag_interval
        self.pool_cfg = pool_cfg
        self._prefill = lambda p, b: model_zoo.prefill_fn(cfg, p, b)
        self._decode = lambda p, tok, c, n: model_zoo.decode_fn(cfg, p, tok,
                                                                 c, n)
        self._clock = 0.0
        self._rid = 0

    def _retrieve(self, kind: str, qvec) -> np.ndarray:
        """Submit one retrieval through the scheduler and drain the pool."""
        self._rid += 1
        ddl = self._clock + self.pool_cfg.prefill_deadline_ms / 1e3
        req = VectorRequest(self._rid, kind, qvec, self._clock, ddl)
        self.pool.submit(req)
        # advance pool sim-time until this request completes
        for _ in range(512):
            self._clock += 2e-4
            self.pool.run_until(self._clock)
            if req.t_completed is not None:
                return req.result_ids
        raise RuntimeError("retrieval did not complete")

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=self.device)

    def generate(self, prompts: np.ndarray, max_new: int = 16):
        """prompts: (B, S) int32. Greedy decode with periodic RAG probes.
        Returns (tokens (B, max_new), stats)."""
        B, S = prompts.shape
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        t0 = time.time()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
        # prefill-side RAG: one retrieval per request (context injection)
        rng = np.random.default_rng(0)
        for b in range(B):
            self._retrieve("prefill",
                           self.pool.db[rng.integers(len(self.pool.db))])
        batch = {"tokens": self._tokens(prompts)}
        if model_zoo.is_encdec(self.cfg):
            # the stub frontend's frames, in the model's dtype (the
            # reference's float32 frames make its bfloat16 prefill raise)
            batch["frames"] = torch.ones(
                (B, S, self.cfg.d_model), dtype=DTYPES[self.cfg.dtype],
                device=self.device) * 0.1
        elif self.cfg.frontend_tokens > 0:
            batch["frontend"] = torch.ones(
                (B, self.cfg.frontend_tokens, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        logits, _ = self._prefill(self.params, batch)
        sync()
        ttft = time.time() - t0  # repro-analyze: disable=DET002 (wall-clock reporting of real work)

        # decode pool consumes the transferred caches (fresh max-len caches
        # seeded by re-running prefill into them token-by-token is wasteful;
        # production transfers pages — here we re-prefill into a decode-side
        # cache, as the JAX package's server does; under encdec its cross
        # ck/cv stay zero, as there)
        max_len = S + max_new
        caches = model_zoo.init_decode_caches(self.cfg, B, max_len,
                                              self.device)
        for i in range(S):
            _, caches = self._decode(self.params, self._tokens(prompts[:, i:i + 1]),
                                     caches, i)
        out = []
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        stalls = 0
        for step in range(max_new):
            if self.rag_interval and step and step % self.rag_interval == 0:
                # decode-side RAG probe for request 0 (demo)
                self._retrieve("decode", np.asarray(
                    self.pool.db[step % len(self.pool.db)]))
                stalls += 1
            lg, caches = self._decode(self.params, tok, caches, S + step)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            out.append(tok.cpu().numpy()[:, 0])
        toks = np.stack(out, axis=1)
        decode_s = time.time() - t0 - ttft  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
        return toks, {"ttft_s": ttft, "decode_s": decode_s,
                      "rag_probes": len(self.pool.metrics.completed),
                      "rag_p95_ms": self.pool.metrics.p(95) * 1e3,
                      "stalls": stalls}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="internvl2-1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    pool_cfg = VectorPoolConfig(num_vectors=2000, dim=64, max_requests=16,
                                top_m=16, task_batch=512, visited_slots=256,
                                top_k=5)
    server = RealServer(cfg, pool_cfg, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len)).astype(np.int32)
    toks, stats = server.generate(prompts, max_new=args.max_new)
    print("generated tokens (first request):", toks[0].tolist())
    for k, v in stats.items():
        print(f"  {k}: {v:.4g}" if isinstance(v, float) else f"  {k}: {v}")


if __name__ == "__main__":
    main()
