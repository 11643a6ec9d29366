"""Inputs made from the seed: corpora, queries and sub-seeds.

``make_dataset`` is a copy of the port's ``vector/dataset.py`` generator
(clustered Gaussians), kept here so that a program change cannot move
the yardstick: with the same arguments it gives the same bits as the
port's, which is how the serving cell's reference rebuilds the corpus
``RealServer`` draws for its pool. ``device_corpus`` draws the same
distribution on the card in a few large calls, for a corpus of 10^6
rows.
"""
from __future__ import annotations

import numpy as np
import torch


def subseeds(seed: int, n: int) -> list:
    """``n`` 31-bit seeds derived from any whole ``seed`` (the driver's
    exceed 32 signed bits)."""
    ss = np.random.SeedSequence(int(seed) & ((1 << 128) - 1))
    return [int(x) & 0x7FFFFFFF for x in ss.generate_state(n, np.uint32)]


def make_dataset(num_vectors: int, dim: int, num_clusters: int = 64,
                 seed: int = 0, num_queries: int = 256):
    """Returns (db (N,d) f32, queries (Q,d) f32)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, size=(num_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, num_clusters, size=num_vectors)
    db = centers[assign] + rng.normal(0, 0.35, size=(num_vectors, dim))
    q_assign = rng.integers(0, num_clusters, size=num_queries)
    queries = centers[q_assign] + rng.normal(0, 0.35, size=(num_queries, dim))
    return db.astype(np.float32), queries.astype(np.float32)


def device_corpus(n: int, dim: int, clusters: int, noise: float,
                  seed: int, device) -> tuple:
    """(centres (C,d), db (n,d)) float32 on ``device``: centres N(0, 1),
    each row a uniformly chosen centre plus N(0, noise^2)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = torch.randn((clusters, dim), generator=gen, device=device)
    assign = torch.randint(0, clusters, (n,), generator=gen, device=device)
    db = torch.randn((n, dim), generator=gen, device=device).mul_(noise)
    db.add_(centres[assign])
    return centres, db


def device_queries(centres, m: int, noise: float, seed: int) -> np.ndarray:
    """(m, d) float32 on the host: a uniformly chosen centre plus
    N(0, noise^2), drawn on the centres' device."""
    dev = centres.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    assign = torch.randint(0, centres.shape[0], (m,), generator=gen,
                           device=dev)
    q = torch.randn((m, centres.shape[1]), generator=gen, device=dev)
    return q.mul_(noise).add_(centres[assign]).cpu().numpy()
