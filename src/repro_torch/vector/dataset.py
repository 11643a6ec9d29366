"""Synthetic embedding datasets for the vector-search pool.

Clustered Gaussians — realistic enough to give graph ANN a non-trivial
recall/latency trade-off (uniform data would make every index look the
same), cheap enough to regenerate in tests.
"""
from __future__ import annotations

import numpy as np


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
