"""Exact kNN oracle + recall metric (ground truth for all ANN engines).

``exact_knn`` defaults to ``device="cuda"``, like every entry point of
the port: there it computes the blocked distances with ``torch.matmul`` and
``torch.topk`` (ground truth at 10^6 rows on the card). With
``device="cpu"`` it runs the JAX package's numpy path verbatim.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def exact_knn(db: np.ndarray, queries: np.ndarray, k: int,
              metric: str = "l2", block: int = 1024, device="cuda"):
    """Brute-force top-k (k ≤ N). Returns (ids (Q,k), dists (Q,k))."""
    assert k <= db.shape[0], (k, db.shape)
    dev = resolve_device(device)
    if dev.type != "cpu":
        return _exact_knn_torch(db, queries, k, metric, block, dev)
    Q = queries.shape[0]
    ids = np.zeros((Q, k), np.int32)
    dists = np.zeros((Q, k), np.float32)
    db_sq = np.sum(db.astype(np.float32) ** 2, axis=1)
    for s in range(0, Q, block):
        q = queries[s:s + block].astype(np.float32)
        if metric == "l2":
            d = (np.sum(q ** 2, axis=1)[:, None] - 2.0 * q @ db.T + db_sq[None, :])
        elif metric == "ip":
            d = -(q @ db.T)
        else:
            raise ValueError(metric)
        if k < db.shape[0]:
            idx = np.argpartition(d, k, axis=1)[:, :k]
        else:  # k == N: argpartition needs kth < N; every row is top-k
            idx = np.argsort(d, axis=1, kind="stable")

        dd = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(dd, axis=1)
        ids[s:s + block] = np.take_along_axis(idx, order, axis=1)
        dists[s:s + block] = np.take_along_axis(dd, order, axis=1)
    return ids, dists


def _exact_knn_torch(db, queries, k, metric, block, device):
    dbt = torch.as_tensor(db, dtype=torch.float32, device=device)
    qt = torch.as_tensor(queries, dtype=torch.float32, device=device)
    db_sq = (dbt * dbt).sum(1)
    Q = qt.shape[0]
    ids = np.zeros((Q, k), np.int32)
    dists = np.zeros((Q, k), np.float32)
    for s in range(0, Q, block):
        q = qt[s:s + block]
        d = q @ dbt.T
        if metric == "l2":
            d.mul_(-2.0).add_((q * q).sum(1)[:, None]).add_(db_sq[None, :])
        elif metric == "ip":
            d.neg_()
        else:
            raise ValueError(metric)
        top = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids[s:s + block] = top.indices.to(torch.int32).cpu().numpy()
        dists[s:s + block] = top.values.cpu().numpy()
    return ids, dists


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """found/true: (Q, k). Fraction of true neighbors recovered."""
    Q, k = true_ids.shape
    hits = 0
    for i in range(Q):
        hits += len(set(found_ids[i, :k].tolist()) & set(true_ids[i].tolist()))
    return hits / (Q * k)
