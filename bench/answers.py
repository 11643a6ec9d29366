"""Judging retrieval answers against the brute-force reference: each
answer's distances against its ids' own distances, its recall against
exact search, and its form (k distinct ids in range, ascending)."""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import knn


def judge(db, queries, ids, dists, k: int) -> dict:
    """db (N,d) and queries (Q,d) float32 tensors on one device; ids and
    dists (Q,k) numpy, as answered. Returns {"dist_err": the widest gap
    of an answered distance to its id's float64 distance, over the median
    of those distances (a query that is itself a row has distance 0),
    "recall": mean recall@k against exact float64 search, "malformed": answers not of k distinct ids in range, in
    ascending order}."""
    dev = db.device
    ids = np.asarray(ids)
    dists = np.asarray(dists, np.float64)
    n = db.shape[0]
    bad = (ids.shape[1] != k) | (ids < 0).any(1) | (ids >= n).any(1)
    bad |= np.array([len(set(r.tolist())) != len(r) for r in ids])
    bad |= (np.diff(dists, axis=1) < 0).any(1) | ~np.isfinite(dists).all(1)
    ids_t = torch.as_tensor(ids.astype(np.int64), device=dev)
    true_d = knn.distances_of(db, queries, ids_t).cpu().numpy()
    err = np.abs(dists - true_d) / np.median(true_d)
    exact, _ = knn.exact_topk(db, queries, k)
    exact = exact.cpu().numpy()
    hits = [len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, exact)]
    return {"dist_err": float(err.max()), "recall": float(np.mean(hits)) / k,
            "malformed": int(bad.sum())}


def control_answers(db, queries, k: int):
    """The control in the program's place: exact top-k at TF32."""
    ids, dists = knn.exact_topk(db, queries, k, control=True)
    return ids.cpu().numpy(), dists.float().cpu().numpy()
