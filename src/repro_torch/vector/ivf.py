"""IVF-flat baseline (paper §1: 'production systems adopt IVF/IMI …').

Coarse k-means quantizer + inverted lists; a query scans its ``nprobe``
nearest lists exactly. Fixed-shape layout (padded lists).

``kmeans`` is the JAX package's numpy code verbatim, so a partition built
here equals the JAX package's bit for bit. ``centroid_distances``,
``coarse_probe`` and the batched IVF scan are torch ops on their tensors'
device; selections break ties to the lower index, as ``jax.lax.top_k``
does (``vector/cagra.py::smallest_k``). The sharded index's router
(``vector/shards.py``) reuses ``centroid_distances`` and ``kmeans``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.vector.cagra import smallest_k


def kmeans(db: np.ndarray, nlist: int, iters: int = 10, seed: int = 0):
    """Lloyd's k-means over ``db``. Returns (centroids (nlist, d) f32,
    assign (N,) int64 — nearest-centroid assignment after the last step)."""
    N, _ = db.shape
    rng = np.random.default_rng(seed)
    centroids = db[rng.choice(N, nlist, replace=False)].astype(np.float32)
    dbf = db.astype(np.float32)
    for _ in range(iters):
        d2 = (np.sum(dbf ** 2, 1)[:, None]
              - 2 * dbf @ centroids.T + np.sum(centroids ** 2, 1)[None])
        assign = np.argmin(d2, 1)
        for c in range(nlist):
            members = dbf[assign == c]
            if len(members):
                centroids[c] = members.mean(0)
    d2 = (np.sum(dbf ** 2, 1)[:, None]
          - 2 * dbf @ centroids.T + np.sum(centroids ** 2, 1)[None])
    return centroids, np.argmin(d2, 1)


def centroid_distances(centroids, queries):
    """Batched query→centroid squared distances (Q, S) — the shared body
    of the coarse quantizer and the sharded router's fine-centroid scoring.
    Tensors in, a tensor out, on their device."""
    q = queries.float()
    c = centroids.float()
    return ((q * q).sum(1)[:, None] - 2.0 * q @ c.T
            + (c * c).sum(1)[None])


def coarse_probe(centroids, queries, *, nprobe: int):
    """The ``nprobe`` nearest centroids per query, nearest first:
    (probe_ids (Q, nprobe) int32, probe_d2 (Q, nprobe) float32)."""
    d2, ids = smallest_k(centroid_distances(centroids, queries), nprobe)
    return ids.to(torch.int32), d2


def _ivf_search_batched(db, centroids, list_ids, queries, *, k: int,
                        nprobe: int):
    """Batched IVF scan: coarse probe + exact scan of the probed lists.
    Returns (ids (Q, k), dists (Q, k), rows_scanned (Q,)) tensors."""
    q = queries.float()
    probe, _ = coarse_probe(centroids, q, nprobe=nprobe)  # (Q, nprobe)
    Q = q.shape[0]
    cand = list_ids[probe.long()].reshape(Q, -1)  # (Q, nprobe*max_len)
    x = db[cand.long().clamp(min=0)]  # (Q, P, d)
    dist = ((x - q[:, None, :]) ** 2).sum(-1)
    dist = torch.where(cand >= 0, dist, float("inf"))
    best, sel = smallest_k(dist, k)
    return cand.gather(1, sel), best, (cand >= 0).sum(1)


class IVFFlat:
    """IVF-flat index on ``device`` (default ``"cuda"``)."""

    def __init__(self, db: np.ndarray, nlist: int = 64, iters: int = 10,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        centroids, assign = kmeans(db, nlist, iters=iters, seed=seed)
        self.centroids = torch.as_tensor(centroids, device=self.device)
        max_len = max(int((assign == c).sum()) for c in range(nlist))
        ids = np.full((nlist, max_len), -1, np.int32)
        for c in range(nlist):
            members = np.nonzero(assign == c)[0]
            ids[c, :len(members)] = members
        self.list_ids = torch.as_tensor(ids, device=self.device)
        self.db = torch.as_tensor(np.asarray(db, np.float32),
                                  device=self.device)
        self.nlist = nlist

    def search(self, queries: np.ndarray, k: int = 10, nprobe: int = 8):
        """Returns host arrays (ids (Q,k), dists (Q,k), rows_scanned (Q,))."""
        ids, dists, rows = _ivf_search_batched(
            self.db, self.centroids, self.list_ids,
            torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device), k=k, nprobe=nprobe)
        return ids.cpu().numpy(), dists.cpu().numpy(), rows.cpu().numpy()
