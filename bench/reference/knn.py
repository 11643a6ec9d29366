"""Brute-force exact k nearest neighbours under L2, and the distance of
given ids, in float64 on the inputs' device; the control computes the
same top-k at TF32 precision (inputs rounded to TF32's 10-bit mantissa,
float32 sums), the precision a float32 matmul on the card's tensor cores
would use."""
from __future__ import annotations

import torch

from bench.reference.precision import tf32_off


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (to nearest, ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & ~0x1FFF).view(torch.float32)


def exact_topk(db, queries, k: int, block: int = 256, control=False):
    """(ids (Q,k) int64, dists (Q,k)) of the k nearest rows of ``db`` to
    each query, ascending. float64 expansion |x|^2 - 2 x.q + |q|^2 (no
    cancellation at this width); the control in TF32."""
    if control:
        dbc, qc, dt = tf32_round(db), tf32_round(queries), torch.float32
    else:
        dbc, qc, dt = db.double(), queries.double(), torch.float64
    with tf32_off():
        dbc = dbc.to(dt)
        db_sq = (dbc ** 2).sum(1)
        ids, ds = [], []
        for s in range(0, qc.shape[0], block):
            q = qc[s:s + block].to(dt)
            d = db_sq[None, :] - 2.0 * (q @ dbc.T) + (q ** 2).sum(1)[:, None]
            v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
            ids.append(i)
            ds.append(v)
    return torch.cat(ids), torch.cat(ds)


def distances_of(db, queries, ids):
    """(Q,k) float64 squared L2 distance of each query to the rows ``ids``
    (Q,k), summed directly."""
    x = db[ids.clamp(0, db.shape[0] - 1)].double()
    return ((x - queries.double()[:, None, :]) ** 2).sum(-1)
