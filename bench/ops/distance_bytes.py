"""Bytes one launch of the distance kernel (B1, ``distance_kernel`` in
``csrc/distance.cu``) has to move: each valid task's id and slot, each
distinct corpus row and query row its valid tasks read, once, and the
(T,) float32 output. Dummy tasks (``task_ids < 0``) read nothing; their
output is written."""
from __future__ import annotations

import torch


def launch_bytes(task_ids, task_slot, dim: int, itemsize: int = 4) -> int:
    ids = task_ids.reshape(-1)
    slots = task_slot.reshape(-1)
    valid = ids >= 0
    n_valid = int(valid.sum())
    rows = int(torch.unique(ids[valid]).numel())
    qrows = int(torch.unique(slots[valid]).numel())
    index_bytes = n_valid * (ids.element_size() + slots.element_size())
    return (rows + qrows) * dim * itemsize + index_bytes + ids.numel() * 4
