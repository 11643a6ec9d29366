"""Device dispatcher for the distance stage (the JAX package's
``kernels/ops.py::distance_tasks``, same signature).

CUDA tensors go to the Hopper kernels; CPU tensors go to the plain-PyTorch
versions. There is no fallback: a CUDA tensor never reaches the plain
version, and a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from repro_torch.kernels import distance as _dist
from repro_torch.kernels import ref as _ref

MODES = ("slot_gather", "matmul_onehot")


def distance_tasks(db, queries, task_ids, task_slot, metric: str = "l2",
                   task_block: int = 256, mode: str = "slot_gather"):
    """Fixed-shape distance stage: (T,) float32, dummies (id −1) = 1e30.

    db (N,d) · queries (R,d) · task_ids/task_slot (T,) int32 with
    T % task_block == 0 (the engine pads with dummies). ``task_block`` is
    the TPU kernel's tile and is kept as the same contract; the CUDA
    kernels run one warp per task whatever its value."""
    T = task_ids.shape[0]
    if task_block <= 0 or T % task_block:
        raise ValueError(f"T={T} must be a multiple of task_block="
                         f"{task_block}")
    if mode not in MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    if db.device.type == "cuda":
        kernel = (_dist.distance_slot_gather if mode == "slot_gather"
                  else _dist.distance_onehot)
        return kernel(db, queries, task_ids, task_slot, metric=metric)
    if db.device.type != "cpu":
        raise ValueError(f"unsupported device {db.device}")
    plain = (_ref.distance_tasks_ref if mode == "slot_gather"
             else _ref.distance_tasks_onehot_ref)
    return plain(db, queries, task_ids, task_slot, metric=metric)
