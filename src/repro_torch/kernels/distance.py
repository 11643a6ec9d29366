"""The engine's fixed-shape distance stage as hand-written Hopper kernels.

Paper §3.2: all surviving (request, candidate) pairs from one *extend* step
are flattened into a single fixed-shape task array and evaluated by ONE
kernel launch; short batches are padded with masked dummies (id −1) so the
operator shape never changes.

Two kernels in ``csrc/distance.cu`` (its header gives the design and the
bound on the card), one per ``VectorPoolConfig.distance_mode``:

  ``distance_slot_gather``  replaces the TPU kernel
                            ``repro/kernels/distance.py::_distance_kernel_gather``
  ``distance_onehot``       replaces the TPU kernel
                            ``repro/kernels/distance.py::_distance_kernel``

Each kernel has a native lane dimension: ``*_group`` takes G lanes, each
with its own db and queries, in one launch (the counterpart of the
``jax.vmap`` over shard replicas in the JAX package's megabatched path).
The (T,) wrappers launch the same kernel with G = 1, through views.

Their plain-PyTorch versions are ``kernels/ref.py::distance_tasks_ref`` and
``distance_tasks_onehot_ref`` (``*_group_ref`` for the lane form). The
wrappers below take CUDA tensors only: they check every input, allocate the
output with ``torch.empty``, launch on the current stream without
synchronising, raise on a launch error, and count their launches in
``launches`` (one a launch, whatever G) and in ``lane_launches`` by G.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel name -> launches since the last reset (read by chip_smoke.py to
# prove the main path went through the kernels)
launches = {"distance_slot_gather": 0, "distance_onehot": 0}
# kernel name -> {G: launches over G lanes} since the last reset (shows that
# a megabatched path's launches are grouped, and at which G)
lane_launches = {name: {} for name in launches}

_ENTRY = {"distance_slot_gather": "repro_distance_slot_gather",
          "distance_onehot": "repro_distance_onehot"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1
_bound = {}  # kernel name -> its ctypes entry point, typed once


def _entry(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load("distance"), _ENTRY[name])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        lane_launches[name].clear()


def check_inputs(db, queries, task_ids, task_slot, metric: str) -> None:
    """Raise ValueError on anything the kernels do not take. One engine:
    db (N, d) and queries (R, d) contiguous float32, task_ids/task_slot (T,)
    contiguous int32. G lanes: db (G, N, d), queries (G, R, d), task_ids/
    task_slot (G, T), one G across all four. All on one device, metric
    ``l2`` or ``ip``. The kernels never cast or copy ``db`` (at 10^6 x 128 a
    copy per call would move 512 MB)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric!r}")
    lanes = int(db.dim() == 3)
    for name, t, dtype, ndim in (("db", db, torch.float32, 2 + lanes),
                                 ("queries", queries, torch.float32, 2 + lanes),
                                 ("task_ids", task_ids, torch.int32, 1 + lanes),
                                 ("task_slot", task_slot, torch.int32, 1 + lanes)):
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if t.device != db.device:
            raise ValueError(f"{name} is on {t.device}, db on {db.device}")
    if lanes and len({db.shape[0], queries.shape[0], task_ids.shape[0],
                      task_slot.shape[0]}) != 1:
        raise ValueError(f"lanes differ: db {tuple(db.shape)}, queries "
                         f"{tuple(queries.shape)}, task_ids "
                         f"{tuple(task_ids.shape)}, task_slot "
                         f"{tuple(task_slot.shape)}")
    if queries.shape[-1] != db.shape[-1]:
        raise ValueError(f"queries dim {queries.shape[-1]} != db dim "
                         f"{db.shape[-1]}")
    if task_slot.shape != task_ids.shape:
        raise ValueError(f"task_slot {tuple(task_slot.shape)} != task_ids "
                         f"{tuple(task_ids.shape)}")
    if min(db.shape[-2], queries.shape[-2], db.shape[-1]) == 0:
        raise ValueError("db and queries must be non-empty")
    G = db.shape[0] if lanes else 1
    if max(G * task_ids.shape[-1], G * queries.shape[-2], db.shape[-1]) > _INT_MAX:
        raise ValueError("G*T, G*R and d must fit in int32")


def _check(name: str, db, queries, task_ids, task_slot, metric: str,
           ndim: int) -> None:
    check_inputs(db, queries, task_ids, task_slot, metric)
    if db.dim() != ndim:
        form = "(N, d)" if ndim == 2 else "(G, N, d)"
        raise ValueError(f"db must be {form} here, got {tuple(db.shape)}")
    if db.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {db.device}")


def _launch(name: str, dbs, queries, task_ids, task_slot, metric: str):
    """One launch over G lanes of checked inputs: dbs (G, N, d) ... ->
    (G, T)."""
    G, T = task_ids.shape
    out = torch.empty((G, T), dtype=torch.float32, device=dbs.device)
    if G * T == 0:
        return out
    fn = _entry(name)
    with torch.cuda.device(dbs.device):
        err = fn(dbs.data_ptr(), G, dbs.shape[1], dbs.shape[2],
                 queries.data_ptr(), queries.shape[1], task_ids.data_ptr(),
                 task_slot.data_ptr(), out.data_ptr(), T, int(metric == "l2"),
                 torch.cuda.current_stream(dbs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    lane_launches[name][G] = lane_launches[name].get(G, 0) + 1
    return out


def _launch_one(name: str, db, queries, task_ids, task_slot, metric: str):
    """The (T,) call: the lane kernel at G = 1, through views (no copy)."""
    _check(name, db, queries, task_ids, task_slot, metric, 2)
    return _launch(name, db[None], queries[None], task_ids[None],
                   task_slot[None], metric)[0]


def _launch_group(name: str, dbs, queries, task_ids, task_slot, metric: str):
    _check(name, dbs, queries, task_ids, task_slot, metric, 3)
    return _launch(name, dbs, queries, task_ids, task_slot, metric)


def distance_slot_gather(db, queries, task_ids, task_slot, metric: str = "l2"):
    """Slot-gather kernel: (T,) f32, dist(db[id_t], queries[slot_t]);
    dummies (id < 0) are exactly 1e30."""
    return _launch_one("distance_slot_gather", db, queries, task_ids,
                       task_slot, metric)


def distance_onehot(db, queries, task_ids, task_slot, metric: str = "l2"):
    """One-hot-form kernel: the same tasks with the one-hot path's formula
    (l2 = |x|² − 2x·q + |q|², ip = −x·q); dummies exactly 1e30."""
    return _launch_one("distance_onehot", db, queries, task_ids, task_slot,
                       metric)


def distance_slot_gather_group(dbs, queries, task_ids, task_slot,
                               metric: str = "l2"):
    """The slot-gather kernel over G lanes in one launch: dbs (G, N, d),
    queries (G, R, d), task_ids/task_slot (G, T) -> (G, T); lane g is
    ``distance_slot_gather(dbs[g], queries[g], task_ids[g], task_slot[g])``,
    bit for bit."""
    return _launch_group("distance_slot_gather", dbs, queries, task_ids,
                         task_slot, metric)


def distance_onehot_group(dbs, queries, task_ids, task_slot,
                          metric: str = "l2"):
    """The one-hot-form kernel over G lanes in one launch (shapes as
    ``distance_slot_gather_group``)."""
    return _launch_group("distance_onehot", dbs, queries, task_ids,
                         task_slot, metric)
