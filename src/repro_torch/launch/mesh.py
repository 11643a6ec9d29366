"""Meshes of the port (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants, so importing this module touches no
process group and no device.

- ``abstract_mesh`` / ``make_production_mesh``: device-free meshes (axis
  names and sizes), for the sharding rules and the dry run's planning. The
  production meshes stay abstract: their 256 and 512 cards do not exist
  here (the reference's ``make_production_mesh`` also works only under the
  dry run's forced host device count).
- ``make_host_mesh``: a real ``DeviceMesh`` over the ranks of the process
  group, for the sequence-sharded decode.
- ``planning_mesh``: a ``DeviceMesh`` of an abstract mesh's shape over
  PyTorch's fake process group, on which the dry run shards meta tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import MULTI_POD, SINGLE_POD
from repro_torch.device import resolve_device

AXES = ("data", "model")  # the host mesh's axes


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (``jax.sharding.AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} vs {self.axis_names}")

    @property
    def shape(self) -> dict:
        """name -> size, as ``dict(mesh.shape)`` reads in the reference."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips)."""
    m = MULTI_POD if multi_pod else SINGLE_POD
    return abstract_mesh(m.shape, m.axes)


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """A ``DeviceMesh`` (world // model_axis, model_axis) on ("data",
    "model") over the ranks of the initialised process group. With none
    initialised, it initialises a one-rank group over an in-memory store
    (no port, no network): NCCL on ``cuda``, gloo on ``cpu``. Raises when
    CUDA is asked for and missing."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    return init_device_mesh(dev.type, (world // model_axis, model_axis),
                            mesh_dim_names=AXES)


def _clear_dtensor_caches():
    """DTensor's sharding and redistribution caches hand back the specs
    they made, meshes and their (destroyed) groups included, to an equal
    mesh made later: empty them with the group (those this torch has)."""
    import torch
    from torch.distributed.tensor import DTensor, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    for cache in (getattr(prop, "propagate_op_sharding", None),
                  getattr(prop, "_propagate_tensor_meta_cached", None),
                  getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:  # the C++ dispatch's own copy
        clear()


def planning_mesh(abstract: AbstractMesh):
    """A ``DeviceMesh`` of ``abstract``'s shape and names over PyTorch's
    fake process group (rank 0 of ``abstract.size``; collectives are
    recorded, not run), for sharding meta tensors in the dry run. The
    fake backend becomes the default group of this process; a process
    that already has a real default group is refused, not touched."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # a testing module of PyTorch's: the fake store the fake backend needs
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "a real process group is initialised; plan in a process of "
                "its own (python -m repro_torch.launch.dryrun)")
        if dist.get_world_size() != abstract.size:
            dist.destroy_process_group()
            _clear_dtensor_caches()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=abstract.size)
    return init_device_mesh("cpu", abstract.axis_sizes,
                            mesh_dim_names=abstract.axis_names)
