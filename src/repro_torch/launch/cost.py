"""Per-device cost counts of eager PyTorch code (the JAX package's
``launch/hlo_cost.py``, named for what it counts: eager PyTorch has no HLO
to parse).

``CostCounter`` is a ``TorchDispatchMode``. Under it every ATen op that
runs is counted:

  · flops            — matmul FLOPs (2 · numel(out) · K) of ``mm``,
                       ``addmm``, ``bmm``, ``baddbmm``, and both products
                       of the scaled-dot-product-attention ops,
  · bytes_accessed   — operand + result bytes of every op but views and
                       metadata (the counterpart of ``_NO_TRAFFIC``): each
                       eager op is its own round trip to memory, so this is
                       the unfused traffic, not XLA's fusion-boundary one,
  · collective_bytes — result bytes of the collectives by kind (the
                       ``_c10d_functional`` ops DTensor issues and the
                       ``c10d`` ones ``torch.distributed`` issues), and
                       their ``total``,
  · peak_bytes       — the peak of live bytes of the storages made under
                       it (the dry run's ``temp_size``).

Counts are per device: over DTensors the mode declines the op (returns
``NotImplemented``), DTensor redistributes and runs it on the local
shards, and those local ops, collectives included, come back through the
mode. A loop body is counted as often as it runs (the reference's
trip-count property holds in eager mode by construction).
"""
from __future__ import annotations

import time
import weakref
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_MATMULS = {
    aten.mm.default: lambda a, kw: a[0].shape[1],
    aten.addmm.default: lambda a, kw: a[1].shape[1],
    aten.bmm.default: lambda a, kw: a[0].shape[2],
    aten.baddbmm.default: lambda a, kw: a[1].shape[2],
}
_SDPA = {aten._scaled_dot_product_flash_attention.default,
         aten._scaled_dot_product_efficient_attention.default,
         aten._scaled_dot_product_cudnn_attention.default,
         aten._scaled_dot_product_flash_attention_for_cpu.default}
# ops that move no bytes: allocation and aliasing (views are told by their
# schema); ``wait_tensor`` hands back a collective's result (its "-done")
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.detach.default,
               aten.lift_fresh.default}
# collective op name -> the reference's kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "allgather_": "all-gather",
          "_allgather_base_": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "allreduce_": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
          "broadcast": "broadcast", "broadcast_": "broadcast"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Count flops, bytes, collective bytes and peak live bytes of the ops
    run under it (``with CostCounter() as c: ...; c.totals()``). With
    ``deadline`` (a ``time.monotonic()`` value), an op dispatched after it
    raises ``TimeoutError``, naming the op."""

    def __init__(self, deadline: Optional[float] = None):
        super().__init__()
        self.deadline = deadline
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}  # storage key -> bytes, while the storage lives
        self.last_op = None  # the op dispatched last (names a failure)

    def _release(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, outs, args):
        """Count the new storages among ``outs`` as live until freed."""
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(outs):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._release, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self.last_op = func
        if self.deadline is not None and time.monotonic() > self.deadline:  # repro-analyze: disable=DET002 (the dry run's trace budget, not sim time)
            raise TimeoutError(f"{func}: the trace passed its deadline")
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor comes back with local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            # DTensor's sharding propagation runs the op once on fake
            # tensors of the global shape to learn its output's metadata
            return out
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = _KINDS.get(name)
            if kind is not None:
                self.collective_bytes[kind] += sum(
                    _nbytes(t) for t in _tensors(out))
        if func in _MATMULS:
            k = _MATMULS[func](args, kwargs)
            self.flops += 2 * out.numel() * k
        elif func in _SDPA:
            q, k_ = args[0], args[1]
            B, H, Sq, hd = q.shape
            hd_v = args[2].shape[-1]
            self.flops += 2 * B * H * Sq * k_.shape[-2] * (hd + hd_v)
        if not (func.is_view or func in _NO_TRAFFIC
                or name == "wait_tensor"):
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(kwargs))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(out))
        if not func.is_view:
            self._track(out, (args, kwargs))
        return out

    def totals(self) -> dict:
        coll = dict(self.collective_bytes)
        coll["total"] = sum(coll.values())
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": coll, "peak_bytes": self.peak_bytes}
