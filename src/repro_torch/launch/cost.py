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
mode. A Python loop's body is counted as often as it runs. A
``models/scan.py`` scan over meta tensors is counted by its trip count, as
the reference counts a ``while`` body × its ``known_trip_count``: it runs
its first two steps, one middle step under ``repeat(n − 4)`` and its last
two, and everything the middle step dispatches counts n − 4 times: its
ops, the backward of the autograd nodes it made (each node carries its
count in ``Node.metadata``) and the gradient sums autograd does for them.
Live bytes count the storages the middle step keeps (for the next step,
a stacked output or autograd) n − 4 times. Flops, bytes, collectives and
the forward's peak then equal the unrolled loop's wherever its middle
steps do the same work. In backward the copies a repeated step keeps are
freed all at once, where the unrolled loop frees one a step: a train
step's peak is at least the unrolled loop's and above it by at most
``held_bytes``, the n − 1 more copies summed over the scopes; it is equal
where the peak comes before backward reaches a scan's middle steps, as in
``tests/test_torch_scan.py`` and the dry run's recurrent cells in
``tests/test_torch_dryrun.py``.
"""
from __future__ import annotations

import contextlib
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


# the repeat count an autograd node made under ``repeat`` carries into its
# backward (``Node.metadata``)
_SCALE = "cost_scale"


def active() -> Optional["CostCounter"]:
    """The innermost ``CostCounter`` on the dispatch mode stack, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def _storage_keys(tree):
    """The storage key of each tensor leaf's local tensor, in order."""
    for t in _tensors(tree):
        yield getattr(t, "_local_tensor", t).untyped_storage()._cdata


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


class _Step:
    """What a ``repeat`` scope's step made: its output state and output."""

    carry = y = None

    def made(self, carry, y):
        self.carry, self.y = carry, y


class CostCounter(TorchDispatchMode):
    """Count flops, bytes, collective bytes and peak live bytes of the ops
    run under it (``with CostCounter() as c: ...; c.totals()``). With
    ``deadline`` (a ``time.monotonic()`` value), an op dispatched after it
    raises ``TimeoutError``, naming the op. With ``device`` (the dry run's
    "meta"), only ops with a tensor on that device count: DTensor's
    sharding propagation computes shard offsets with host ops (arange,
    cat) whenever its cache misses, which no device runs."""

    def __init__(self, deadline: Optional[float] = None,
                 device: Optional[str] = None):
        super().__init__()
        self.deadline = deadline
        self.device = device
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        # storage key -> [bytes, serial], while the storage lives; a
        # storage a repeated step keeps counts its copies in the other
        # repeats too
        self._live = {}
        self._serial = 0  # storages tracked so far
        # the more copies ``repeat`` scopes counted, which backward frees
        # at once (the train peak's bound above the unrolled loop's)
        self.held_bytes = 0
        self.last_op = None  # the op dispatched last (names a failure)
        self.scale = 1  # the product of the open ``repeat`` scopes
        self._scopes = []  # per open scope: the node ranges of inner ones
        self._tagged = False  # a node carries _SCALE

    def _backward_scale(self) -> Optional[int]:
        """In backward (a checkpoint's recompute runs with grad on), the
        count the running node stands for: its tag, which includes the
        scopes it was made in, or the open scopes' product; else None."""
        if not self._tagged or torch.is_grad_enabled():
            return None
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        return node.metadata.get(_SCALE, self.scale)

    def _release(self, key):
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[0]

    def _track(self, outs, ins):
        """Count the new storages among ``outs`` as live until freed."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            self._serial += 1
            self._live[key] = [st.nbytes(), self._serial]
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
        ins = list(_tensors((args, kwargs)))
        if any(isinstance(t, FakeTensor) for t in ins):
            # DTensor's sharding propagation runs the op once on fake
            # tensors of the global shape to learn its output's metadata
            return out
        outs = list(_tensors(out))
        if self.device is not None and not any(
                t.device.type == self.device for t in ins + outs):
            return out
        # in backward the node running, or feeding its gradient on, counts
        # as often as the step that made it
        scale = self.scale_now()
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = _KINDS.get(name)
            if kind is not None:
                self.collective_bytes[kind] += scale * sum(
                    _nbytes(t) for t in outs)
        if func in _MATMULS:
            k = _MATMULS[func](args, kwargs)
            self.flops += scale * 2 * out.numel() * k
        elif func in _SDPA:
            q, k_ = args[0], args[1]
            B, H, Sq, hd = q.shape
            hd_v = args[2].shape[-1]
            self.flops += scale * 2 * B * H * Sq * k_.shape[-2] * (hd + hd_v)
        if not (func.is_view or func in _NO_TRAFFIC
                or name == "wait_tensor"):
            self.bytes_accessed += scale * sum(_nbytes(t) for t in ins + outs)
        if not func.is_view:
            self._track(outs, ins)
        return out

    def scale_now(self) -> int:
        """The count an op dispatched now stands for."""
        inside = self._backward_scale()
        return self.scale if inside is None else inside

    @contextlib.contextmanager
    def repeat(self, n: int, carry=()):
        """Count what runs inside as ``n`` runs of it: flops, bytes and
        collectives × n, here and in the backward of the autograd nodes
        made here. ``carry`` is the step's input state; the step reports
        its output state and per-step output with ``step.made(carry, y)``.
        The storages the step made and keeps, other than its output
        state, count n times in the live bytes, and so does its output
        state where the step keeps its input state alive; the peak inside
        is raised by what those n − 1 more copies would hold."""
        step = _Step()
        lo = torch._C._autograd._get_sequence_nr()
        serial0 = self._serial
        carry_in = [(key, self._live[key][1]) if key in self._live else None
                    for key in _storage_keys(carry)]
        del carry  # the step's own references decide what it keeps
        outer_scale, outer_peak = self.scale, self.peak_bytes
        self.scale = outer_scale * n
        self.peak_bytes = self.live_bytes
        self._scopes.append([])
        try:
            yield step
            self._close(step, n, lo, serial0, carry_in)
        finally:
            self.scale = outer_scale
            self.peak_bytes = max(self.peak_bytes, outer_peak)
            self._scopes.pop()
            step.carry = step.y = None

    def _close(self, step, n, lo, serial0, carry_in):
        hi = torch._C._autograd._get_sequence_nr()
        carry_out = list(_storage_keys(step.carry))
        more = {}  # storage key -> bytes the other n - 1 copies add
        for key, (nbytes, serial) in self._live.items():
            if serial > serial0 and key not in carry_out:
                more[key] = (n - 1) * nbytes
        for got, key in zip(carry_in, carry_out):
            entry = self._live.get(key)
            if got is None or entry is None or entry[1] <= serial0:
                continue
            kept = self._live.get(got[0])
            if kept is not None and kept[1] == got[1]:
                # the step keeps its input state: n - 1 more output states
                more[got[0]] = more.get(got[0], 0) + (n - 1) * entry[0]
        added = sum(more.values())
        for key, extra in more.items():
            self._live[key][0] += extra
        self.live_bytes += added
        self.peak_bytes += added
        self.held_bytes += added
        if torch.is_grad_enabled():
            self._tag(step, lo, hi)

    def _tag(self, step, lo, hi):
        """Mark the autograd nodes made in [lo, hi), but those of inner
        scopes, with this scope's repeat count."""
        inner = self._scopes[-1]
        todo = [t.grad_fn for t in _tensors((step.carry, step.y))
                if t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            seq = node._sequence_nr()
            if not lo <= seq < hi:
                continue
            if not any(a <= seq < b for a, b in inner):
                node.metadata[_SCALE] = self.scale
                self._tagged = True
            todo.extend(f for f, _ in node.next_functions)
        if len(self._scopes) > 1:
            self._scopes[-2].append((lo, hi))

    def counts(self):
        """The counts so far, for ``set_counts``."""
        return (self.flops, self.bytes_accessed,
                dict(self.collective_bytes), self.peak_bytes)

    def set_counts(self, counts):
        """Put the counts back to ``counts()``'s."""
        self.flops, self.bytes_accessed, coll, self.peak_bytes = counts
        self.collective_bytes = defaultdict(int, coll)

    def totals(self) -> dict:
        coll = dict(self.collective_bytes)
        coll["total"] = sum(coll.values())
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": coll, "peak_bytes": self.peak_bytes,
                "held_bytes": self.held_bytes}
