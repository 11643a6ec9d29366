"""Divisibility-aware sharding rules for every architecture, as DTensor
placements (the JAX package's ``distributed/sharding.py``).

Baseline layout:
  · dense kernels  (d_in, d_out)      -> (fsdp="data", tp="model")
  · output kernels (wo/down/out_proj) -> (tp="model", fsdp="data")
    so the contracting (heads/ffn) dim stays on "model" through a block
  · MoE expert stacks (E, …)          -> E on "model" (expert parallelism)
  · embeddings (V, d)                 -> (V→"model", d→"data")
  · batch dims                        -> ("pod", "data") jointly
  · decode KV caches: sequence dim    -> "model"

Any dim not divisible by its mesh axis is replicated instead of erroring.

A spec here is what the reference's ``PartitionSpec`` holds, as a plain
tuple: one entry a tensor dim, each ``None``, a mesh axis name or a tuple
of names. ``placements`` turns it into a DTensor ``Shard(d)`` /
``Replicate()`` per mesh dim. A mesh is anything with axis names and
sizes: ``launch/mesh.py``'s device-free ``AbstractMesh`` or a
``torch.distributed.device_mesh.DeviceMesh``.

The port keeps per-layer (or per-group) lists where the reference stacks
its layers on a leading dim that every rule leaves ``None``; so a port
leaf's spec is the reference spec of its stacked counterpart without that
entry, and a decode cache's rules act one dim to the left.

The reference's ``shard_map`` and ``axis_size`` (jax-version shims) have
no counterpart: the sequence-sharded decode (``models/attention.py``,
``models/mla.py``) runs on each rank's local cache shard and combines over
the process group of the mesh axis it is given, whose size is the axis
size.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Tuple

# leaf-path regex -> spec template for the TRAILING dims (leading stack dims
# get None). "F" = fsdp axis ("data"), "T" = tensor axis ("model").
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed$", ("T", "F")),
    (r"lm_head$", ("F", "T")),
    # MoE expert stacks (E, d, f) / (E, f, d)
    (r"w_gate$|w_up$|w_down$", ("T", "F", None)),
    (r"router$", ("F", None)),
    # output projections: contracting dim on model
    (r"wo$|down$|out_proj$|up_out$|dt_proj$", ("T", "F")),
    # mamba/xlstm internals whose input dim is model-sharded
    (r"x_proj$", ("T", None)),
    (r"A_log$", ("T", None)),
    (r"conv_w$", (None, "T")),
    (r"w_if$", ("T", None)),
    (r"w_h$", (None, None, None)),
    # qkv biases: follow the output dim
    (r"bq$|bk$|bv$|conv_b$|D$", ("T",)),
    (r"bias$", (None,)),
    # norms replicate
    (r"ln\d?$|.*norm$", (None,)),
    # default dense kernel
    (r".*", ("F", "T")),
)
_TAGS = {"F": "data", "T": "model"}


def axis_sizes(mesh) -> dict:
    """name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def spec_for_leaf(path: str, shape: Tuple[int, ...], mesh) -> tuple:
    """Spec for one param leaf (divisibility-aware)."""
    sizes = axis_sizes(mesh)
    for pattern, template in _RULES:
        if re.search(pattern, path):
            tmpl = template
            break
    ndim = len(shape)
    t = len(tmpl)
    # leading stack dims (scan groups, expert axis already in template)
    spec = [None] * (ndim - t) + [_TAGS.get(tag)
                                  for tag in tmpl[max(0, t - ndim):]]
    spec = spec[:ndim]
    return tuple(ax if ax is not None and dim % sizes[ax] == 0 else None
                 for dim, ax in zip(shape, spec))


def _walk(tree, path=()):
    """(path of keys and list indices, leaf) for every leaf of nested
    dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def reference_path(path) -> str:
    """The reference's "/"-joined key path of a port leaf: a list index of
    the layer or group stacks is dropped (the reference's stack dim), and
    a per-layer attention block is the reference's group ``l0``."""
    keys = []
    for i, p in enumerate(path):
        if isinstance(p, int):
            if i == 1 and path[0] == "blocks" and not (
                    len(path) > 2 and str(path[2]).startswith("l")
                    and str(path[2])[1:].isdigit()):
                keys.append("l0")
            continue
        keys.append(str(p))
    return "/".join(keys)


def param_shardings(params, mesh):
    """A tree of specs matching the port's parameter tree (its leaves need
    only ``.shape``: tensors, meta tensors or ``torch.Size``-like)."""
    def one(path, leaf):
        return spec_for_leaf(reference_path(path), tuple(leaf.shape), mesh)

    return _map(params, one)


def batch_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _batch_entry(b: int, mesh):
    sizes = axis_sizes(mesh)
    use = []
    prod = 1
    for a in batch_axes(mesh):
        if b % (prod * sizes[a]) == 0:
            use.append(a)
            prod *= sizes[a]
    if not use:
        return None
    # one axis as its name, as ``PartitionSpec`` keeps a one-name tuple
    return use[0] if len(use) == 1 else tuple(use)


def batch_spec_for(shape: Tuple[int, ...], mesh,
                   seq_axis_dim: Optional[int] = None) -> tuple:
    """Shard dim0 (batch) over (pod, data) as far as divisibility allows;
    optionally shard ``seq_axis_dim`` over "model" (decode KV caches)."""
    spec = [_batch_entry(shape[0], mesh)] + [None] * (len(shape) - 1)
    if seq_axis_dim is not None and \
            shape[seq_axis_dim] % axis_sizes(mesh)["model"] == 0:
        spec[seq_axis_dim] = "model"
    return tuple(spec)


def data_shardings(batch_shapes, mesh):
    """Specs for a train/prefill batch dict."""
    return _map(batch_shapes,
                lambda _, leaf: batch_spec_for(tuple(leaf.shape), mesh))


def cache_shardings(cache_shapes, mesh, cfg=None):
    """Decode-cache specs over the port's per-layer (or per-group) cache
    lists: dim 0 is the batch; attention caches get S -> "model";
    recurrent states get their feature dim -> "model" (the reference's
    rules, its group dim dropped)."""
    model = axis_sizes(mesh)["model"]

    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1]
        spec = [None] * len(shape)
        spec[0] = _batch_entry(shape[0], mesh)
        if name in ("k", "v", "ck", "cv") and len(shape) == 4:
            # (B, S, Hkv, hd): sequence-shard
            dim = 1
        elif name in ("ckv", "kr") and len(shape) == 3:
            dim = 1
        elif name == "h" and len(shape) == 3:  # mamba (B, di, ds)
            dim = 1
        elif name == "conv" and len(shape) == 3:  # (B, dc-1, di)
            dim = 2
        else:  # xlstm C/n/m and sLSTM states: replicated
            dim = None
        if dim is not None and shape[dim] % model == 0:
            spec[dim] = "model"
        return tuple(spec)

    return _map(cache_shapes, one)


def replicated(mesh=None) -> tuple:
    """The spec of a replicated value of any rank (``P()``)."""
    return ()


def placements(spec, device_mesh):
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim d names, ``Replicate()`` elsewhere. A
    tensor dim over several mesh dims (("pod", "data")) is split in mesh
    order, as the reference's tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in device_mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# activation-sharding context: model code calls ``constrain(x, ...logical)``
# at layer boundaries; outside a launcher context, and on plain tensors, it
# is the identity; inside one, a DTensor is redistributed to the layout the
# reference's ``with_sharding_constraint`` pins.
# ---------------------------------------------------------------------------

_CTX: dict = {"mesh": None, "seq_parallel": 0}


class activation_sharding:
    """Context manager: ``with activation_sharding(mesh): step(...)``.

    seq_parallel=M: prefill/train attention additionally shards query rows
    M-way on "model" (for head counts that do not divide the TP degree).
    A ``DeviceMesh`` here also lets ``seq_axis`` decode run sequence-
    sharded (``models/attention.py::decode_step_attention``)."""

    def __init__(self, mesh, seq_parallel: int = 0):
        self.mesh = mesh
        self.seq_parallel = seq_parallel

    def __enter__(self):
        self._prev = (_CTX["mesh"], _CTX["seq_parallel"])
        _CTX["mesh"] = self.mesh
        _CTX["seq_parallel"] = self.seq_parallel
        return self

    def __exit__(self, *exc):
        _CTX["mesh"], _CTX["seq_parallel"] = self._prev
        return False


def ctx_seq_parallel() -> int:
    return _CTX["seq_parallel"] if _CTX["mesh"] is not None else 0


def _resolve(tag, size: int, mesh):
    """logical tag -> mesh axis (or None), divisibility-checked."""
    if tag is None:
        return None
    if tag == "batch":
        return _batch_entry(size, mesh)
    # "model" (heads / ffn / experts / seq)
    if size % axis_sizes(mesh)["model"] == 0:
        return "model"
    return None


# ops that a dry run's step reaches where DTensor has no sharding strategy
# (the MoE dispatch's searchsorted and scatters) or cannot redistribute
# (a backward's copy_ from Shard into a Partial gradient, the mamba
# scan's), by ATen name: each runs replicated (see reshard_fallbacks)
REPLICATED_OPS = frozenset({"searchsorted", "scatter_", "scatter_add_",
                            "copy_"})
VIEW_OPS = frozenset({"view", "_unsafe_view", "reshape"})


def reshard_fallbacks():
    """A ``TorchDispatchMode`` for tracing on DTensors (the dry run), where
    GSPMD would reshard and DTensor raises instead:

    - a view (``VIEW_OPS``) that would split or merge a sharded dim unevenly
      (heads that do not divide the "model" axis) has its input's shards
      from the first dim the view changes on gathered, and runs again; the
      dims in front keep their shards;
    - an op of ``REPLICATED_OPS`` runs on its inputs gathered whole, on
      every device, and its outputs are replicated: what GSPMD does with
      an op it cannot partition.

    Any other op's exception propagates, and so does one that the op
    raises again on gathered inputs (a shape that is wrong whole).
    ``fired`` counts the fallbacks by op. Enter it inside
    ``launch/cost.py``'s counter, which then counts the gathers'
    collectives and the replicated op's whole-size work."""
    import collections

    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    def whole(t):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(t.device_mesh,
                              (Replicate(),) * t.device_mesh.ndim).to_local()

    class ReshardFallbacks(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.fired = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not any(issubclass(t, DTensor) for t in types):
                return func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if name not in VIEW_OPS and name not in REPLICATED_OPS:
                return func(*args, **kwargs)
            from repro_torch.launch import cost

            counter = cost.active()
            counts = counter.counts() if counter is not None else None
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError, AssertionError):
                if counter is not None:
                    # the attempt's local ops (DTensor runs some before it
                    # finds no strategy, the first time only) count nothing
                    counter.set_counts(counts)
                # as often as the counter counts the op (a scan's middle
                # step stands for several)
                self.fired[str(func)] += (counter.scale_now()
                                          if counter is not None else 1)
                if name not in VIEW_OPS:
                    return self._replicated(func, args, kwargs)
            x, shape = args[0], list(args[1])
            if -1 in shape:
                i = shape.index(-1)
                shape[i] = x.numel() // max(1, -math.prod(shape))
            first = 0
            while (first < min(x.ndim, len(shape))
                   and x.shape[first] == shape[first]):
                first += 1
            want = tuple(Replicate() if getattr(p, "dim", -1) >= first
                         else p for p in x.placements)
            x = x.redistribute(x.device_mesh, want)
            return func(x, shape, *args[2:], **kwargs)

        @staticmethod
        def _replicated(func, args, kwargs):
            mesh = next(t.device_mesh for t in
                        torch.utils._pytree.tree_leaves((args, kwargs))
                        if isinstance(t, DTensor))
            local_args, local_kwargs = tree_map(whole, (args, kwargs))
            out = func(*local_args, **local_kwargs)
            # an in-place op's result is a new replicated DTensor: the trace
            # follows shapes and layouts, not values
            return tree_map(
                lambda t: DTensor.from_local(
                    t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
                if isinstance(t, torch.Tensor) else t, out)

    return ReshardFallbacks()


def constrain(x, *logical):
    """Pin a DTensor's layout by logical tags ("batch" | "model" | None per
    dim); the identity outside an ``activation_sharding`` context and on a
    plain tensor."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError((logical, tuple(x.shape)))
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = tuple(_resolve(t, d, mesh) for t, d in zip(logical, x.shape))
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# the sequence-sharded decode: each rank holds its shard of the cache's
# positions and attends over it; the shards' partials combine over the
# process group of the mesh axis (the reference's shard_map + pmax/psum)
# ---------------------------------------------------------------------------


class SeqShards:
    """This rank's place on the mesh axis ``axis`` that shards the cache's
    positions: ``coord`` of ``size`` shards, combined over ``group``."""

    def __init__(self, axis: str, group, coord: int, size: int):
        self.axis, self.group, self.coord, self.size = axis, group, coord, size


def seq_shards(seq_axis: Optional[str]) -> Optional[SeqShards]:
    """The ``SeqShards`` of ``seq_axis`` on the context's mesh when that is
    a real ``DeviceMesh``; None (the unsharded decode) otherwise, as the
    reference takes its plain path when its context holds no mesh."""
    mesh = _CTX["mesh"]
    if seq_axis is None or mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        return None
    dim = mesh.mesh_dim_names.index(seq_axis)
    return SeqShards(seq_axis, mesh.get_group(seq_axis),
                     mesh.get_local_rank(seq_axis), mesh.size(dim))


def on_local_shards(core, inputs, cache, shards: SeqShards):
    """``core(*inputs, cache)`` on this rank's shards, for a cache of
    DTensors (the dry run's ``seqshard`` variant; the reference's
    ``shard_map``): the cache as its local shard of the positions, the
    inputs gathered but for their batch shards (the cache's), and the
    output a DTensor laid out as the inputs. A plain cache (a rank's own
    shard already) runs ``core`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    leaf = next(iter(cache.values()))
    if not isinstance(leaf, DTensor):
        return core(*inputs, cache)
    mesh = leaf.device_mesh
    axis_dim = mesh.mesh_dim_names.index(shards.axis)
    if getattr(leaf.placements[axis_dim], "dim", None) != 1:
        raise ValueError(f"the cache is not sharded on its positions over "
                         f"{shards.axis!r}: {leaf.placements}")
    want = tuple(p if getattr(p, "dim", None) == 0 else Replicate()
                 for p in leaf.placements)
    local = [x.redistribute(mesh, want).to_local() for x in inputs]
    out = core(*local, {k: v.to_local() for k, v in cache.items()})
    return DTensor.from_local(out, mesh, want, run_check=False)


def merge_partials(m, l, o, shard_max, shard_sum):
    """The combine's arithmetic, with the reductions over the shards given:
    alpha = exp(m - max m), then sum(alpha·o) / sum(alpha·l), the two sums
    packed in one tensor. ``shard_max(t)`` is t's max over the shards
    (broadcastable against t), ``shard_sum(t)`` its sum.

    m, l: (...) float32, each shard's running max and sum of exp(s - m)
    (m = -inf, l = 0 for a shard with no valid position; some shard has
    one); o: (..., D) float32, its unnormalised sum of exp(s - m) v.
    Returns (..., D) float32."""
    import torch

    alpha = torch.exp(m - shard_max(m))
    packed = shard_sum(torch.cat([alpha[..., None] * o,
                                  (alpha * l)[..., None]], dim=-1))
    return packed[..., :-1] / packed[..., -1:].clamp(min=1e-30)


def merge_stacked(m, l, o):
    """``merge_partials`` over partials stacked on dim 0 in one process
    (slices of one cache): m, l (M, ...), o (M, ..., D)."""
    return merge_partials(m, l, o, lambda t: t.amax(0, keepdim=True),
                          lambda t: t.sum(0))


def combine_partials(m, l, o, shards: SeqShards):
    """Softmax partials of every shard -> the attention output, float32
    (``merge_partials``' arguments): one all_reduce(MAX) of m, then one
    all_reduce(SUM) of alpha·o and alpha·l packed together over the axis's
    group; with one shard, no collective."""
    import torch.distributed as dist

    if shards.size == 1:
        return o / l.clamp(min=1e-30)[..., None]

    def all_reduce(op):
        def reduce(t):
            t = t.clone()
            dist.all_reduce(t, op=op, group=shards.group)
            return t
        return reduce

    return merge_partials(m, l, o, all_reduce(dist.ReduceOp.MAX),
                          all_reduce(dist.ReduceOp.SUM))
