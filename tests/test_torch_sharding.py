"""The port's sharding rules (``distributed/sharding.py``), meshes
(``launch/mesh.py``) and meta stand-ins (``model_zoo.param_specs`` /
``input_specs``) against the JAX package's.

For every arch, every parameter leaf's spec equals the reference's
``PartitionSpec`` of its stacked counterpart without the stack dim, on
``SINGLE_POD``, ``MULTI_POD`` and a (2, 4) mesh (the reference's on its
device-free ``abstract_mesh``); so do the decode caches' and the batch's
specs, and the stand-ins' shapes and dtypes for every arch × shape. On a
(2, 4) mesh over the fake process group, meta ``distribute_tensor`` local
shapes equal ``NamedSharding.shard_shape``. Exact throughout.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.launch.mesh import abstract_mesh as j_abstract_mesh  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402

ARCHS = tconfigs.list_archs()
MESHES = {"single_pod": (tconfigs.SINGLE_POD.shape, tconfigs.SINGLE_POD.axes),
          "multi_pod": (tconfigs.MULTI_POD.shape, tconfigs.MULTI_POD.axes),
          "2x4": ((2, 4), ("data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_no_group_left():
    """One intra-op thread; the fake process group a planning mesh makes is
    destroyed after the module, so no later test in this worker finds it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _meshes(name):
    sizes, names = MESHES[name]
    return j_abstract_mesh(sizes, names), tmesh.abstract_mesh(sizes, names)


def _ref_leaves(tree):
    """{"a/b/c": (leaf, its key path)} of a reference pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[jshard._leaf_path_str(path)] = leaf
    return out


def _stacked(path):
    return isinstance(path[1] if len(path) > 1 else None, int)


def _dtype(d):
    return str(d).replace("torch.", "")


def test_production_meshes():
    """``make_production_mesh`` has the reference's shapes and names, and
    ``MeshConfig`` its devices."""
    for multi_pod, cfg in ((False, tconfigs.SINGLE_POD),
                           (True, tconfigs.MULTI_POD)):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (m.axis_sizes, m.axis_names) == (cfg.shape, cfg.axes)
        assert m.size == cfg.num_devices
        jm = j_abstract_mesh(cfg.shape, cfg.axes)
        assert m.shape == dict(jm.shape)
    assert jconfigs.SINGLE_POD.num_devices == 256
    assert tconfigs.MULTI_POD.num_devices == 512


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    """Every leaf: the reference path, shape (stack dim dropped), dtype and
    spec (stack entry dropped) equal the reference's."""
    jm, tm = _meshes(mesh)
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams = jzoo.param_specs(jcfg)
    jspecs = _ref_leaves(jax.tree.map(lambda s: s.spec,
                                      jshard.param_shardings(jparams, jm)))
    jleaves = _ref_leaves(jparams)
    params = model_zoo.param_specs(cfg)
    specs = sharding.param_shardings(params, tm)
    seen = set()
    for path, leaf in sharding._walk(params):
        key = sharding.reference_path(path)
        seen.add(key)
        jleaf, jspec = jleaves[key], tuple(jspecs[key])
        assert leaf.device.type == "meta"
        if _stacked(path):
            jshape, jspec = tuple(jleaf.shape[1:]), jspec[1:]
        else:
            jshape = tuple(jleaf.shape)
        assert tuple(leaf.shape) == jshape, key
        assert _dtype(leaf.dtype) == str(jleaf.dtype), key
        got = specs
        for p in path:
            got = got[p]
        assert got == jspec, (key, got, jspec)
        assert got == sharding.spec_for_leaf(key, tuple(leaf.shape), tm)
    assert seen == set(jleaves)


def _ref_cache_key(cfg, path):
    keys = [str(p) for p in path if not isinstance(p, int)]
    if cfg.block_kind == "attn":
        keys = ["l0"] + keys
    return "/".join(keys)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_inputs_and_cache_specs_equal_reference(arch, mesh):
    """Decode caches (the port's per-layer lists against the reference's
    stacked groups) and the token: shapes, dtypes and specs."""
    jm, tm = _meshes(mesh)
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jin = jzoo.input_specs(jcfg, jconfigs.DECODE_32K)
    tin = model_zoo.input_specs(cfg, tconfigs.DECODE_32K)
    jc = _ref_leaves(jin["caches"])
    jcs = _ref_leaves(jax.tree.map(
        lambda s: s.spec, jshard.cache_shardings(jin["caches"], jm, jcfg)))
    specs = sharding.cache_shardings(tin["caches"], tm, cfg)
    n = 0
    for path, leaf in sharding._walk(tin["caches"]):
        key = _ref_cache_key(cfg, path)
        assert tuple(leaf.shape) == tuple(jc[key].shape[1:]), key
        assert _dtype(leaf.dtype) == str(jc[key].dtype), key
        got = specs
        for p in path:
            got = got[p]
        assert got == tuple(jcs[key])[1:], (key, got, jcs[key])
        n += 1
    assert n == sum(jc[k].shape[0] for k in jc)
    tok = tuple(tin["token"].shape)
    assert tok == jin["token"].shape
    assert sharding.batch_spec_for(tok, tm) == tuple(
        jshard.batch_spec_for(tok, jm))
    assert sharding.batch_spec_for((4096, 128, 8), tm, seq_axis_dim=1) == \
        tuple(jshard.batch_spec_for((4096, 128, 8), jm, seq_axis_dim=1))
    assert tuple(tin["cur_len"].shape) == () and \
        tin["cur_len"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    """Train and prefill batches (and decode's, above) for every shape of
    the arch: the same keys, shapes and dtypes; their batch specs equal on
    the single pod."""
    jm, tm = _meshes("single_pod")
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for jshape, shape in zip(jconfigs.shapes_for(jcfg),
                             tconfigs.shapes_for(cfg)):
        assert dataclasses.astuple(jshape) == dataclasses.astuple(shape)
        if shape.kind == "decode":
            continue
        jin, tin = jzoo.input_specs(jcfg, jshape), \
            model_zoo.input_specs(cfg, shape)
        assert sorted(jin) == sorted(tin)
        jd = jax.tree.map(lambda s: s.spec, jshard.data_shardings(jin, jm))
        td = sharding.data_shardings(tin, tm)
        for k in jin:
            assert tuple(tin[k].shape) == jin[k].shape, k
            assert _dtype(tin[k].dtype) == str(jin[k].dtype), k
            assert td[k] == tuple(jd[k]), k


# the reference's tests/test_dryrun_small.py::test_sharding_rules_divisibility
DIVISIBILITY = [
    ("blocks/l0/attn/wq", (64, 128), P("data", "model")),
    ("blocks/l0/attn/wq", (63, 127), P(None, None)),
    ("blocks/l0/attn/wo", (128, 64), P("model", "data")),
    ("blocks/l0/mlp/w_gate", (8, 64, 32), P("model", "data", None)),
    ("blocks/l0/ln1", (64,), P(None)),
]


@pytest.mark.parametrize("path,shape,want", DIVISIBILITY)
def test_sharding_rules_divisibility(path, shape, want):
    jm, tm = _meshes("2x4")
    assert jshard.spec_for_leaf(path, shape, jm) == want
    assert sharding.spec_for_leaf(path, shape, tm) == tuple(want)
    assert sharding.replicated(tm) == tuple(jshard.replicated(jm).spec)


def test_constrain_is_the_identity_outside_a_context():
    """Outside a context, and inside one on a plain tensor, ``constrain``
    returns its argument (no copy); ``ctx_seq_parallel`` is 0 outside and
    the context's inside; ``seq_shards`` is None without a DeviceMesh."""
    x = torch.randn(4, 6, 8)
    assert sharding.constrain(x, "batch", None, "model") is x
    assert sharding.ctx_seq_parallel() == 0
    _, tm = _meshes("2x4")
    with sharding.activation_sharding(tm, seq_parallel=4):
        assert sharding.constrain(x, "batch", None, "model") is x
        assert sharding.ctx_seq_parallel() == 4
        assert sharding.seq_shards("model") is None
        with pytest.raises(ValueError):
            sharding.constrain(x, "batch", None)
    assert sharding.ctx_seq_parallel() == 0
    assert sharding.seq_shards("model") is None


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (64, 128)), (("model", "data"), (128, 64)),
    ((("data",), None, "model"), (8, 3, 16)), ((None, "model"), (5, 12)),
    (("model", None, "data"), (8, 7, 6))])
def test_placements_shard_like_the_reference(spec, shape):
    """A meta tensor distributed by ``placements(spec)`` on a (2, 4) mesh
    over the fake backend has the local shape of the reference's
    ``NamedSharding(mesh, P(*spec)).shard_shape``."""
    from torch.distributed.tensor import distribute_tensor

    jm, tm = _meshes("2x4")
    device_mesh = tmesh.planning_mesh(tm)
    t = distribute_tensor(torch.empty(shape, device="meta"), device_mesh,
                          sharding.placements(spec, device_mesh))
    want = NamedSharding(jm, P(*spec)).shard_shape(shape)
    assert tuple(t.to_local().shape) == tuple(want)
    assert tuple(t.shape) == shape


def test_meta_only_for_the_spec_builders():
    """``param_specs``/``input_specs`` allocate nothing (meta); every other
    entry point still refuses a device other than cpu or cuda."""
    from repro_torch.device import resolve_device

    cfg = tconfigs.get_smoke_config("phi3-medium-14b")
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError):
        model_zoo.init_params(cfg, device="meta")
    with pytest.raises(ValueError):
        model_zoo.init_decode_caches(cfg, 1, 4, device="meta")
    for _, leaf in sharding._walk(model_zoo.param_specs(cfg)):
        assert leaf.device.type == "meta"
