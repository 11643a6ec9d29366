"""The port stands alone: it imports neither jax nor the JAX package, its
entry points default to the card and refuse to run on the CPU unless
asked, and its configs equal the JAX package's field for field."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.configs.base as jbase  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.configs.base as tbase  # noqa: E402
from repro.configs.base import VectorPoolConfig as JConfig  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_port_imports_without_jax_or_repro():
    """In a fresh interpreter where ``import jax`` fails, every port module
    imports and no ``repro`` module gets loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('repro', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_cuda_requested_without_card_raises(monkeypatch):
    """Asking for the card where there is none raises; nothing quietly
    runs on the CPU."""
    from repro_torch import convert
    from repro_torch.core import ShardedVectorPool, VectorPool
    from repro_torch.core.continuous_batching import (ContinuousBatchingEngine,
                                                      GroupEngine)
    from repro_torch.vector.ivf import IVFFlat
    from repro_torch.vector.shards import ShardedIndex
    from repro_torch.device import resolve_device
    from repro_torch.vector.graph import build_knn_graph_exact, make_cagra_graph
    from repro_torch.vector.online import OnlineIndex
    from repro_torch.vector.cagra import search_batch
    from repro_torch.vector.ref import exact_knn
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import RealServer
    from repro_torch.launch.serve_rag_cluster import main as cluster_cli
    from repro_torch.models import model_zoo
    from repro_torch.serving.cluster import ClusterSim, make_sharded_pool_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(num_vectors=64, dim=8, graph_degree=4, max_requests=2,
                  top_m=8, task_batch=256, visited_slots=64)
    db = np.zeros((64, 8), np.float32)
    graph = np.zeros((64, 4), np.int32)
    calls = [lambda: resolve_device(),
             lambda: resolve_device("cuda:0"),
             lambda: VectorPool(cfg, db, graph),
             lambda: ShardedVectorPool(cfg, db),
             lambda: ShardedIndex(db, num_shards=2, build_graphs=False),
             lambda: GroupEngine(cfg),
             lambda: IVFFlat(db, nlist=4, iters=1),
             lambda: ContinuousBatchingEngine(cfg, db, graph),
             lambda: OnlineIndex(db, graph),
             lambda: convert.index_from_numpy(db, graph),
             lambda: exact_knn(db, db[:2], 3),
             lambda: exact_knn(db, db[:2], 3, device="cuda"),
             lambda: build_knn_graph_exact(db, 3),
             lambda: make_cagra_graph(db, 4),
             lambda: make_cagra_graph(db, 4, device="cuda"),
             lambda: make_cagra_graph(db, 4, exact_threshold=8),
             lambda: search_batch(db, graph, db[:2]),
             lambda: model_zoo.init_params(get_smoke_config("gemma-7b")),
             lambda: model_zoo.init_params(
                 get_smoke_config("deepseek-v3-671b")),
             lambda: model_zoo.init_decode_caches(
                 get_smoke_config("deepseek-v3-671b"), 1, 4),
             lambda: model_zoo.init_decode_caches(
                 get_smoke_config("gemma-7b"), 1, 4),
             lambda: convert.lm_params_from_numpy(
                 get_smoke_config("gemma-7b"), {}),
             lambda: RealServer(get_smoke_config("gemma-7b"), cfg),
             lambda: ClusterSim(get_smoke_config("phi3-medium-14b"), cfg, db,
                                graph),
             lambda: make_sharded_pool_sim(num_vectors=600,
                                           replica_max_rows=300),
             lambda: cluster_cli(["--requests", "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # with a card, a graph above exact_threshold (NN-descent, CPU-only
    # Python loops) is refused on the card instead of run on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="NN-descent"):
        make_cagra_graph(db, 4, exact_threshold=8)
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


def test_vector_pool_config_equal_to_jax():
    jf = {f.name: (f.type, f.default) for f in dataclasses.fields(JConfig)}
    tf = {f.name: (f.type, f.default) for f in dataclasses.fields(TConfig)}
    assert list(jf) == list(tf)
    assert jf == tf
    assert TConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["MoEConfig", "MLAConfig", "ModelConfig",
                                  "ShapeConfig", "AutoscalerConfig",
                                  "MeshConfig"])
def test_model_config_classes_equal_to_jax(name):
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(getattr(jbase, name))]
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(getattr(tbase, name))]
    assert jf == tf
    assert getattr(tbase, name).__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["SINGLE_POD", "MULTI_POD", "TRAIN_4K",
                                  "PREFILL_32K", "DECODE_32K", "LONG_500K"])
def test_mesh_and_shape_constants_equal_to_jax(name):
    """The production meshes and the shape set, exported by both packages'
    ``configs``: equal field for field, with the same device counts."""
    j, t = getattr(jconfigs, name), getattr(tconfigs, name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    if name.endswith("_POD"):
        assert j.num_devices == t.num_devices
    assert [s.name for s in jconfigs.SHAPES.values()] == \
        [s.name for s in tconfigs.SHAPES.values()]


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_arch_configs_equal_to_jax(arch):
    """Every ported arch's published and smoke configs equal the JAX
    package's field for field, with the same derived numbers (the analytic
    counts, MoE and MLA included)."""
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.resolved_head_dim, j.q_heads_per_kv, j.param_count(),
                j.active_param_count()) == \
            (t.resolved_head_dim, t.q_heads_per_kv, t.param_count(),
             t.active_param_count())


def test_unported_archs_raise_naming_their_roadmap_item():
    """Every arch of the JAX package is ported, in its order, so none is
    left to raise; an unknown arch raises KeyError."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in tconfigs.list_archs():
        for get in (tconfigs.get_config, tconfigs.get_smoke_config):
            assert get(arch).name.startswith(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")
