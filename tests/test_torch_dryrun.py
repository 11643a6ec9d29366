"""The port's dry run (``launch/dryrun.py``) and its counter
(``launch/cost.py``), the counterparts of the JAX package's
``launch/dryrun.py`` and ``launch/hlo_cost.py``, on the CPU.

The counter counts a Python loop's body as often as it runs and a
``models/scan.py`` scan by its trip count (the reference's trip-count
property), a collective's result bytes, and over DTensors the local
shards' work, not the global op's; a dense smoke config's prefill flops
equal a hand count exactly. The recurrent families' small cells (xlstm and
jamba, a train and a prefill shape) count exactly what the unrolled loops
count. The dry run on
the deepseek-moe-16b smoke config (``TRAIN_4K`` cut to seq 64 and batch 8,
a (2, 4) mesh over the fake backend) counts flops, collectives and
argument bytes, as the reference's test asserts; beside them it prints the
JAX package's numbers for the same cell, which its own test computes with
a mesh of Auto axes in a subprocess (the ratio is recorded, not asserted).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import TRAIN_4K, PREFILL_32K, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.models import layers, model_zoo, transformer  # noqa: E402
from repro_torch.models import scan as scan_mod  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL = dataclasses.replace(TRAIN_4K, seq_len=64, global_batch=8)

# the reference's small dry run (tests/test_dryrun_small.py's script) on a
# mesh of Auto axes: jax's make_mesh makes Explicit ones, which its
# with_sharding_constraint refuses
JAX_SMALL_DRYRUN = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config, TRAIN_4K
    from repro.distributed import sharding as shard
    from repro.launch import hlo_cost
    from repro.launch.dryrun import build_step

    cfg = get_smoke_config("deepseek-moe-16b")
    shape = dataclasses.replace(TRAIN_4K, seq_len=64, global_batch=8)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    fn, args, in_sh = build_step(cfg, shape, mesh)
    with mesh, shard.activation_sharding(mesh):
        compiled = jax.jit(fn, in_shardings=in_sh).lower(*args).compile()
    out = hlo_cost.analyze(compiled.as_text())
    out["temp_bytes"] = compiled.memory_analysis().temp_size_in_bytes
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_no_group_left():
    """One intra-op thread; no process group outlives the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_counter_counts_a_loop_body_every_time():
    """Ten (256, 256) matmuls in a Python loop: 10 · 2 · 256³ flops (the
    reference's scan counted by trip count)."""
    x = torch.empty((256, 256), device="meta")
    with CostCounter() as c:
        for _ in range(10):
            x = x @ x
    assert c.totals()["flops"] == 10 * 2 * 256 ** 3


def test_counter_counts_collective_bytes():
    """An all_reduce of (8, 128) float32 on a one-rank gloo group (the host
    mesh on the CPU) counts 4,096 bytes, by c10d and by the functional
    collectives DTensor issues."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    host = mesh.make_host_mesh(device="cpu")
    try:
        t = torch.ones(8, 128)
        with CostCounter() as c:
            dist.all_reduce(t)
        assert c.totals()["collective_bytes"] == {"all-reduce": 4096,
                                                  "total": 4096}
        with CostCounter() as c:
            funcol.all_reduce(t, "sum", host["data"]).wait()
        assert c.totals()["collective_bytes"]["all-reduce"] == 4096
    finally:
        dist.destroy_process_group()


def test_counter_counts_local_shards_not_the_global_op():
    """(64, 4096) @ (4096, 4096) with the weight sharded (data, model) on a
    (2, 4) fake mesh: the local product's flops, an eighth of the global
    2,147,483,648 (a dispatch mode above DTensor sees the global shapes;
    the counter lets DTensor run first and counts what reaches the
    shards)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding

    dm = mesh.planning_mesh(mesh.abstract_mesh((2, 4), ("data", "model")))
    x = distribute_tensor(torch.empty((64, 4096), device="meta"), dm,
                          sharding.placements(("data", None), dm))
    w = distribute_tensor(torch.empty((4096, 4096), device="meta"), dm,
                          sharding.placements(("data", "model"), dm))
    with CostCounter() as c:
        y = x @ w
    assert tuple(y.shape) == (64, 4096)
    assert c.totals()["flops"] == 2 * 64 * 4096 * 4096 // 8


def test_reshard_fallbacks_replicate_only_named_ops():
    """On a (2, 4) fake mesh: ``searchsorted`` (no sharding strategy, in
    ``REPLICATED_OPS``) runs replicated and is counted under its op;
    ``renorm``, also without a strategy but not named, raises as DTensor
    raises it; a named op whose shapes are wrong whole (a copy_ of 9
    columns into 8) raises too."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding

    dm = mesh.planning_mesh(mesh.abstract_mesh((2, 4), ("data", "model")))

    def dt(shape, spec):
        return distribute_tensor(torch.empty(shape, device="meta"), dm,
                                 sharding.placements(spec, dm))

    rows = dt((8, 64), (None, None))
    with sharding.reshard_fallbacks() as fb:
        got = torch.searchsorted(rows, rows)
    assert tuple(got.shape) == (8, 64)
    assert dict(fb.fired) == {"aten.searchsorted.Tensor": 1}
    x = dt((8, 64), ("data", "model"))
    with pytest.raises(NotImplementedError, match="renorm"):
        with sharding.reshard_fallbacks():
            torch.renorm(x, 2, 0, 1.0)
    with pytest.raises(RuntimeError):
        with sharding.reshard_fallbacks():
            dt((8, 8), ("data", None)).copy_(dt((8, 9), ("data", None)))


def test_prefill_flops_equal_a_hand_count():
    """phi3's smoke config prefilling (2, 32) on meta tensors, no mesh:
    2 · (its matmul weights) · tokens, the head on the last position only,
    plus QKᵀ and PV over every (query, key) pair (the blocked path masks,
    it does not skip), exactly."""
    cfg = get_smoke_config("phi3-medium-14b")
    B, S = 2, 32
    params = model_zoo.param_specs(cfg)
    batch = model_zoo.input_specs(
        cfg, dataclasses.replace(PREFILL_32K, seq_len=S, global_batch=B))
    with torch.no_grad(), CostCounter() as c:
        model_zoo.prefill_fn(cfg, params, batch)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                 + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
    want = (2 * B * S * per_layer * cfg.num_layers
            + 2 * B * d * transformer.lm_head_vocab(cfg)
            + cfg.num_layers * 2 * (2 * B * cfg.num_heads * S * S * hd))
    assert c.totals()["flops"] == want


@pytest.fixture(scope="module")
def jax_small_dryrun():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SMALL_DRYRUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def test_small_scale_dryrun(jax_small_dryrun):
    """deepseek-moe-16b's smoke config, ``TRAIN_4K`` cut to seq 64 and
    batch 8, a (2, 4) mesh over the fake backend: flops, collective bytes
    and argument bytes all counted (the reference test's assertions: TP/EP
    collectives present), the temp peak too; the JAX package's counts for
    the same cell printed beside them."""
    cfg = get_smoke_config("deepseek-moe-16b")
    got = dryrun.trace_cell(cfg, SMALL,
                            mesh.abstract_mesh((2, 4), ("data", "model")))
    assert got["flops"] > 0
    assert got["collective_bytes"]["total"] > 0
    assert got["argument_size"] > 0
    assert got["temp_size"] > 0
    # the MoE dispatch's ops run replicated, each counted (REPLICATED_OPS)
    assert {"aten.searchsorted.Tensor", "aten.scatter_add_.default"} \
        <= set(got["fallbacks"])
    ref = jax_small_dryrun
    print(json.dumps({
        "port": {k: got[k] for k in ("flops", "bytes_accessed",
                                     "collective_bytes", "argument_size",
                                     "temp_size")},
        "jax": {"flops": ref["flops"],
                "bytes_accessed": ref["bytes_accessed"],
                "collective_bytes": ref["collective_bytes"],
                "temp_bytes": ref["temp_bytes"]},
        "flops_ratio": got["flops"] / ref["flops"],
        "collective_ratio": got["collective_bytes"]["total"]
        / ref["collective_bytes"]["total"]}))


def test_run_cell_records_an_error_naming_the_op(tmp_path, monkeypatch):
    """A cell whose step raises records status "error", the exception and
    the op that raised, and the sweep goes on (the reference's ``except``);
    a cell that runs records the reference's keys."""
    def broken(*a, **kw):
        x = torch.empty((4,), device="meta")
        return torch.nonzero(x)  # no meta kernel: data-dependent shape

    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "build_step",
                        lambda *a, **kw: (broken, ()))
    rec = dryrun.run_cell("phi3-medium-14b", "decode_32k", False,
                          force=True, results_dir=str(tmp_path))
    assert rec["status"] == "error"
    assert "nonzero" in rec["op"] and rec["error"]
    assert (tmp_path / "phi3-medium-14b__decode_32k__pod_16x16.json").exists()


def test_counter_deadline_names_the_op():
    """Past its deadline the counter raises ``TimeoutError`` naming the op
    it reached (a dry-run cell's trace budget, ``dryrun.TRACE_BUDGET_S``)."""
    import time

    x = torch.empty((4, 4), device="meta")
    with pytest.raises(TimeoutError, match="aten.mm"):
        with CostCounter(deadline=time.monotonic() - 1.0):  # repro-analyze: disable=DET002 (a deadline already past, not sim time)
            x @ x


# the scans each case runs counted: (the function that calls ``scan``, n − 4)
SCANS = {"xlstm-350m": {("slstm_block", 20), ("mlstm_block", 2)},
         "jamba-1.5-large-398b": {("_ssm", 2), ("_scan_chunk", 2)},
         "deepseek-moe-16b": {("train_step", 2)}}


@pytest.mark.parametrize("arch,base,seq,chunk,microbatches", [
    ("xlstm-350m", TRAIN_4K, 24, 4, 1),
    ("xlstm-350m", PREFILL_32K, 24, 4, 1),
    ("jamba-1.5-large-398b", TRAIN_4K, 36, 6, 1),
    ("jamba-1.5-large-398b", PREFILL_32K, 36, 6, 1),
    ("deepseek-moe-16b", TRAIN_4K, 32, 256, 6),
], ids=lambda v: getattr(v, "name", str(v)))
def test_counted_scans_equal_the_unrolled_loops(arch, base, seq, chunk,
                                                 microbatches, monkeypatch):
    """The smoke config on a (2, 4) planning mesh, the sequence cut to 6
    chunks (of 4 for xlstm, of 6 positions for jamba: the mLSTM and mamba
    chunk scans, mamba's position scans and the sLSTM's steps all run
    counted) and one microbatch of batch 4; deepseek-moe-16b's train step
    in 6 microbatches of 2 (the microbatch scan, the MoE's replicated ops
    inside it). The counted path ran: each scan of the case entered
    ``repeat`` with its n − 4 (``SCANS``), and the unrolled trace (the
    same code with the counted path switched off here) entered none.
    Flops, bytes accessed, every
    collective kind and the fallbacks fired are equal; the peak bytes are
    equal in forward and, in train (its backward and the groups' recompute
    under ``torch.utils.checkpoint``), at least the unrolled trace's and
    at most ``temp_slack`` above it (``launch/cost.py``)."""
    from test_torch_scan import _spy_repeat

    calls = _spy_repeat(monkeypatch)
    chunk_len = layers.chunk_len
    monkeypatch.setattr(layers, "chunk_len",
                        lambda S, _=256: chunk_len(S, chunk))
    monkeypatch.setattr(dryrun, "num_microbatches_for",
                        lambda *a, **kw: microbatches)
    cfg = get_smoke_config(arch)
    shape = dataclasses.replace(base, seq_len=seq,
                                global_batch=max(4, 2 * microbatches))
    abstract = mesh.abstract_mesh((2, 4), ("data", "model"))
    keys = ("flops", "bytes_accessed", "collective_bytes", "fallbacks")
    counted = dryrun.trace_cell(cfg, shape, abstract)
    assert set(calls) == SCANS[arch]
    monkeypatch.setattr(scan_mod, "_counter_for", lambda carry: None)
    del calls[:]
    unrolled = dryrun.trace_cell(cfg, shape, abstract)
    assert calls == [] and unrolled["temp_slack"] == 0
    assert {k: counted[k] for k in keys} == {k: unrolled[k] for k in keys}
    assert counted["flops"] > 0 and counted["collective_bytes"]["total"] > 0
    peak, want = counted["temp_size"], unrolled["temp_size"]
    if base.kind == "train":
        assert want <= peak <= want + counted["temp_slack"]
    else:
        assert peak == want
