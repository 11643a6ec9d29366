"""Hopper kernels against their plain-PyTorch versions on the card, and
the serving path on the card against the CPU.

Needs an NVIDIA GPU with nvcc; skipped elsewhere. Imports nothing of JAX,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda

SWEEP = [(500, 128, 8, 256), (1000, 64, 16, 512), (256, 256, 4, 256),
         (300, 127, 8, 256), (300, 130, 8, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, d, R, T, seed, dev):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, size=T).astype(np.int32)
    ids[::5] = -1
    arrays = (rng.normal(size=(N, d)).astype(np.float32),
              rng.normal(size=(R, d)).astype(np.float32), ids,
              rng.integers(0, R, size=T).astype(np.int32))
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("N,d,R,T", SWEEP)
def test_kernel_matches_plain(cuda, mode, metric, N, d, R, T):
    from repro_torch.kernels import distance, ops, ref

    args = _inputs(N, d, R, T, seed=N + d, dev=cuda)
    name = "distance_slot_gather" if mode == "slot_gather" \
        else "distance_onehot"
    before = distance.launches[name]
    out = ops.distance_tasks(*args, metric=metric, mode=mode)
    plain = (ref.distance_tasks_ref if mode == "slot_gather"
             else ref.distance_tasks_onehot_ref)(*args, metric=metric)
    torch.cuda.synchronize()
    assert distance.launches[name] == before + 1
    valid = args[2] >= 0
    torch.testing.assert_close(out[valid], plain[valid], rtol=1e-5, atol=1e-3)
    assert bool((out[~valid] == 1e30).all())


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
def test_kernel_padding_invariant_and_deterministic(cuda, mode):
    from repro_torch.kernels import ops

    db, q, ids, slot = _inputs(300, 64, 8, 256, seed=5, dev=cuda)
    base = ops.distance_tasks(db, q, ids, slot, mode=mode)
    again = ops.distance_tasks(db, q, ids, slot, mode=mode)
    pids = torch.cat([ids, ids.new_full((256,), -1)])
    pslot = torch.cat([slot, slot.new_zeros((256,))])
    padded = ops.distance_tasks(db, q, pids, pslot, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(base, again)
    assert torch.equal(base, padded[:256])
    assert bool((padded[256:] == 1e30).all())


# ---- the lane form: G engines' tasks in one launch ----

def _lane_inputs(G, N, d, R, T, seed, dev):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, size=(G, T)).astype(np.int32)
    for g in range(G):
        ids[g, g::5 + g] = -1  # each lane's dummies elsewhere
    arrays = (rng.normal(size=(G, N, d)).astype(np.float32),
              rng.normal(size=(G, R, d)).astype(np.float32), ids,
              rng.integers(0, R, size=(G, T)).astype(np.int32))
    return [torch.as_tensor(a, device=dev) for a in arrays]


_NAME = {"slot_gather": "distance_slot_gather",
         "matmul_onehot": "distance_onehot"}


def _plain_group(mode):
    from repro_torch.kernels import ref

    return (ref.distance_tasks_group_ref if mode == "slot_gather"
            else ref.distance_tasks_onehot_group_ref)


def _kernel(mode, group):
    from repro_torch.kernels import distance

    name = _NAME[mode] + ("_group" if group else "")
    return getattr(distance, name)


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("entry", ["ops", "kernel"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("N,d,R,T", SWEEP)
def test_group_kernel_matches_plain(cuda, mode, metric, entry, G, N, d, R, T):
    """The lane kernel, through ``ops.distance_tasks_group`` and through its
    wrapper, against the plain version; one launch a call."""
    from repro_torch.kernels import distance, ops

    args = _lane_inputs(G, N, d, R, T, seed=N + d + G, dev=cuda)
    before = distance.launches[_NAME[mode]]
    out = (ops.distance_tasks_group(*args, metric=metric, mode=mode)
           if entry == "ops" else _kernel(mode, True)(*args, metric=metric))
    plain = _plain_group(mode)(*args, metric=metric)
    torch.cuda.synchronize()
    assert distance.launches[_NAME[mode]] == before + 1
    valid = args[2] >= 0
    assert out.shape == (G, T)
    torch.testing.assert_close(out[valid], plain[valid], rtol=1e-5, atol=1e-3)
    assert bool((out[~valid] == 1e30).all())


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("d", [64, 127])
def test_group_padding_invariant_and_deterministic(cuda, mode, d):
    """Dummies appended to every lane change nothing before them; two runs
    give the same bits (float4 rows and the scalar path)."""
    db, q, ids, slot = _lane_inputs(4, 300, d, 8, 256, seed=5, dev=cuda)
    fn = _kernel(mode, True)
    base = fn(db, q, ids, slot)
    again = fn(db, q, ids, slot)
    pids = torch.cat([ids, ids.new_full((4, 256), -1)], dim=1)
    pslot = torch.cat([slot, slot.new_zeros((4, 256))], dim=1)
    padded = fn(db, q, pids, pslot)
    torch.cuda.synchronize()
    assert torch.equal(base, again)
    assert torch.equal(base, padded[:, :256])
    assert bool((padded[:, 256:] == 1e30).all())


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("G,N,d,R,T", [(4, 500, 128, 8, 2048),
                                       (7, 300, 64, 4, 100),   # lanes split blocks
                                       (3, 300, 127, 8, 256),  # scalar path
                                       (2, 200, 2052, 4, 64)])  # wide rows
def test_group_lane_equals_single_launch(cuda, mode, metric, G, N, d, R, T):
    """Lane g of one G-lane launch has the bits of a G = 1 launch on lane g
    and of the (T,) wrapper on lane g (one lane mapping, one order of
    sums)."""
    args = _lane_inputs(G, N, d, R, T, seed=G + d, dev=cuda)
    group = _kernel(mode, True)(*args, metric=metric)
    for g in range(G):
        lane = [a[g:g + 1] for a in args]
        one = _kernel(mode, True)(*lane, metric=metric)
        single = _kernel(mode, False)(*[a[0] for a in lane], metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(group[g], one[0]), g
        assert torch.equal(group[g], single), g
    plain = _plain_group(mode)(*args, metric=metric)
    valid = args[2] >= 0
    torch.testing.assert_close(group[valid], plain[valid], rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("case", ["db_unaligned", "ids_unaligned", "wide",
                                  "out_of_range"])
def test_group_kernel_edge_cases(cuda, mode, case):
    """The lane kernel against the plain version on a db base off 16 bytes
    (the scalar path), ids and slots off 16 bytes, rows of 8 KB (d 2048),
    and ids past N and slots past R (clamped within each lane)."""
    G, N, d, R, T = 3, 300, 2048 if case == "wide" else 64, 8, 256
    db, q, ids, slot = _lane_inputs(G, N, d, R, T, seed=len(case), dev=cuda)
    if case == "db_unaligned":
        db = torch.cat([db.new_zeros(1), db.flatten()])[1:].view(G, N, d)
    if case == "ids_unaligned":
        ids = torch.cat([ids.new_zeros(1), ids.flatten()])[1:].view(G, T)
        slot = torch.cat([slot.new_zeros(1), slot.flatten()])[1:].view(G, T)
    want_args = [db, q, ids, slot]
    if case == "out_of_range":
        ids[:, 3::11] = N + torch.arange(G, device=cuda, dtype=torch.int32)[:, None]
        slot[:, 5::13] = R + 2
        want_args = [db, q, ids, slot.clamp(0, R - 1)]
    out = _kernel(mode, True)(db, q, ids, slot)
    plain = _plain_group(mode)(*want_args)
    torch.cuda.synchronize()
    valid = ids >= 0
    torch.testing.assert_close(out[valid], plain[valid], rtol=1e-5, atol=1e-3)
    assert bool((out[~valid] == 1e30).all())


def test_group_wrappers_refuse_cpu_and_bad_shapes(cuda):
    from repro_torch.kernels import distance

    db, q, ids, slot = _lane_inputs(2, 100, 32, 4, 256, seed=1, dev=cuda)
    before = dict(distance.launches)
    for fn in (distance.distance_slot_gather_group,
               distance.distance_onehot_group):
        with pytest.raises(ValueError, match="CUDA"):
            fn(db.cpu(), q.cpu(), ids.cpu(), slot.cpu())
        for args in ((db, q[:1], ids, slot), (db, q, ids[:, :128], slot),
                     (db[0], q[0], ids[0], slot[0]), (db, q, ids.long(), slot),
                     (db, q[..., :16], ids, slot), (db, q, ids, slot.cpu())):
            with pytest.raises(ValueError):
                fn(*args)
    for fn in (distance.distance_slot_gather, distance.distance_onehot):
        with pytest.raises(ValueError):
            fn(db, q, ids, slot)
    assert distance.launches == before


def test_engine_on_card_matches_cpu(cuda):
    """A few engine chunks on the card give the CPU run's ids."""
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core.continuous_batching import ContinuousBatchingEngine
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.graph import make_cagra_graph

    cfg = VectorPoolConfig(num_vectors=2000, dim=64, graph_degree=8,
                           max_requests=8, top_m=16, task_batch=256,
                           visited_slots=256)
    db, queries = make_dataset(2000, 64, num_clusters=16, num_queries=8,
                               seed=7)
    graph = make_cagra_graph(db, 8, seed=7)
    out = {}
    for dev in ("cpu", "cuda"):
        e = ContinuousBatchingEngine(cfg, db, graph, device=dev, seed=3)
        e.admit_batch([(i, queries[i]) for i in range(8)])
        out[dev] = {rid: ids for rid, ids, _, _ in e.run_to_completion()}
    assert out["cpu"].keys() == out["cuda"].keys()
    same = np.mean([np.array_equal(out["cpu"][r], out["cuda"][r])
                    for r in out["cpu"]])
    assert same >= 0.99


# ---------------------------------------------------------------------------
# prefill / decode attention
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _randn(shape, seed, dtype, dev):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.as_tensor(x, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", [
    (2, 128, 128, 4, 2, 64, True), (1, 256, 256, 8, 8, 32, True),
    (2, 64, 64, 4, 1, 128, False), (1, 1000, 1000, 8, 2, 128, True),
    (2, 77, 77, 14, 2, 64, True), (1, 100, 300, 4, 4, 16, True),
    (1, 300, 100, 2, 1, 256, True), (4, 512, 512, 40, 10, 128, True),
    (2, 200, 333, 8, 2, 64, False), (2, 333, 77, 8, 2, 128, False),
    (4, 512, 512, 16, 16, 128, True),  # deepseek-moe-16b's prefill
    # seamless-m4t's decoder (causal), encoder (not) and cross-attention
    # (Sq != Sk) at hd 64, g 1; jamba's attention at hd 128, g 8
    (4, 512, 512, 16, 16, 64, True), (4, 512, 512, 16, 16, 64, False),
    (4, 512, 300, 16, 16, 64, False), (2, 77, 512, 16, 16, 64, False),
    (4, 512, 512, 64, 8, 128, True)])
def test_flash_attention_matches_plain(cuda, dtype, B, Sq, Sk, H, Hkv, hd,
                                       causal):
    from repro_torch.kernels import flash_attention, ops, ref

    q = _randn((B, Sq, H, hd), 1, dtype, cuda)
    k = _randn((B, Sk, Hkv, hd), 2, dtype, cuda)
    v = _randn((B, Sk, Hkv, hd), 3, dtype, cuda)
    before = flash_attention.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.mha_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_attention"] == before + 2
    assert out.dtype == dtype and out.shape == (B, Sq, H, hd)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


def test_flash_attention_reads_strided_views(cuda):
    """q/k/v as views of a fused projection (strided heads) give the result
    of contiguous copies."""
    from repro_torch.kernels import ops

    qkv = _randn((2, 96, 4 + 2 + 2, 64), 4, torch.bfloat16, cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,cur_len", [
    (2, 256, 4, 2, 64, 100), (1, 512, 8, 1, 128, 511), (3, 128, 4, 4, 32, 0),
    (4, 544, 40, 10, 128, 0), (4, 544, 40, 10, 128, 271),
    (4, 544, 40, 10, 128, 543), (2, 300, 14, 2, 64, 299),
    (1, 64, 1, 1, 256, 1000), (2, 40, 12, 1, 16, 17),
    (4, 544, 16, 16, 128, 0), (4, 544, 16, 16, 128, 543),  # deepseek-moe-16b
    (4, 544, 16, 16, 64, 0), (4, 544, 16, 16, 64, 543),  # seamless-m4t
    (4, 544, 64, 8, 128, 0), (4, 544, 64, 8, 128, 543)])  # jamba
def test_decode_attention_matches_plain(cuda, dtype, B, S, H, Hkv, hd,
                                        cur_len):
    from repro_torch.kernels import decode_attention, ops, ref

    q = _randn((B, H, hd), 5, dtype, cuda)
    k = _randn((B, S, Hkv, hd), 6, dtype, cuda)
    v = _randn((B, S, Hkv, hd), 7, dtype, cuda)
    before = decode_attention.launches["decode_attention"]
    out = ops.decode_attention(q, k, v, cur_len)
    again = ops.decode_attention(q, k, v, cur_len)
    want = ref.decode_attn_ref(q, k, v, cur_len)
    torch.cuda.synchronize()
    assert decode_attention.launches["decode_attention"] == before + 2
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


@pytest.mark.parametrize("fill", [1e6, float("nan")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_ignores_future_positions(cuda, dtype, fill):
    """Garbage (±1e6) or NaN in every cache position past cur_len leaves
    the output's bits as they were: the kernel never reads there (its
    tensor maps end at cur_len + 1)."""
    from repro_torch.kernels import ops

    q = _randn((4, 40, 128), 8, dtype, cuda)
    k = _randn((4, 544, 10, 128), 9, dtype, cuda)
    v = _randn((4, 544, 10, 128), 10, dtype, cuda)
    for cur in (0, 127, 128, 271):
        out1 = ops.decode_attention(q, k, v, cur)
        k2, v2 = k.clone(), v.clone()
        k2[:, cur + 1:] = fill
        v2[:, cur + 1:] = -fill
        out2 = ops.decode_attention(q, k2, v2, cur)
        torch.cuda.synchronize()
        assert torch.equal(out1, out2), cur


# the wgmma/TMA variant of B3: ragged and exact q tiles, GQA groups, both
# head dims it takes
@pytest.mark.parametrize("g", [1, 4, 7, 12])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Sq", [1, 127, 128, 129, 1000])
def test_flash_wgmma_matches_plain(cuda, Sq, hd, g):
    from repro_torch.kernels import flash_attention, ops, ref

    B, Hkv = 2, 2
    q = _randn((B, Sq, g * Hkv, hd), 11, torch.bfloat16, cuda)
    k = _randn((B, Sq, Hkv, hd), 12, torch.bfloat16, cuda)
    v = _randn((B, Sq, Hkv, hd), 13, torch.bfloat16, cuda)
    before = flash_attention.launches["flash_wgmma"]
    out = ops.flash_attention(q, k, v, causal=True)
    again = ops.flash_attention(q, k, v, causal=True)
    want = ref.mha_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_wgmma"] == before + 2
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


@pytest.mark.parametrize("shape,variant", [
    ((4, 512, 40, 10, 128), "flash_wgmma"),      # phi3-medium-14b
    ((4, 512, 16, 16, 128), "flash_wgmma"),      # deepseek-moe-16b
    ((4, 512, 16, 16, 256), "flash_wgmma256")])  # gemma-7b
def test_flash_serving_shape_takes_wgmma(cuda, shape, variant):
    """A serving path's contiguous bf16 prefill call is counted as its
    wgmma variant, beside the total."""
    from repro_torch.kernels import flash_attention

    B, S, H, Hkv, hd = shape
    q = _randn((B, S, H, hd), 17, torch.bfloat16, cuda)
    k = _randn((B, S, Hkv, hd), 18, torch.bfloat16, cuda)
    v = _randn((B, S, Hkv, hd), 19, torch.bfloat16, cuda)
    before = dict(flash_attention.launches)
    flash_attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = flash_attention.launches
    want = {n: 0 for n in after}
    want.update({"flash_attention": 1, variant: 1})
    assert {n: after[n] - before[n] for n in after} == want


@pytest.mark.parametrize("pad", [1, 2, 4])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_unaligned_view_takes_mma(cuda, hd, pad):
    """A view whose row stride is not a multiple of 8 elements is not
    TMA-able: the rule sends it to the mma.sync variant, which agrees
    with the plain version. ``pad`` elements after each row make the
    widest piece that divides every stride 2, 4 or 8 bytes."""
    from repro_torch.kernels import flash_attention, ops, ref

    buf = _randn((2, 100, 8 * hd + pad), 20, torch.bfloat16, cuda)
    heads = buf[..., :8 * hd].unflatten(-1, (8, hd))
    q, k, v = heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]
    before = flash_attention.launches["flash_mma"]
    out = ops.flash_attention(q, k, v)
    again = ops.flash_attention(q, k, v)
    want = ref.mha_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_mma"] == before + 2
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


# the mma.sync variants of B3: flash_fp32 (every float32 call, also through
# a view with an odd row stride: 4-byte pieces) and flash_mma (bf16 that
# the wgmma variants do not take: contiguous at hd 16 and 32, and at every
# hd through a view with an odd row stride or a base 2 bytes off, which
# leave only 2-byte loads)
MMA_KINDS = {"f32": (16, 32, 64, 128, 256), "f32-odd-stride": (16, 32, 64, 128, 256),
             "bf16": (16, 32), "bf16-odd-stride": (16, 32, 64, 128, 256),
             "bf16-shifted-base": (16, 32, 64, 128, 256)}
MMA_CASES = [(kind, hd) for kind, hds in MMA_KINDS.items() for hd in hds]


def _mma_inputs(kind, B, Sq, Sk, H, Hkv, hd, seed, dev):
    """q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) of ``kind``: contiguous, or
    views of one fused (B, max(Sq, Sk), H + 2 Hkv, hd) projection whose
    rows are one element longer, or which starts one element into its
    buffer."""
    dtype = torch.float32 if kind.startswith("f32") else torch.bfloat16
    if "-" not in kind:
        return (_randn((B, Sq, H, hd), seed, dtype, dev),
                _randn((B, Sk, Hkv, hd), seed + 1, dtype, dev),
                _randn((B, Sk, Hkv, hd), seed + 2, dtype, dev))
    S, width = max(Sq, Sk), (H + 2 * Hkv) * hd
    if kind.endswith("odd-stride"):
        heads = _randn((B, S, width + 1), seed, dtype, dev)[..., :width]
    else:
        heads = _randn((B * S * width + 1,), seed, dtype, dev)[1:].view(B, S, width)
    heads = heads.unflatten(-1, (H + 2 * Hkv, hd))
    return heads[:, :Sq, :H], heads[:, :Sk, H:H + Hkv], heads[:, :Sk, H + Hkv:]


def _check_mma(kind, q, k, v, causal):
    from repro_torch.kernels import flash_attention, ops, ref

    variant = "flash_fp32" if kind.startswith("f32") else "flash_mma"
    assert flash_attention.variant_of(q, k, v) == variant
    before = flash_attention.launches[variant]
    out = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.mha_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches[variant] == before + 2
    tol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4, 7])
@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("kind,hd", MMA_CASES)
def test_flash_mma_variants_match_plain(cuda, kind, hd, Sq, g, causal):
    """Ragged and exact q and kv tiles (16 rows a warp, 64 or 128 a
    block), GQA groups, with and without the causal mask."""
    Hkv = 2
    _check_mma(kind, *_mma_inputs(kind, 2, Sq, Sq, g * Hkv, Hkv, hd, 30, cuda),
               causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(63, 200), (200, 63), (1, 65), (1000, 129)])
@pytest.mark.parametrize("kind,hd", MMA_CASES)
def test_flash_mma_variants_cross_lengths(cuda, kind, hd, Sq, Sk, causal):
    """Sq != Sk both ways: under the causal mask row i sees keys <= i."""
    _check_mma(kind, *_mma_inputs(kind, 2, Sq, Sk, 8, 2, hd, 40, cuda), causal)


# the hd-256 wgmma variant of B3 (gemma-7b's head dim): ragged and exact q
# tiles, GQA groups, causal
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("Sq", [1, 64, 100, 128, 300, 1000])
def test_flash_wgmma256_matches_plain(cuda, Sq, g):
    from repro_torch.kernels import flash_attention, ops, ref

    B, Hkv = 2, 2
    q = _randn((B, Sq, g * Hkv, 256), 24, torch.bfloat16, cuda)
    k = _randn((B, Sq, Hkv, 256), 25, torch.bfloat16, cuda)
    v = _randn((B, Sq, Hkv, 256), 26, torch.bfloat16, cuda)
    before = flash_attention.launches["flash_wgmma256"]
    out = ops.flash_attention(q, k, v, causal=True)
    again = ops.flash_attention(q, k, v, causal=True)
    want = ref.mha_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_wgmma256"] == before + 2
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


@pytest.mark.parametrize("Sq,Sk,causal,fused", [
    (200, 333, False, False), (333, 77, False, False), (77, 300, True, False),
    (300, 300, True, True), (130, 257, False, True)])
def test_flash_wgmma256_cross_lengths_and_views(cuda, Sq, Sk, causal, fused):
    """Sq != Sk with and without the causal mask, and q, k, v as views of
    one fused projection (their strides are TMA-aligned)."""
    from repro_torch.kernels import flash_attention, ops, ref

    B, H, Hkv = 2, 4, 2
    if fused:
        assert Sq == Sk or not causal
        qkv = _randn((B, max(Sq, Sk), H + 2 * Hkv, 256), 27, torch.bfloat16, cuda)
        q, k, v = qkv[:, :Sq, :H], qkv[:, :Sk, H:H + Hkv], qkv[:, :Sk, H + Hkv:]
    else:
        q = _randn((B, Sq, H, 256), 27, torch.bfloat16, cuda)
        k = _randn((B, Sk, Hkv, 256), 28, torch.bfloat16, cuda)
        v = _randn((B, Sk, Hkv, 256), 29, torch.bfloat16, cuda)
    assert flash_attention.variant_of(q, k, v) == "flash_wgmma256"
    before = flash_attention.launches["flash_wgmma256"]
    out = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.mha_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_wgmma256"] == before + 2
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


def _decode_chunk(B, S, Hkv):
    from repro_torch.kernels import decode_attention

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return decode_attention.split_plan(B * Hkv, S, sms)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 7, 8, 12, 16])
@pytest.mark.parametrize("where", ["zero", "chunk-1", "chunk", "end"])
def test_decode_ring_matches_plain(cuda, where, g, hd, dtype):
    """cur_len at the first position, on both sides of a chunk (and ring
    stage) boundary, and at the end of the cache."""
    from repro_torch.kernels import decode_attention, ops, ref

    B, S, Hkv = 2, 300, 2
    chunk = _decode_chunk(B, S, Hkv)
    cur = {"zero": 0, "chunk-1": chunk - 1, "chunk": chunk,
           "end": S - 1}[where]
    q = _randn((B, g * Hkv, hd), 21, dtype, cuda)
    k = _randn((B, S, Hkv, hd), 22, dtype, cuda)
    v = _randn((B, S, Hkv, hd), 23, dtype, cuda)
    before = decode_attention.launches["decode_attention"]
    out = ops.decode_attention(q, k, v, cur)
    again = ops.decode_attention(q, k, v, cur)
    want = ref.decode_attn_ref(q, k, v, cur)
    torch.cuda.synchronize()
    assert decode_attention.launches["decode_attention"] == before + 2
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


def test_real_server_on_card_matches_cpu(cuda):
    """A 2-layer smoke server generates the CPU server's tokens from the
    same weights (float32, TF32 off)."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch.serve import RealServer

    cfg = get_smoke_config("qwen1.5-32b")
    pool = VectorPoolConfig(num_vectors=1500, dim=64, max_requests=16,
                            top_m=16, task_batch=512, visited_slots=256,
                            top_k=5)
    cpu = RealServer(cfg, pool, rag_interval=4, device="cpu")
    card = RealServer(cfg, pool, rag_interval=4, device=cuda,
                      params=convert.lm_params_from_numpy(
                          cfg, convert.lm_params_to_numpy(cpu.params), cuda))
    prompts = np.random.default_rng(0).integers(
        0, 500, size=(2, 16)).astype(np.int32)
    f0 = flash_attention.launches["flash_attention"]
    d0 = decode_attention.launches["decode_attention"]
    toks, stats = card.generate(prompts, max_new=8)
    assert flash_attention.launches["flash_attention"] - f0 == cfg.num_layers
    assert decode_attention.launches["decode_attention"] - d0 == \
        cfg.num_layers * (16 + 8)
    want, want_stats = cpu.generate(prompts, max_new=8)
    np.testing.assert_array_equal(toks, want)
    assert stats["rag_probes"] == want_stats["rag_probes"]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_deepseek_server_on_card_matches_cpu(cuda, arch):
    """The DeepSeek smoke servers (MoE; MLA with MTP) generate the CPU
    server's tokens from the same weights (float32, TF32 off); the GQA one
    launches B3 once a layer and B4 once a layer a step."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch.serve import RealServer

    cfg = get_smoke_config(arch)
    pool = VectorPoolConfig(num_vectors=1500, dim=64, max_requests=16,
                            top_m=16, task_batch=512, visited_slots=256,
                            top_k=5)
    cpu = RealServer(cfg, pool, rag_interval=4, device="cpu")
    card = RealServer(cfg, pool, rag_interval=4, device=cuda,
                      params=convert.lm_params_from_numpy(
                          cfg, convert.lm_params_to_numpy(cpu.params), cuda))
    prompts = np.random.default_rng(0).integers(
        0, 500, size=(2, 16)).astype(np.int32)
    f0 = flash_attention.launches["flash_attention"]
    d0 = decode_attention.launches["decode_attention"]
    toks, _ = card.generate(prompts, max_new=8)
    gqa = cfg.attn_kind == "gqa"
    assert flash_attention.launches["flash_attention"] - f0 == \
        cfg.num_layers * gqa
    assert decode_attention.launches["decode_attention"] - d0 == \
        cfg.num_layers * (16 + 8) * gqa
    want, _ = cpu.generate(prompts, max_new=8)
    np.testing.assert_array_equal(toks, want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _moe_layer(arch, width):
    """(cfg, float32 MoE params on the CPU) at the smoke config's size or at
    deepseek-moe-16b's published width (d_model 2048, 64 experts of 1408,
    top 6, 2 shared)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import moe

    cfg = get_smoke_config(arch) if width == "smoke" else dataclasses.replace(
        get_config(arch), dtype="float32")
    return cfg, moe.init_moe(torch.Generator().manual_seed(0), cfg,
                             torch.float32)


@pytest.mark.parametrize("T", [4, 64, 2048])
@pytest.mark.parametrize("arch,width", [("deepseek-moe-16b", "smoke"),
                                        ("deepseek-v3-671b", "smoke"),
                                        ("deepseek-moe-16b", "published")])
def test_moe_forward_on_card_matches_cpu(cuda, arch, width, T):
    """moe_forward on the card: the CPU's output and aux loss within 1e-4
    (float32 sums in another order), capacity drops included, and a rerun
    bit-equal (the combine uses no atomics)."""
    from repro_torch.models import moe

    cfg, cpu_p = _moe_layer(arch, width)
    card_p = _to(cpu_p, cuda)
    x = _randn((T, cfg.d_model), 20, torch.float32, "cpu")
    out, aux = moe.moe_forward(card_p, x.to(cuda), cfg)
    again, _ = moe.moe_forward(card_p, x.to(cuda), cfg)
    want, want_aux = moe.moe_forward(cpu_p, x, cfg)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and torch.equal(out, again)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)


def test_moe_combine_repeats_bitwise_in_bfloat16(cuda):
    """The bf16 MoE at deepseek-moe-16b's width and prefill size (4 x 512
    tokens, capacity 240): two runs give the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = moe.init_moe(gen, cfg, torch.bfloat16)
    x = _randn((2048, cfg.d_model), 21, torch.bfloat16, cuda)
    runs = [moe.moe_forward(params, x, cfg)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("width", ["smoke", "published"])
def test_mla_on_card_matches_cpu(cuda, width):
    """mla_forward and 8 absorbed decode steps on the card against the CPU
    (float32, 1e-4), at deepseek-v3's smoke size and its published MLA
    widths (d_model 7168, 128 heads, q/kv ranks 1536/512, qk 192, v 128)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import mla

    arch = "deepseek-v3-671b"
    cfg = get_smoke_config(arch) if width == "smoke" else dataclasses.replace(
        get_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(2)
    cpu_p = mla.init_mla(gen, cfg, torch.float32)
    card_p = _to(cpu_p, cuda)
    x = _randn((2, 16, cfg.d_model), 22, torch.float32, "cpu")
    out, cache = mla.mla_forward(card_p, x.to(cuda), cfg)
    want, want_cache = mla.mla_forward(cpu_p, x, cfg)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   rtol=1e-4, atol=1e-4)
    tc = mla.init_mla_cache(cfg, 2, 8, torch.float32, cuda)
    cc = mla.init_mla_cache(cfg, 2, 8, torch.float32, "cpu")
    for i in range(9):  # the 9th step lies past the cache: writes nothing
        step_out, _ = mla.mla_decode_step(card_p, x[:, i:i + 1].to(cuda), tc,
                                          i, cfg)
        step_want, _ = mla.mla_decode_step(cpu_p, x[:, i:i + 1], cc, i, cfg)
        torch.testing.assert_close(step_out.cpu(), step_want, rtol=1e-4,
                                   atol=1e-4)
    for name in tc:
        torch.testing.assert_close(tc[name].cpu(), cc[name], rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# xLSTM, mamba and the encoder-decoder: torch ops on the card against the
# CPU (no TPU kernel stands behind the recurrences), and their servers
# ---------------------------------------------------------------------------


def _published(arch, **cut):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), dtype="float32", **cut)


@pytest.mark.parametrize("width", ["smoke", "published"])
def test_mlstm_chunk_on_card_matches_cpu(cuda, width):
    """The mLSTM block's chunked forward (two chunks of 16) and its end
    state, then 4 decode steps, card against CPU (float32, 1e-4), at the
    smoke size and xlstm-350m's widths (d_model 1024, 4 heads of 512)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import xlstm

    cfg = get_smoke_config("xlstm-350m") if width == "smoke" \
        else _published("xlstm-350m")
    cpu_p = xlstm.init_mlstm(torch.Generator().manual_seed(3), cfg,
                             torch.float32)
    card_p = _to(cpu_p, cuda)
    x = _randn((2, 32, cfg.d_model), 30, torch.float32, "cpu")
    out, cache = xlstm.mlstm_block(card_p, x.to(cuda), cfg, chunk=16)
    want, want_cache = xlstm.mlstm_block(cpu_p, x, cfg, chunk=16)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    for i in range(4):
        step = x[:, i:i + 1]
        o, cache = xlstm.mlstm_decode_step(card_p, step.to(cuda), cache, cfg)
        w, want_cache = xlstm.mlstm_decode_step(cpu_p, step, want_cache, cfg)
        torch.testing.assert_close(o.cpu(), w, rtol=1e-4, atol=1e-4)
    for name in cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", ["smoke", "published"])
def test_slstm_step_on_card_matches_cpu(cuda, width):
    """The sLSTM block over 16 tokens (its time loop) and 4 decode steps,
    card against CPU (float32, 1e-4)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import xlstm

    cfg = get_smoke_config("xlstm-350m") if width == "smoke" \
        else _published("xlstm-350m")
    cpu_p = xlstm.init_slstm(torch.Generator().manual_seed(4), cfg,
                             torch.float32)
    card_p = _to(cpu_p, cuda)
    x = _randn((2, 20, cfg.d_model), 31, torch.float32, "cpu")
    out, cache = xlstm.slstm_block(card_p, x[:, :16].to(cuda), cfg)
    want, want_cache = xlstm.slstm_block(cpu_p, x[:, :16], cfg)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    for i in range(16, 20):
        step = x[:, i:i + 1]
        o, cache = xlstm.slstm_decode_step(card_p, step.to(cuda), cache, cfg)
        w, want_cache = xlstm.slstm_decode_step(cpu_p, step, want_cache, cfg)
        torch.testing.assert_close(o.cpu(), w, rtol=1e-4, atol=1e-4)
    for name in cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", ["smoke", "published"])
def test_mamba_scan_on_card_matches_cpu(cuda, width):
    """The mamba block's chunked scan (two chunks of 16; h carried across)
    and its end state, then 4 decode steps, card against CPU (float32,
    1e-4), at the smoke size and jamba's widths (d_model 8192, d_inner
    16384, d_state 16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import mamba

    cfg = get_smoke_config("jamba-1.5-large-398b") if width == "smoke" \
        else _published("jamba-1.5-large-398b")
    cpu_p = mamba.init_mamba(torch.Generator().manual_seed(5), cfg,
                             torch.float32)
    card_p = _to(cpu_p, cuda)
    x = _randn((2, 32, cfg.d_model), 32, torch.float32, "cpu")
    out, cache = mamba.mamba_block(card_p, x.to(cuda), cfg, chunk=16)
    want, want_cache = mamba.mamba_block(cpu_p, x, cfg, chunk=16)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    for i in range(4):
        step = x[:, i:i + 1]
        o, cache = mamba.mamba_decode_step(card_p, step.to(cuda), cache, cfg)
        w, want_cache = mamba.mamba_decode_step(cpu_p, step, want_cache, cfg)
        torch.testing.assert_close(o.cpu(), w, rtol=1e-4, atol=1e-4)
    for name in cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["xlstm-350m", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b"])
def test_family_server_on_card_matches_cpu(cuda, arch):
    """The three families' smoke servers generate the CPU server's tokens
    from the same weights (float32, TF32 off). B3 runs once an attention
    layer at prefill (and once an encoder layer and a cross-attention under
    encdec), B4 once a decoder attention layer a step; xLSTM has none."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch.serve import RealServer
    from repro_torch.models import transformer

    cfg = get_smoke_config(arch)
    pool = VectorPoolConfig(num_vectors=1500, dim=64, max_requests=16,
                            top_m=16, task_batch=512, visited_slots=256,
                            top_k=5)
    cpu = RealServer(cfg, pool, rag_interval=4, device="cpu")
    card = RealServer(cfg, pool, rag_interval=4, device=cuda,
                      params=convert.lm_params_from_numpy(
                          cfg, convert.lm_params_to_numpy(cpu.params), cuda))
    prompts = np.random.default_rng(0).integers(
        0, 500, size=(2, 16)).astype(np.int32)
    if cfg.block_kind == "encdec":
        n_dec = cfg.num_layers - cfg.encoder_layers
        b3, b4 = cfg.encoder_layers + 2 * n_dec, n_dec
    else:
        kinds = transformer.group_layer_kinds(cfg)
        b3 = b4 = kinds.count("attn") * transformer.num_groups(cfg)
    f0 = flash_attention.launches["flash_attention"]
    d0 = decode_attention.launches["decode_attention"]
    toks, _ = card.generate(prompts, max_new=8)
    assert flash_attention.launches["flash_attention"] - f0 == b3
    assert decode_attention.launches["decode_attention"] - d0 == b4 * (16 + 8)
    want, _ = cpu.generate(prompts, max_new=8)
    np.testing.assert_array_equal(toks, want)


def test_search_batch_on_card_matches_cpu(cuda):
    """CAGRA's per-request lockstep search on the card: the CPU's ids,
    distances, extends and iterations, bit for bit (the same sums in the
    same order)."""
    from repro_torch.vector.cagra import search_batch
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.graph import make_cagra_graph

    db, q = make_dataset(4000, 64, seed=3, num_queries=64)
    graph = make_cagra_graph(db, 16, seed=0, device="cpu")
    card = search_batch(db, graph, q, device=cuda)
    cpu = search_batch(db, graph, q, device="cpu")
    assert card[3] == cpu[3]
    for a, b in zip(card[:3], cpu[:3]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# the online index and the sharded, megabatched pool on the card
# ---------------------------------------------------------------------------


def _small_corpus(n=1920, d=16, seed=2):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(12, d)) * 3
    db = (centres[rng.integers(0, 12, n)] + rng.normal(size=(n, d)))
    q = (centres[rng.integers(0, 12, 64)] + rng.normal(size=(64, d)))
    return db.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_insert_batch_on_card_matches_cpu(cuda, metric):
    from repro_torch.vector.online import insert_batch

    rng = np.random.default_rng(3)
    N, d, D, base = 96, 16, 8, 32
    db = np.zeros((N, d), np.float32)
    db[:base + 20] = rng.normal(size=(base + 20, d))
    graph = np.full((N, D), -1, np.int32)
    graph[base:base + 20, :5] = rng.integers(base, base + 20, (20, 5))
    rows = np.asarray(list(range(base + 20, base + 25)) + [-1] * 3, np.int32)
    vecs = rng.normal(size=(8, d)).astype(np.float32)
    nbrs = rng.integers(base, base + 25, (8, D)).astype(np.int32)
    nbrs[rng.random((8, D)) < 0.3] = -1
    out = {}
    for dev in ("cpu", cuda):
        tdb, tgraph, touched = insert_batch(
            torch.as_tensor(db, device=dev), torch.as_tensor(graph, device=dev),
            rows, vecs, nbrs, metric=metric)
        out[str(dev)] = (tdb.cpu(), tgraph.cpu(), touched)
    (a_db, a_g, a_t), (b_db, b_g, b_t) = out.values()
    assert torch.equal(a_db, b_db) and torch.equal(a_g, b_g) and a_t == b_t


def test_online_index_stream_on_card_matches_cpu(cuda):
    from repro_torch.vector.online import OnlineIndex

    db, _ = _small_corpus(600)
    graph = np.random.default_rng(0).integers(0, 600, (600, 8)).astype(
        np.int32)
    idx = {dev: OnlineIndex(db, graph, cache_capacity=16, max_entries=10,
                            ttl=30.0, device=dev) for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    rows = []
    for i in range(60):
        v = rng.normal(size=16).astype(np.float32)
        cand = rows[-8:] if i % 2 else None
        got = {dev: ix.insert(v, cand, t_now=float(i))
               for dev, ix in idx.items()}
        assert got["cpu"] == got["cuda"]
        rows.append(got["cpu"])
        assert idx["cpu"].drain_evicted() == idx["cuda"].drain_evicted()
    assert torch.equal(idx["cpu"].db, idx["cuda"].db.cpu())
    assert torch.equal(idx["cpu"].graph, idx["cuda"].graph.cpu())


def _sharded_pool(device, db, **kw):
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core import ShardedVectorPool

    cfg = VectorPoolConfig(**dict(dict(
        num_vectors=len(db), dim=db.shape[1], graph_degree=8,
        max_requests=8, top_m=16, task_batch=256, visited_slots=256,
        top_k=10, num_shards=4, semantic_cache_enabled=True,
        cache_capacity=16), **kw))
    return ShardedVectorPool(cfg, db, device=device, seed=0,
                             replicas_per_shard=2)


def _drive_sharded(pool, queries, inserts):
    from repro_torch.core import VectorRequest

    t = 0.0
    for i in range(40):
        pool.submit(VectorRequest(i, "prefill", queries[i % 64], t, t + 1.0))
        if i % 5 == 2:
            pool.submit_insert(inserts[i // 5], meta={"i": i}, t_now=t)
        t += 1e-5
    pool.run_until(t + 1.0)
    t += 1.0
    for j in range(8):
        pool.submit(VectorRequest(100 + j, "cache_lookup", inserts[j], t,
                                  t + 1.0))
    pool.run_until(t + 1.0)
    return pool


@pytest.mark.parametrize("mega", [True, False])
def test_sharded_pool_on_card_matches_cpu(cuda, mega):
    """The sharded pool with inserts and cache lookups: completions, ids
    and their order, simulated times and counters equal on the card and
    on the CPU; on the megabatched arm every distance launch is grouped,
    over the pool's 8 lanes."""
    from repro_torch.kernels import distance

    db, queries = _small_corpus()
    inserts = np.random.default_rng(9).normal(size=(8, 16)).astype(
        np.float32) * 3
    knobs = dict(megabatch_enabled=mega, device_merge_enabled=mega,
                 double_buffer_enabled=mega)
    cpu = _drive_sharded(_sharded_pool("cpu", db, **knobs), queries, inserts)
    distance.reset_launches()
    card = _drive_sharded(_sharded_pool("cuda", db, **knobs), queries,
                          inserts)
    torch.cuda.synchronize()
    a, b = cpu.metrics.completed, card.metrics.completed
    assert [r.rid for r in a] == [r.rid for r in b]
    for x, y in zip(a, b):
        assert (x.t_completed, x.extends_used) == (y.t_completed,
                                                   y.extends_used)
        if x.result_ids is None:
            assert y.result_ids is None
            continue
        np.testing.assert_array_equal(x.result_ids, y.result_ids)
        np.testing.assert_allclose(x.result_dists, y.result_dists,
                                   rtol=1e-5, atol=1e-4)
    for f in ("extend_steps", "tasks_emitted", "inserts", "broadcasts",
              "merges", "sub_searches"):
        assert getattr(cpu.metrics, f) == getattr(card.metrics, f), f
    lanes = distance.lane_launches["distance_slot_gather"]
    if mega:
        assert set(lanes) == {8} and lanes[8] > 0
    else:
        assert set(lanes) == {1}


def test_grouped_chunk_lanes_equal_single_engines(cuda):
    """One grouped chunk over G lanes (each its own index and requests)
    leaves every lane's state equal to a single engine's after the same
    chunk; the distance stage is one lane launch a step."""
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core.continuous_batching import (ContinuousBatchingEngine,
                                                      GroupEngine)
    from repro_torch.kernels import distance
    from repro_torch.vector.online import OnlineIndex

    cfg = VectorPoolConfig(num_vectors=500, dim=16, graph_degree=8,
                           max_requests=8, top_m=16, task_batch=256,
                           visited_slots=256, extend_chunk=4)
    rng = np.random.default_rng(5)
    group = GroupEngine(cfg, device="cuda")
    members, singles = [], []
    for g in range(5):  # grows the lane axis 4 -> 8
        n = 400 + 20 * g
        ix = OnlineIndex(rng.normal(size=(n, 16)).astype(np.float32),
                         rng.integers(0, n, (n, 8)).astype(np.int32),
                         device="cuda")
        members.append(group.add_member(ix, seed=g))
        singles.append(ContinuousBatchingEngine(cfg, ix.db, ix.graph,
                                                device="cuda", seed=g))
        reqs = [(10 * g + i, rng.normal(size=16).astype(np.float32))
                for i in range(3 + g)]
        members[-1].admit_batch(reqs)
        singles[-1].admit_batch(reqs)
    distance.reset_launches()
    done = group.step_lanes([m.lane for m in members[:4]], 4)
    assert distance.lane_launches["distance_slot_gather"] == {8: 4}
    for m, e in zip(members[:4], singles[:4]):
        e.step_multi(4)
        for f in ("top_ids", "top_dists", "expanded", "visited", "active",
                  "extends"):
            assert torch.equal(getattr(group.state, f)[m.lane],
                               getattr(e.state, f)), f
    frozen = members[4].lane  # outside the cohort: untouched
    assert done[0][:, frozen].sum() == 0
    assert int(group.state.extends[frozen].sum()) == 0


def test_sharded_pool_lane_stack_grows_on_card(cuda):
    """A shard's cache grows past the stacked row count mid-run on the
    card: the stack doubles, every lane keeps its rows, and the results
    equal the CPU run's."""
    db, queries = _small_corpus(1920)
    rng = np.random.default_rng(1)
    vecs = [db[3] + rng.normal(0, 0.05, 16).astype(np.float32)
            for _ in range(70)]
    pools = {dev: _sharded_pool(dev, db, num_shards=2)
             for dev in ("cpu", "cuda")}
    for pool in pools.values():
        from repro_torch.core import VectorRequest

        assert pool._group.n_max == 1024
        t = 0.0
        for i, v in enumerate(vecs):
            pool.submit_insert(v, t_now=t)
            pool.submit(VectorRequest(i, "prefill", queries[i % 64], t,
                                      t + 10.0))
            t += 2e-4
            pool.run_until(t)
        pool.run_until(t + 5.0)
        assert pool._group.n_max == 2048
        for rep in pool.replicas:
            sh = pool.shards.shards[rep.shard]
            assert torch.equal(pool._group.dbs[rep.engine.lane,
                                               :sh.db.shape[0]], sh.db)
    a = pools["cpu"].metrics.completed
    b = pools["cuda"].metrics.completed
    assert [r.rid for r in a] == [r.rid for r in b]
    for x, y in zip(a, b):
        assert x.t_completed == y.t_completed
        if x.result_ids is not None:
            np.testing.assert_array_equal(x.result_ids, y.result_ids)


# ---------------------------------------------------------------------------
# shard loss, rebalancing and the cluster on the card
# ---------------------------------------------------------------------------


def _lanes_hold_shards(pool):
    g = pool._group
    for rep in pool.replicas:
        sh = pool.shards.shards[rep.shard]
        n = sh.db.shape[0]
        assert torch.equal(g.dbs[rep.engine.lane, :n], sh.db)
        assert torch.equal(g.graphs[rep.engine.lane, :n], sh.graph)


@pytest.mark.parametrize("backup", [True, False])
def test_lose_shard_on_card_matches_cpu(cuda, backup):
    """``lose_shard`` on the megabatched pool: the lost shard's lanes are
    freed and it is re-homed on a fresh lane; with the backup its entries
    land on a surviving shard, whose lanes take the rows. Every lane holds
    its shard's index afterwards, and the run equals the CPU's."""
    from repro_torch.core import VectorRequest

    db, queries = _small_corpus()
    inserts = np.random.default_rng(9).normal(size=(8, 16)).astype(
        np.float32) * 3
    knobs = dict(rebalance_enabled=True, cache_backup_enabled=backup,
                 sanitizer_enabled=True)
    pools = {}
    for dev in ("cpu", "cuda"):
        pool = _drive_sharded(_sharded_pool(dev, db, **knobs), queries,
                              inserts)
        s = pool.shards.cache_shards()[0]
        held = pool.shards.shards[s].cache_size
        pool.lose_shard(s)
        m = pool.metrics
        assert (m.cache_recovered, m.cache_lost) == \
            ((held, 0) if backup else (0, held))
        _lanes_hold_shards(pool)
        t = max(r.clock for r in pool.replicas)
        for j in range(8):
            pool.submit(VectorRequest(200 + j, "cache_lookup", inserts[j],
                                      t, t + 1.0))
        pool.run_until(t + 1.0)
        _lanes_hold_shards(pool)
        pool.sanitizer.assert_clean()
        pools[dev] = pool
    torch.cuda.synchronize()
    a, b = pools["cpu"].metrics.completed, pools["cuda"].metrics.completed
    assert [r.rid for r in a] == [r.rid for r in b]
    for x, y in zip(a, b):
        assert x.t_completed == y.t_completed
        if x.result_ids is not None:
            np.testing.assert_array_equal(x.result_ids, y.result_ids)
    assert pools["cpu"].cache_meta == pools["cuda"].cache_meta


def test_move_replica_on_card_matches_cpu(cuda):
    """``_move_replica`` with the donor's children in flight: they are
    evicted off its lane and resume on the shard's other replica; the
    replacement lane holds the new shard's index whole."""
    from repro_torch.core import VectorRequest

    db, queries = _small_corpus()
    pools = {}
    for dev in ("cpu", "cuda"):
        pool = _sharded_pool(dev, db, rebalance_enabled=True,
                             rebalance_hot_factor=1e18, nprobe_shards=1)
        for i in range(24):  # a burst at one shard: slots and a queue
            pool.submit(VectorRequest(
                i, "prefill", queries[0] + np.float32(1e-3 * (i % 7)), 0.0,
                1.0))

        def donor_load():
            low = {}
            for r in pool.replicas:
                low[r.shard] = min(low.get(r.shard, 1 << 30),
                                   len(r.in_flight))
            return max(low.items(), key=lambda kv: kv[1])

        t = 0.0
        while donor_load()[1] == 0:
            t += 2e-5
            assert t < 0.05
            pool.run_until(t)
        src, n = donor_load()
        dst = (src + 1) % 4
        pool._move_replica(src, dst, t)
        moved = [c for c in pool.lane_copies if c[0] == "move"]
        assert len(moved) == 1 and moved[0][1] == dst and moved[0][2] > 0
        assert len(pool.shard_replicas(src)) == 1
        assert 0 < sum(r.checkpoint is not None for r in
                       pool.schedulers[src].queued_requests()) <= n
        _lanes_hold_shards(pool)
        pool.run_until(1.0)
        pools[dev] = pool
    torch.cuda.synchronize()
    a, b = pools["cpu"].metrics.completed, pools["cuda"].metrics.completed
    assert sorted(r.rid for r in b) == list(range(24))
    assert [(r.rid, r.t_completed) for r in a] == \
        [(r.rid, r.t_completed) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.result_ids, y.result_ids)
    assert pools["cuda"].metrics.resumes == pools["cpu"].metrics.resumes > 0


def test_fixture_cluster_on_card_matches_cpu(cuda):
    """``make_sharded_pool_sim`` at its fixture size with the autoscaler,
    rebalancing, the cache backup and the sanitizer, and a fault of each
    pool kind and a decode kill: the card's run equals the CPU's over the
    same shard graphs (summary, signals, scale events, every vector
    request's time and ids)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import AutoscalerConfig
    from repro_torch.serving.chaos import ChaosInjector, FaultEvent
    from repro_torch.serving.cluster import make_sharded_pool_sim
    from repro_torch.serving.traffic import (BULK_PREFILL, TenantSpec,
                                             TrafficGenerator, constant)

    over = dict(sanitizer_enabled=True, rebalance_enabled=True,
                cache_backup_enabled=True)
    ctl = AutoscalerConfig(gpu_budget=12, ttft_slo_s=0.15, tpot_slo_s=0.008,
                           window_s=0.3, cold_factor=0.5, cooldown_up_s=0.06,
                           cooldown_down_s=0.12, itl_protect_factor=1.2)
    faults = [FaultEvent(0.075, "kill_replica", duration=0.025),
              FaultEvent(0.11, "straggle_replica", factor=8.0,
                         duration=0.025),
              FaultEvent(0.175, "lose_shard", duration=0.025),
              FaultEvent(0.2, "kill_decode", duration=1e3)]
    model = get_config("phi3-medium-14b")
    runs, index = {}, None
    for dev in ("cpu", "cuda"):
        sim, _, _ = make_sharded_pool_sim(
            model, pool_overrides=over, device=dev, autoscaler=ctl,
            shard_index=None if index is None else index.clone(dev))
        if index is None:
            index = sim.vector_pool.shards.clone("cpu")
        reqs = TrafficGenerator(constant(80.0), [TenantSpec(
            "rag_chat", prompt_len=(64, 512), max_new_tokens=(8, 16),
            rag_interval=4, repeat_p=0.5, prompt_pool=3), BULK_PREFILL],
            seed=0).generate(0.25)
        ChaosInjector(faults, seed=0).arm(sim)
        for r in reqs:
            sim.arrive(r)
        sim.run(0.8)
        assert sorted(r.rid for r in sim.metrics.finished) == \
            [r.rid for r in reqs]
        sim.vector_pool.sanitizer.assert_clean()
        runs[dev] = (sim.metrics.summary(0.8),
                     [dataclasses.asdict(s) for s in
                      sim.autoscaler.signals_log],
                     [dataclasses.asdict(e) for e in
                      sim.metrics.scale_events],
                     [(r.rid, r.t_completed, None if r.result_ids is None
                       else np.asarray(r.result_ids).tolist())
                      for r in sim.vector_pool.metrics.completed])
    assert runs["cuda"] == runs["cpu"]
    assert runs["cpu"][2]  # the controller acted


def _needs_grad_inputs(dev):
    """One call of each kernel dispatcher, its first input made to require
    grad when asked."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, grad=False):
        return torch.randn(shape, generator=g, device=dev).requires_grad_(grad)

    def ids(hi):
        return torch.randint(0, hi, (256,), generator=g, device=dev,
                             dtype=torch.int32)

    return {
        "flash_attention": lambda grad: ops.flash_attention(
            randn(1, 64, 4, 64, grad=grad), randn(1, 64, 2, 64),
            randn(1, 64, 2, 64)),
        "decode_attention": lambda grad: ops.decode_attention(
            randn(1, 4, 64, grad=grad), randn(1, 64, 2, 64),
            randn(1, 64, 2, 64), 5),
        "distance_tasks": lambda grad: ops.distance_tasks(
            randn(512, 64, grad=grad), randn(16, 64), ids(512), ids(16)),
        "distance_tasks_group": lambda grad: ops.distance_tasks_group(
            randn(2, 512, 64, grad=grad), randn(2, 16, 64),
            ids(512).reshape(1, -1).repeat(2, 1),
            ids(16).reshape(1, -1).repeat(2, 1)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "distance_tasks", "distance_tasks_group"])
def test_ops_refuse_inputs_that_need_a_gradient_on_card(cuda, name):
    """A CUDA input that requires grad never reaches the ctypes-bound
    kernel (it has no backward) while autograd is on; under no_grad the
    kernel launches."""
    call = _needs_grad_inputs(cuda)[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        assert torch.isfinite(call(True)).all()



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,cur_len", [
    (4, 544, 40, 10, 128, 543), (4, 544, 40, 10, 128, 0),  # phi3
    (4, 544, 16, 16, 256, 543),  # gemma-7b
    (4, 544, 64, 8, 128, 543), (4, 544, 64, 8, 128, 100),  # jamba, g 8
    (2, 40, 12, 1, 16, 17), (2, 300, 14, 2, 64, 299)])
def test_decode_attention_lse_matches_plain(cuda, dtype, B, S, H, Hkv, hd,
                                            cur_len):
    """B4 with ``return_lse``: its output (float32, unrounded) rounded to
    q's dtype equals the launch without lse bit for bit, and out and lse
    (float32, natural log of each head's sum of exp of its scaled scores)
    match the plain version; one launch, counted under both names."""
    from repro_torch.kernels import decode_attention, ops, ref

    q = _randn((B, H, hd), 15, dtype, cuda)
    k = _randn((B, S, Hkv, hd), 16, dtype, cuda)
    v = _randn((B, S, Hkv, hd), 17, dtype, cuda)
    before = dict(decode_attention.launches)
    out, lse = ops.decode_attention(q, k, v, cur_len, return_lse=True)
    plain = ops.decode_attention(q, k, v, cur_len)
    want, want_lse = ref.decode_attn_ref(q, k, v, cur_len, return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention.launches["decode_attention"] == \
        before["decode_attention"] + 2
    assert decode_attention.launches["decode_attention_lse"] == \
        before["decode_attention_lse"] + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert out.dtype == want.dtype == torch.float32
    assert torch.equal(out.to(dtype), plain)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M", [2, 4, 8])
@pytest.mark.parametrize("cur_len", [543, 300, 40])
def test_decode_attention_slices_combine_to_one_launch(cuda, M, cur_len):
    """phi3's bf16 cache (4, 544, 10, 128) cut into M slices at multiples of
    544 / M (inside a 32-position tile), each slice with a valid position
    one B4 launch with lse (slices past cur_len launch nothing), combined
    by the seqshard core's arithmetic (``sharding.merge_stacked``): equal
    to one launch with lse over the whole (float32, unrounded) within
    1e-3, its lse too."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops

    B, S, H, Hkv, hd = 4, 544, 40, 10, 128
    q = _randn((B, H, hd), 25, torch.bfloat16, cuda)
    k = _randn((B, S, Hkv, hd), 26, torch.bfloat16, cuda)
    v = _randn((B, S, Hkv, hd), 27, torch.bfloat16, cuda)
    whole, whole_lse = ops.decode_attention(q, k, v, cur_len,
                                            return_lse=True)
    S_loc = S // M
    parts = [ops.decode_attention(q, k[:, i * S_loc:(i + 1) * S_loc],
                                  v[:, i * S_loc:(i + 1) * S_loc],
                                  cur_len - i * S_loc, return_lse=True)
             for i in range(M) if cur_len - i * S_loc >= 0]
    lse = torch.stack([p[1] for p in parts])
    m = lse.max(dim=0).values
    alpha = torch.exp(lse - m)
    got = sharding.merge_stacked(lse, torch.ones_like(lse),
                                 torch.stack([p[0] for p in parts]))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, whole, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(m + torch.log(alpha.sum(0)), whole_lse,
                               rtol=1e-3, atol=1e-3)
