"""The port's prefill/decode attention on the CPU against the JAX package:
its plain versions (``kernels/ref.py``, what the dispatchers run for CPU
tensors) vs the JAX package's Pallas kernels in interpret mode and vs its
own plain versions, on ``tests/test_kernels.py``'s shape grid. Float32 to
2e-5 and bfloat16 to 2e-2 (``test_kernels.py``'s tolerances). The kernels
themselves run only on the card (``tests/test_torch_cuda.py``); here their
wrappers' input checks and their refusal of CPU tensors are tested."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _rand(shape, seed, dtype):
    """The same values to both packages: float32 from numpy, cast."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype][0]), \
        jnp.asarray(x).astype(DTYPES[dtype][1])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 32, True),
    (2, 64, 64, 4, 1, 128, False),
    (1, 128, 128, 2, 2, 256, True),  # gemma-7b's head dim
    (1, 128, 128, 4, 2, 16, True),  # the smoke configs' smallest head dim
    (2, 64, 128, 4, 2, 32, False),  # Sq < Sk and Sq > Sk, no mask
    (2, 128, 64, 4, 1, 32, False),
])
def test_flash_matches_jax(dtype, B, Sq, Sk, H, Hkv, hd, causal):
    (tq, jq), (tk, jk), (tv, jv) = (_rand(s, i, dtype) for i, s in enumerate(
        [(B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)], start=10))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == (B, Sq, H, hd)
    tol = DTYPES[dtype][2]
    pallas = j_ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                   block_k=64)
    for want in (pallas, j_ref.mha_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,Hkv,hd,cur_len", [
    (2, 256, 4, 2, 64, 100), (1, 512, 8, 1, 128, 511), (3, 128, 4, 4, 32, 0),
    (1, 64, 14, 2, 64, 200),
])
def test_decode_matches_jax(dtype, B, S, H, Hkv, hd, cur_len):
    (tq, jq), (tk, jk), (tv, jv) = (_rand(s, i, dtype) for i, s in enumerate(
        [(B, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)], start=20))
    out = ops.decode_attention(tq, tk, tv, cur_len)
    assert out.dtype == tq.dtype and out.shape == (B, H, hd)
    tol = DTYPES[dtype][2]
    pallas = j_ops.decode_attention(jq, jk, jv, cur_len, block_s=64)
    for want in (pallas, j_ref.decode_attn_ref(jq, jk, jv, cur_len)):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)


def test_decode_ignores_future_positions():
    """Garbage beyond cur_len does not change the result."""
    q, _ = _rand((1, 4, 32), 30, "float32")
    k, _ = _rand((1, 128, 4, 32), 31, "float32")
    v, _ = _rand((1, 128, 4, 32), 32, "float32")
    cur = 63
    out1 = ops.decode_attention(q, k, v, cur)
    k2, v2 = k.clone(), v.clone()
    k2[:, cur + 1:] = 1e6
    v2[:, cur + 1:] = -1e6
    torch.testing.assert_close(ops.decode_attention(q, k2, v2, cur), out1,
                               rtol=1e-6, atol=0)


def test_wrappers_refuse_cpu_tensors_and_bad_inputs():
    """A kernel wrapper never computes on the CPU, and rejects what its
    kernel does not take before any launch."""
    q = torch.zeros((1, 8, 4, 64))
    kv = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec.decode_attention(q[:, 0], kv, kv, 3)
    bad = [(q[..., :48], kv[..., :48], kv[..., :48], "head dim"),
           (q, torch.zeros((1, 8, 3, 64)), torch.zeros((1, 8, 3, 64)),
            "multiple"),
           (q.half(), kv.half(), kv.half(), "dtype"),
           (q, kv.bfloat16(), kv, "dtype"),
           (q.transpose(2, 3), kv, kv, "does not match"),
           (q[:, :0], kv, kv, "non-empty")]
    for a, b, c, msg in bad:
        with pytest.raises(ValueError, match=msg):
            fa.check_inputs(a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_inputs(q, kv.as_strided(kv.shape, (1024, 128, 1, 2)), kv)
    with pytest.raises(ValueError, match="non-negative int"):
        dec.check_inputs(q[:, 0], kv, kv, -1)
    with pytest.raises(ValueError, match="non-negative int"):
        dec.check_inputs(q[:, 0], kv, kv, torch.tensor(3))
    with pytest.raises(ValueError, match="at most 16"):
        dec.check_inputs(torch.zeros((1, 34, 64)), kv, kv, 3)
    dec.check_inputs(q[:, 0], kv, kv, np.int32(3))  # numpy ints are host ints


def test_decode_split_plan():
    """Chunks are whole tiles (``TILE`` positions), about ``BLOCK_TILES`` a
    chunk, smaller while the blocks would not cover the SMs; at most
    ``MAX_SPLIT`` chunks (one cluster), none empty, and together exactly
    the positions <= cur_len."""
    T = dec.TILE
    assert dec.split_plan(40, 544, 132) == (5, 128)
    assert dec.split_plan(40, 272, 132) == (3, 96)
    assert dec.split_plan(40, 1, 132) == (1, T)
    assert dec.split_plan(1000, 544, 132) == (5, 128)
    assert dec.split_plan(1, 4096, 132) == (dec.MAX_SPLIT, 512)
    assert dec.split_plan(4, 300, 132) == (5, 64)
    for bh in (1, 4, 40, 300):
        for n in (1, 15, 16, 17, 31, 32, 33, 100, 543, 4096):
            n_split, chunk = dec.split_plan(bh, n, 132)
            assert n_split * chunk >= n > (n_split - 1) * chunk
            assert chunk % T == 0 and n_split <= -(-n // T)
            assert n_split <= dec.MAX_SPLIT
            assert chunk <= max(T, dec.BLOCK_TILES * T,
                                -(-n // dec.MAX_SPLIT) + T)


def _meta(dtype, hd, shift=0, row_stride=None):
    """(dtype, hd, pointers, strides) of q (1, 64, 8, hd) and k/v
    (1, 64, 2, hd) as contiguous tensors would have, or with every base
    pointer shifted by ``shift`` bytes or every row stride replaced."""
    ptrs = [4096 + shift, 65536 + shift, 131072 + shift]
    strides = []
    for heads in (8, 2, 2):
        rs = heads * hd if row_stride is None else row_stride
        strides += [64 * rs, rs, hd]
    return dtype, hd, ptrs, strides


@pytest.mark.parametrize("meta,want", [
    (_meta(torch.bfloat16, 128), "flash_wgmma"),
    (_meta(torch.bfloat16, 64), "flash_wgmma"),
    (_meta(torch.bfloat16, 32), "flash_mma"),
    (_meta(torch.bfloat16, 256), "flash_wgmma256"),
    (_meta(torch.bfloat16, 256, row_stride=8 * 256 + 4), "flash_mma"),
    (_meta(torch.bfloat16, 256, shift=2), "flash_mma"),
    (_meta(torch.bfloat16, 128, shift=8), "flash_mma"),
    (_meta(torch.bfloat16, 128, row_stride=8 * 128 + 4), "flash_mma"),
    (_meta(torch.bfloat16, 64, row_stride=8 * 64 + 8), "flash_wgmma"),
    (_meta(torch.float32, 128), "flash_fp32"),
    (_meta(torch.float32, 128, shift=4), "flash_fp32"),
])
def test_flash_variant_rule(meta, want):
    """Which hand-written B3 variant a call takes, from dtype, hd,
    alignment and strides alone (the rule the C entry point applies)."""
    assert fa.flash_variant(*meta) == want


def test_flash_variant_of_tensors():
    """The rule read off CPU tensors' metadata: contiguous projections and
    views of a fused projection are TMA-able; an odd row stride is not."""
    q = torch.zeros((4, 32, 40, 128), dtype=torch.bfloat16)
    kv = torch.zeros((4, 32, 10, 128), dtype=torch.bfloat16)
    assert fa.variant_of(q, kv, kv) == "flash_wgmma"
    assert fa.variant_of(q.float(), kv.float(), kv.float()) == "flash_fp32"
    qkv = torch.zeros((2, 16, 8, 64), dtype=torch.bfloat16)
    assert fa.variant_of(qkv[:, :, :4], qkv[:, :, 4:6],
                         qkv[:, :, 6:]) == "flash_wgmma"
    buf = torch.zeros((2, 16, 8 * 64 + 4), dtype=torch.bfloat16)
    heads = buf[..., :8 * 64].unflatten(-1, (8, 64))
    assert fa.variant_of(heads[:, :, :4], heads[:, :, 4:6],
                         heads[:, :, 6:]) == "flash_mma"
    q256 = torch.zeros((4, 32, 16, 256), dtype=torch.bfloat16)
    assert fa.variant_of(q256, q256, q256) == "flash_wgmma256"
    buf = torch.zeros((2, 16, 6 * 256 + 4), dtype=torch.bfloat16)
    heads = buf[..., :6 * 256].unflatten(-1, (6, 256))
    assert fa.variant_of(heads[:, :, :2], heads[:, :, 2:4],
                         heads[:, :, 4:]) == "flash_mma"
    assert set(fa.launches) == {"flash_attention", *fa.VARIANTS}


def test_decode_refuses_unaligned_cache():
    """The decode kernel reads the cache by TMA: a cache view whose base or
    strides are not 16-byte aligned is refused before any launch."""
    q = torch.zeros((1, 4, 64))
    kv = torch.zeros((1, 8, 2, 64))
    dec.check_inputs(q, kv, kv, 3)
    shifted = torch.zeros(1 * 8 * 2 * 64 + 1)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        dec.check_inputs(q, shifted, kv, 3)
    wide = torch.zeros((1, 8, 2, 65))[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        dec.check_inputs(q, kv, wide, 3)
