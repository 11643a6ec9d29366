"""Decode attention (one new token over the KV cache) as a hand-written
Hopper kernel.

``decode_attention`` replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``: single-token GQA
attention over the cache at positions ``<= cur_len``, ``cur_len`` one host
int for the whole batch. The kernel is in ``csrc/attention.cu`` (its header
gives the design and the bound on the card): one split-KV launch whose
blocks stream the cache through a TMA ring, the splits of each (b, kv
head) one thread-block cluster that merges their partials in distributed
shared memory. Its plain-PyTorch version is
``kernels/ref.py::decode_attn_ref``.

The wrapper takes CUDA tensors only: it checks every input, allocates the
output with ``torch.empty``, launches on the current stream without
synchronising (``cur_len`` never comes from the device), raises on a
launch error, and counts its calls in ``launches``. With ``return_lse`` the
same launch gives a partial for the sequence-sharded decode's combine: the
output in float32, not rounded to q's dtype, and each head's log-sum-exp
of its scaled scores; those launches are counted again under
``decode_attention_lse``.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

launches = {"decode_attention": 0, "decode_attention_lse": 0}

MAX_GROUP = 16  # query heads per kv head the kernel holds in registers
TILE = 32  # cache positions a tile, one a lane (csrc kDecTile)
BLOCK_TILES = 4  # tiles a block takes at once: one a warp
MAX_SPLIT = 8  # chunks of one (b, kv head): one portable cluster (csrc kDecMaxSplit)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 8
             + [ctypes.c_void_p])
_bound = {}  # entry name -> its ctypes function, typed once
_sms = {}  # device index -> multiprocessor count


def _entry():
    fn = _bound.get("decode")
    if fn is None:
        fn = _build.load("attention").repro_decode_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound["decode"] = fn
    return fn


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_inputs(q, k, v, cur_len) -> None:
    """Raise ValueError on anything the kernel does not take: q (B, H, hd)
    and the cache k/v (B, S, Hkv, hd) of one dtype (float32 or bfloat16) on
    one device, H a multiple of Hkv with at most ``MAX_GROUP`` query heads a
    kv head, hd in ``HEAD_DIMS``, the head dimension contiguous, and
    ``cur_len`` a non-negative int; the cache's base and strides 16-byte
    aligned (the kernel reads it by TMA)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,H,hd) and k, v (B,S,Hkv,hd) of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"H={H}, Hkv={Hkv}: H must be a multiple of Hkv "
                         f"with at most {MAX_GROUP} query heads per kv head")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}; q, k, v must share one "
                             f"dtype of {tuple(DTYPES)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    for name, t in (("k", k), ("v", v)):
        elt = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) * elt % 16 for i in range(3)):
            raise ValueError(f"{name}'s base and strides must be 16-byte "
                             f"aligned")
    if not isinstance(cur_len, numbers.Integral) or cur_len < 0:
        raise ValueError(f"cur_len must be a non-negative int (a host value),"
                         f" got {cur_len!r}")
    if B == 0 or k.shape[1] == 0:
        raise ValueError("q and the cache must be non-empty")


def split_plan(n_blocks_bh: int, n_valid: int, sms: int):
    """(n_split, chunk): cut positions [0, n_valid) into chunks of whole
    ``TILE``-position tiles, about ``BLOCK_TILES`` tiles a chunk (a tile
    for each warp of a block), but more and smaller chunks while
    n_blocks_bh * n_split blocks would not cover the ``sms`` SMs; at most
    ``MAX_SPLIT`` chunks, none empty."""
    tiles = -(-n_valid // TILE)
    n_split = min(MAX_SPLIT, tiles,
                  max(-(-tiles // BLOCK_TILES), -(-sms // n_blocks_bh)))
    chunk = -(-(-(-n_valid // n_split)) // TILE) * TILE
    return -(-n_valid // chunk), chunk


def decode_attention(q, k, v, cur_len: int, return_lse: bool = False):
    """(B, H, hd) attention of the new token in ``q.dtype``; with
    ``return_lse`` (out (B, H, hd) float32, lse (B, H) float32): the output
    unrounded and each head's natural-log log-sum-exp of its scores over
    positions <= cur_len (scaled by 1/sqrt(hd))."""
    check_inputs(q, k, v, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention takes CUDA tensors, got {q.device}")
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_valid = min(int(cur_len) + 1, S)
    dev = q.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    n_split, chunk = split_plan(B * Hkv, n_valid, _sms[idx])
    out = torch.empty((B, H, hd), device=dev,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    with torch.cuda.device(dev):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), DTYPES[q.dtype], B, H,
            Hkv, hd, n_valid, n_split, chunk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    launches["decode_attention"] += 1
    if lse is None:
        return out
    launches["decode_attention_lse"] += 1
    return out, lse
