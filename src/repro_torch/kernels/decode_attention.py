"""Decode attention (one new token over the KV cache) as a hand-written
Hopper kernel.

``decode_attention`` replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``: single-token GQA
attention over the cache at positions ``<= cur_len``, ``cur_len`` one host
int for the whole batch. The kernel is in ``csrc/attention.cu`` (its header
gives the design and the bound on the card): a split-KV pass and a combine
pass, two launches that count as one call. Its plain-PyTorch version is
``kernels/ref.py::decode_attn_ref``.

The wrapper takes CUDA tensors only: it checks every input, allocates the
output and the f32 partials with ``torch.empty``, launches on the current
stream without synchronising (``cur_len`` never comes from the device),
raises on a launch error, and counts its calls in ``launches``.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

launches = {"decode_attention": 0}

MAX_GROUP = 16  # query heads per kv head the kernel holds in registers
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 8
             + [ctypes.c_void_p])
_bound = {}  # entry name -> its ctypes function, typed once
_sms = {}  # device index -> multiprocessor count


def _lib():
    if not _bound:
        lib = _build.load("attention")
        fn = lib.repro_decode_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        per = lib.repro_decode_partials_per_split
        per.argtypes = [ctypes.c_int]
        per.restype = ctypes.c_int
        _bound.update(decode=fn, per_split=per)
    return _bound


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_inputs(q, k, v, cur_len) -> None:
    """Raise ValueError on anything the kernel does not take: q (B, H, hd)
    and the cache k/v (B, S, Hkv, hd) of one dtype (float32 or bfloat16) on
    one device, H a multiple of Hkv with at most ``MAX_GROUP`` query heads a
    kv head, hd in ``HEAD_DIMS``, the head dimension contiguous, and
    ``cur_len`` a non-negative int."""
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
    if not isinstance(cur_len, numbers.Integral) or cur_len < 0:
        raise ValueError(f"cur_len must be a non-negative int (a host value),"
                         f" got {cur_len!r}")
    if B == 0 or k.shape[1] == 0:
        raise ValueError("q and the cache must be non-empty")


def split_plan(n_blocks_bh: int, n_valid: int, sms: int):
    """(n_split, chunk): cut positions [0, n_valid) into chunks so that
    n_blocks_bh * n_split blocks come to about two per SM, with no more
    chunks than ceil(n_valid / 16) and no empty chunk."""
    want = max(1, -(-2 * sms // n_blocks_bh))
    n_split = max(1, min(want, -(-n_valid // 16)))
    chunk = -(-n_valid // n_split)
    return -(-n_valid // chunk), chunk


def decode_attention(q, k, v, cur_len: int):
    """(B, H, hd) attention of the new token in ``q.dtype``."""
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
    lib = _lib()
    n_part = n_split * lib["per_split"](hd)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    part_acc = torch.empty((B, H, n_part, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((2, B, H, n_part), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib["decode"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
            DTYPES[q.dtype], B, H, Hkv, hd, n_valid, n_split, chunk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    launches["decode_attention"] += 1
    return out
