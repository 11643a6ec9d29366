"""Prefill attention as a hand-written Hopper kernel.

``flash_attention`` replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``: blocked causal GQA
attention with an online softmax. The kernel is in ``csrc/attention.cu``
(its header gives the design and the bound on the card); its plain-PyTorch
version is ``kernels/ref.py::mha_ref``.

The kernel has four hand-written variants, chosen by one rule
(``flash_variant``, the same rule as ``csrc/attention.cu::flash_variant``):
``flash_wgmma`` (bf16 at hd 64 or 128 with 16-byte aligned bases and
strides: wgmma fed by a TMA ring), ``flash_wgmma256`` (the same at hd 256:
a producer warpgroup hands its registers to the consumers),
``flash_mma`` (any other bf16: ``mma.sync`` fed by ``cp.async``) and
``flash_fp32`` (float32, on the tensor cores by 3xTF32). There is no
fallback between them: the C entry point reports the variant it launched,
and the wrapper raises if that is not the rule's.

The wrapper takes CUDA tensors only: it checks every input, allocates the
output with ``torch.empty``, launches on the current stream without
synchronising, raises on a launch error, and counts its launches in
``launches``: the total under ``"flash_attention"`` and each variant under
its name. q, k and v are read through their strides (the last dimension
must be contiguous), so views of the projections need no copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel name -> launches since the last reset (read by chip_smoke.py to
# prove the serving path went through the kernel)
VARIANTS = ("flash_fp32", "flash_mma", "flash_wgmma",  # the C entry's codes
            "flash_wgmma256")
launches = {"flash_attention": 0, **{name: 0 for name in VARIANTS}}

HEAD_DIMS = (16, 32, 64, 128, 256)
# head dim -> the wgmma variant that takes it (TMA-aligned bf16 only)
WGMMA_BY_HD = {64: "flash_wgmma", 128: "flash_wgmma", 256: "flash_wgmma256"}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 9
             + [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_bound = {}  # entry name -> its ctypes function, typed once


def _entry():
    fn = _bound.get("flash")
    if fn is None:
        fn = _build.load("attention").repro_flash_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound["flash"] = fn
    return fn


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_inputs(q, k, v) -> None:
    """Raise ValueError on anything the kernel does not take: q
    (B, Sq, H, hd) and k/v (B, Sk, Hkv, hd) of one dtype (float32 or
    bfloat16) on one device, H a multiple of Hkv, hd in ``HEAD_DIMS``,
    the head dimension contiguous, and no empty dimension."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Sq,H,hd) and k, v (B,Sk,Hkv,hd) of "
                         f"one shape, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}; q, k, v must share one "
                             f"dtype of {tuple(DTYPES)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    if min(B, Sq, k.shape[1]) == 0:
        raise ValueError("q and k must be non-empty")


def flash_variant(dtype, hd: int, data_ptrs, strides) -> str:
    """The variant the kernel takes for these inputs: ``flash_fp32`` for
    float32; for bfloat16 when every base pointer is 16-byte aligned and
    every stride (batch, row and head of q, k and v, in elements) a
    positive multiple of 8 elements, as TMA needs, ``flash_wgmma`` at hd
    64 or 128 and ``flash_wgmma256`` at hd 256; else ``flash_mma``. Plain
    metadata, so it runs on the CPU."""
    if dtype == torch.float32:
        return "flash_fp32"
    aligned = (all(p % 16 == 0 for p in data_ptrs)
               and all(s > 0 and s % 8 == 0 for s in strides))
    return WGMMA_BY_HD.get(hd, "flash_mma") if aligned else "flash_mma"


def variant_of(q, k, v) -> str:
    """``flash_variant`` of three tensors (on any device)."""
    return flash_variant(q.dtype, q.shape[3],
                         [t.data_ptr() for t in (q, k, v)],
                         [t.stride(i) for t in (q, k, v) for i in range(3)])


def flash_attention(q, k, v, causal: bool = True):
    """(B, Sq, H, hd) attention output in ``q.dtype``; one kernel launch."""
    check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got {q.device}")
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    want = variant_of(q, k, v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    fn = _entry()
    ran = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPES[q.dtype], B, Sq, Sk, H, Hkv, hd,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2), int(bool(causal)),
                 ctypes.byref(ran),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    if not 0 <= ran.value < len(VARIANTS) or VARIANTS[ran.value] != want:
        raise RuntimeError(f"flash_attention launched variant {ran.value}, "
                           f"the rule says {want}")
    launches["flash_attention"] += 1
    launches[want] += 1
    return out
