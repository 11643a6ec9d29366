"""Builds the port's CUDA sources (``src/repro_torch/csrc/*.cu``) with
``nvcc`` for Hopper (``sm_90a``) and loads them with ``ctypes``.

Each source is compiled to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). A
library is built at first use, named by a hash of its source and the
flags, into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``); a later process with the same source reuses it. A failed
build raises with nvcc's output.

    load("distance")  # the ctypes.CDLL of csrc/distance.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -split-compile=0: nvcc optimizes the kernels of one source on all cores
# (attention.cu's ~60 instances build in ~40 s instead of 80-130 s)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            _compile(name, target)
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib


def _compile(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half
