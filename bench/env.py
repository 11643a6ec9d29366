"""The run's surroundings: the checkout's paths, the caches kept inside
it, the card check, and the check that no JAX module was loaded."""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
SRC = ROOT / "src"

# top-level module names that the process printing a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCards(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def setup_paths() -> None:
    """Make ``bench`` and the port importable from the checkout."""
    for p in (str(SRC), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def keep_caches_inside() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port's
    own nvcc builds already go to ``build/repro_torch/``), and no library
    that loads JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(
        ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def one_thread() -> None:
    """One host thread for numpy's and torch's CPU work: the host path is
    one Python thread, and a pool of threads on a machine whose cores are
    shared only adds spread. Call before torch or numpy is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCards("torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCards(f"the cell asks for {n} cards, {have} present")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN)
