"""Architecture config registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)`` over every architecture of the JAX package: the
dense GQA family, the DeepSeek family (MoE, MLA, MTP), xLSTM, the
encoder-decoder and the mamba/attention hybrid.

Each module here is a copy of the JAX package's ``configs/<arch>.py``
(``CONFIG`` at the published size, ``SMOKE_CONFIG`` reduced for the CPU).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    DECODE_32K,
    LONG_500K,
    MULTI_POD,
    PREFILL_32K,
    SHAPES,
    SINGLE_POD,
    TRAIN_4K,
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    VectorPoolConfig,
    shapes_for,
)

# arch-id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma-7b": "gemma_7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen1.5-32b": "qwen15_32b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internvl2-1b": "internvl2_1b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "xlstm-350m": "xlstm_350m",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    """Full published-size config for ``--arch <id>``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE_CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
