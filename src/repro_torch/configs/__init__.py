"""Architecture config registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)`` over the architectures it serves: the dense GQA
family and the DeepSeek family (MoE, MLA, MTP).

Each module here is a copy of the JAX package's ``configs/<arch>.py``
(``CONFIG`` at the published size, ``SMOKE_CONFIG`` reduced for the CPU).
The other architectures of the JAX package belong to model families the
port does not run yet; asking for one raises ``KeyError`` naming the
ROADMAP item that ports its family.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    MLAConfig,
    ModelConfig,
    MoEConfig,
    VectorPoolConfig,
)

# arch-id -> module name (block_kind="attn": the dense GQA family and the
# DeepSeek family's MoE, MLA and MTP)
_ARCH_MODULES: Dict[str, str] = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma-7b": "gemma_7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen1.5-32b": "qwen15_32b",
    "internvl2-1b": "internvl2_1b",
}

# arch-id -> family, for the JAX package's archs the port does not serve yet
_NOT_PORTED: Dict[str, str] = {
    "seamless-m4t-large-v2": "encoder-decoder",
    "jamba-1.5-large-398b": "mamba/attention hybrid with MoE",
    "xlstm-350m": "xLSTM",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise KeyError(
            f"arch {arch!r} ({_NOT_PORTED[arch]} family) is not ported yet: "
            "ROADMAP Queue A item 12 ports the other model families")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    """Full published-size config for ``--arch <id>``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE_CONFIG
