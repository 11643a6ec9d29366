"""Device resolution shared by every constructor of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Only ``cpu`` and ``cuda`` devices are supported. Asking for CUDA on a
    machine without a usable card raises: the port never runs on the CPU
    unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev
