"""Device resolution shared by the entry points."""
from __future__ import annotations

import torch


def resolve_device(name: torch.device | str) -> torch.device:
    """``cuda`` unless the CPU is asked for; never falls back silently."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass --device cpu (device='cpu') to run on the CPU"
        )
    return device
