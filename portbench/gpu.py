"""The card's name and power limit, as ``nvidia-smi`` reports them (a frozen
copy of ``bench_torch.gpu_name_and_power``)."""
from __future__ import annotations

import subprocess


def gpu_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({type(exc).__name__})"
    return out[0].strip() if out else "not read"
