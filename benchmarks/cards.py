"""Name and power limit of the machine's NVIDIA cards, for the scripts that
report a time beside the card it was taken on."""

from __future__ import annotations

import subprocess


def card_names() -> str:
    """Name and power limit of every card, from ``nvidia-smi`` in a child
    process that stays off JAX (so it holds no device memory)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())
