"""Device resolution for the port's entry points.

Entry points default to the first CUDA device.  The CPU is used only when the
caller asks for it (the tests pass ``device="cpu"``); there is no silent
fallback, so a run that was meant for the card cannot end up timing the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda:0``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
