"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    CUDA is the default; without a card this raises instead of silently
    running on the CPU. Pass ``device="cpu"`` to run the plain versions
    on the host (the CPU tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ocean_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
