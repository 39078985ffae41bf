"""Carry problem state across from the JAX package's arrays.

Everything the JAX side hands over (``u_d``, ``x0``, ``center``, the
control's ``quad``/``p2``, a mixed state ``w``) arrives as array-likes —
numpy arrays, or JAX arrays that numpy converts — and becomes float64
tensors on the requested device, so both packages compute from identical
inputs. This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .control import Control
from .device import resolve_device


def to_tensor(a, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """Array-like → contiguous tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=resolve_device(device)).contiguous()


def control(quad, p2, device="cpu") -> Control:
    """A ``Control`` from the JAX control's ``quad`` and ``p2`` arrays."""
    return Control(to_tensor(quad, device), to_tensor(p2, device))


def problem_data(u_d, x0, device="cpu"):
    """(u_d (K, nt, 2), x0 (K, 2)) as float64 tensors."""
    return to_tensor(u_d, device), to_tensor(x0, device)
