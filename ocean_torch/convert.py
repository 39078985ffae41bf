"""Carry problem state across from the JAX package's arrays.

Everything the JAX side hands over (``u_d``, ``x0``, ``center``, the
control's ``quad``/``p2``, a mixed state ``w``) arrives as array-likes —
numpy arrays, or JAX arrays that numpy converts — and becomes float64
tensors on the requested device, so both packages compute from identical
inputs. A ``Control`` of either package and a control checkpoint
(``q.npz``) written by either are carried across too. This module imports
neither JAX nor the JAX package.
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


def control(quad, p2=None, device="cpu") -> Control:
    """A ``Control`` from the JAX control's ``quad`` and ``p2`` arrays, or
    from a control object of either package (anything with ``quad`` and
    ``p2`` attributes) as the only argument. A stacked ensemble control
    (a leading member axis on both) carries across as it is."""
    if p2 is None:
        quad, p2 = quad.quad, quad.p2
    return Control(to_tensor(quad, device), to_tensor(p2, device))


def control_checkpoint(path: str, device="cpu"):
    """(Control, lr or None, iteration or None) from a ``q.npz`` control
    checkpoint written by either package (``io/checkpoint.py`` there and
    here: keys ``quad``, ``p2`` and optionally ``lr``, ``iteration``)."""
    with np.load(path) as data:
        ctrl = control(data["quad"], data["p2"], device)
        lr = float(data["lr"]) if "lr" in data else None
        it = int(data["iteration"]) if "iteration" in data else None
    return ctrl, lr, it


def problem_data(u_d, x0, device="cpu"):
    """(u_d (K, nt, 2), x0 (K, 2)) as float64 tensors: stored measurements
    on the square, or what the JAX package's ``lshape_ud`` returns on the
    L-shape."""
    u_d, x0 = to_tensor(u_d, device), to_tensor(x0, device)
    if (u_d.ndim != 3 or u_d.shape[-1] != 2
            or x0.shape != (u_d.shape[0], 2)):
        raise ValueError(f"u_d {tuple(u_d.shape)} / x0 {tuple(x0.shape)}: "
                         "expected (K, nt, 2) and (K, 2)")
    return u_d, x0
