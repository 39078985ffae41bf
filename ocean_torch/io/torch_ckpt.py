"""``torch.save`` checkpoint backend (the counterpart of
``ocean_jax/io/orbax_ckpt.py``).

An alternative to the ``.npz`` control checkpoints of ``io.checkpoint``
for long-running deployments. The payload and semantics are the Orbax
module's: the control's quad and p2 values, the running LR (NaN for
None) and the iteration (−1 for None). As Orbax does, a write is atomic:
the payload goes to a temporary file in the target's directory, which
``os.replace`` then moves onto ``path``, so an interrupted write leaves
the previous checkpoint readable. Loading uses ``weights_only=True`` and
puts the control on the card unless the caller asks for another device.

The on-disk format is one ``torch.save`` file, not an Orbax directory:
reading an Orbax checkpoint needs ``orbax`` and ``jax``, which the port
does not import.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Optional, Tuple

import torch

from ..control import Control
from ..device import resolve_device


def save_control(path: str, ctrl: Control, lr: Optional[float] = None,
                 iteration: Optional[int] = None) -> None:
    """Write the checkpoint file ``path`` (atomic)."""
    payload = {"quad": ctrl.quad.detach().cpu(),
               "p2": ctrl.p2.detach().cpu(),
               "lr": float("nan") if lr is None else float(lr),
               "iteration": -1 if iteration is None else int(iteration)}
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(payload, fh)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_control(path: str, device="cuda"
                 ) -> Tuple[Control, Optional[float], Optional[int]]:
    """(control, lr or None, iteration or None) of a checkpoint file, on
    ``device``: the card by default (raises without one unless
    ``device="cpu"``); a caller that holds a space passes
    ``device=space.device``."""
    data = torch.load(os.path.abspath(path),
                      map_location=resolve_device(device), weights_only=True)
    lr, it = data["lr"], data["iteration"]
    return (Control(data["quad"], data["p2"]),
            None if math.isnan(lr) else lr,
            None if it < 0 else it)
