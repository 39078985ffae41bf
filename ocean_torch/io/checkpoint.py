"""Control/field checkpointing (port of ``ocean_jax/io/checkpoint.py``).

``.npz`` archives with the JAX package's file names and keys, so a
checkpoint written by either package loads in the other:

  1. per-iteration control checkpoint: ``checkpoints/q.npz`` holds the
     LATEST control (the resume source) and ``checkpoints/q_history.npz``
     the full per-iteration time series,
  2. cross-run warm start: ``q_backup/q.npz`` (``load_q`` loads another
     experiment's final control),
  3. final field checkpoints for reruns: ``paraview/checkpoint/up.npz``.

The checkpoint also stores the running learning rate and iteration index,
so a resumed run can continue the LR schedule. A legacy dolfin HDF5
checkpoint (``q_backup/q.h5``) warm-starts through
``load_dolfin_control``, which needs the mesh (and h5py).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import control as ctrl_mod
from .. import convert
from ..control import Control
from ..fem.spaces import TaylorHoodSpace, BoundaryQuad


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_control(path: str, ctrl: Control, lr: float = None,
                 iteration: int = None) -> None:
    data = {"quad": _np(ctrl.quad), "p2": _np(ctrl.p2)}
    if lr is not None:
        data["lr"] = np.asarray(lr)
    if iteration is not None:
        data["iteration"] = np.asarray(iteration)
    np.savez(path, **data)


def append_control_history(path: str, ctrl: Control, lr: float = None,
                           iteration: int = None) -> int:
    """Append one iteration's control to a growing ``q_history.npz`` time
    series. Returns the new history length."""
    quad = _np(ctrl.quad)[None]
    p2 = _np(ctrl.p2)[None]
    lr_v = np.asarray([np.nan if lr is None else float(lr)])
    it_v = np.asarray([-1 if iteration is None else int(iteration)])
    if os.path.exists(path):
        with np.load(path) as data:
            quad = np.concatenate([data["quad"], quad])
            p2 = np.concatenate([data["p2"], p2])
            lr_v = np.concatenate([data["lr"], lr_v])
            it_v = np.concatenate([data["iteration"], it_v])
    np.savez(path, quad=quad, p2=p2, lr=lr_v, iteration=it_v)
    return len(it_v)


def load_control_history(path: str):
    """Load the per-iteration control series → (quads, p2s, lrs, iters)
    as numpy arrays."""
    with np.load(path) as data:
        return (np.asarray(data["quad"]), np.asarray(data["p2"]),
                np.asarray(data["lr"]), np.asarray(data["iteration"]))


def load_control(path: str, space: TaylorHoodSpace, bq: BoundaryQuad
                 ) -> Tuple[Control, Optional[float], Optional[int]]:
    """Load a control checkpoint onto the space's device: (control, lr or
    None, iteration or None). A dolfin checkpoint needs the mesh: it
    raises ``ValueError`` naming ``load_dolfin_control``, as in the JAX
    package."""
    if path.endswith((".h5", ".xdmf")):
        raise ValueError(
            "dolfin checkpoints need the mesh; use load_dolfin_control")
    ctrl, lr, it = convert.control_checkpoint(path, space.device)
    if (ctrl.quad.shape != bq.points.shape
            or ctrl.p2.shape != (space.n_p2, 2)):
        raise ValueError(
            f"control checkpoint {path} has shapes {tuple(ctrl.quad.shape)}, "
            f"{tuple(ctrl.p2.shape)}; this problem needs "
            f"{tuple(bq.points.shape)}, {(space.n_p2, 2)}")
    return ctrl, lr, it


def load_dolfin_control(path: str, mesh, space: TaylorHoodSpace,
                        bq: BoundaryQuad, name: str = "f") -> Control:
    """Warm-start from a legacy-dolfin ``q_backup/q.h5`` control
    checkpoint on this mesh (``dolfin_h5.read_checkpoint_velocity``)."""
    from .dolfin_h5 import read_checkpoint_velocity
    q = read_checkpoint_velocity(path, mesh, space, name)
    return ctrl_mod.from_p2(space, bq, torch.as_tensor(
        q, dtype=torch.float64, device=space.device))


def save_fields(path: str, w, space: TaylorHoodSpace) -> None:
    """Final (u, p) checkpoint of a mixed state ``w``."""
    w = _np(w)
    u = w[: 2 * space.n_p2].reshape(space.n_p2, 2)
    p = w[2 * space.n_p2:]
    np.savez(path, u=u, p=p, w=w)
