"""Point evaluation of FE fields and boundary-quad restriction (port of
``ocean_jax/fem/interpolate.py``).

Batched O(1) structured point location + basis contraction over any
leading shape of points.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..mesh.locate import locate_points
from .spaces import TaylorHoodSpace, BoundaryQuad


def p2_basis(xi: torch.Tensor) -> torch.Tensor:
    """P2 basis at reference points: (..., 2) → (..., 6)."""
    x, y = xi[..., 0], xi[..., 1]
    l0 = 1.0 - x - y
    return torch.stack([
        l0 * (2 * l0 - 1), x * (2 * x - 1), y * (2 * y - 1),
        4 * x * y, 4 * l0 * y, 4 * l0 * x,
    ], dim=-1)


def p1_basis(xi: torch.Tensor) -> torch.Tensor:
    """P1 basis at reference points: (..., 2) → (..., 3)."""
    x, y = xi[..., 0], xi[..., 1]
    return torch.stack([1.0 - x - y, x, y], dim=-1)


def eval_velocity(space: TaylorHoodSpace, u: torch.Tensor,
                  points: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a P2 velocity field at points. u: (n_p2, 2); points
    (..., 2) → (values (..., 2), inside (...,)). Out-of-domain lanes get
    clamped-evaluation values; mask them with ``inside``."""
    cell, xi, inside = locate_points(space.locator, points)
    phi = p2_basis(xi)
    dofs = space.cell_dofs_p2[cell]
    vals = torch.einsum("...a,...ai->...i", phi, u[dofs])
    return vals, inside


def eval_p1_tensor(space: TaylorHoodSpace, g: torch.Tensor,
                   points: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a P1 tensor field (the projected ∇u) at points.
    g: (n_p1, 2, 2) → (values (..., 2, 2), inside); value[i, j] =
    ∂u_i/∂x_j."""
    cell, xi, inside = locate_points(space.locator, points)
    phi = p1_basis(xi)
    dofs = space.cell_dofs_p1[cell]
    vals = torch.einsum("...a,...aij->...ij", phi, g[dofs])
    return vals, inside


def eval_velocity_basis(space: TaylorHoodSpace, points: torch.Tensor):
    """Point location and P2 basis values at points (..., 2), for point
    sources (the transpose of interpolation): (cell, dofs (..., 6),
    phi (..., 6), inside)."""
    cell, xi, inside = locate_points(space.locator, points)
    return cell, space.cell_dofs_p2[cell], p2_basis(xi), inside


def boundary_eval_velocity(space: TaylorHoodSpace, bq: BoundaryQuad,
                           u: torch.Tensor) -> torch.Tensor:
    """Restrict a P2 velocity field to the Γ₁ quadrature points
    (nf, nq, 2); exact for P2 fields."""
    dofs = space.cell_dofs_p2[bq.cells]
    return torch.einsum("fqa,fai->fqi", bq.phi2, u[dofs])


def interpolate_p2(space: TaylorHoodSpace, fn) -> torch.Tensor:
    """Interpolate an analytic vector expression (numpy (n, 2) → (n, 2))
    into P2 dof values."""
    coords = space.dof_coords_p2.cpu().numpy()
    return torch.as_tensor(np.array(fn(coords), dtype=np.float64),
                           device=space.device)
