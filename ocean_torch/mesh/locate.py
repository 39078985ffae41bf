"""O(1) point-to-cell location on structured triangulations (port of the
uniform branch of ``ocean_jax/mesh/locate.py``).

The owning cell of a point is a closed-form index computation on the
structured grid of squares, vectorized over any leading shape. Also the
inside-domain predicate (boundary inclusive, ``_EPS`` slack) that stands
in for the reference's try/except around point evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .structured import Mesh2D

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Locator:
    """Device-resident tables for point location on a uniform `Mesh2D`."""

    square_to_cell: torch.Tensor   # (ny, nx, 2) int64
    cell_v0: torch.Tensor          # (nc, 2) first vertex of each cell
    cell_jinv: torch.Tensor        # (nc, 2, 2) inverse affine Jacobian
    origin: Tuple[float, float]
    spacing: Tuple[float, float]
    grid_shape: Tuple[int, int]
    diagonal: str
    domain: str
    extent: Tuple[float, float, float, float]

    @classmethod
    def from_mesh(cls, mesh: Mesh2D, device) -> "Locator":
        if mesh.domain != "rect" or mesh.diagonal != "right":
            raise NotImplementedError(
                "ocean_torch locates on uniform rectangles with the 'right' "
                f"diagonal only (got {mesh.domain!r}, {mesh.diagonal!r})")
        v = mesh.cell_vertices()
        jac = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
        jinv = np.linalg.inv(jac)
        return cls(
            square_to_cell=torch.as_tensor(mesh.square_to_cell,
                                           dtype=torch.int64, device=device),
            cell_v0=torch.as_tensor(v[:, 0], dtype=torch.float64,
                                    device=device),
            cell_jinv=torch.as_tensor(jinv, dtype=torch.float64,
                                      device=device),
            origin=mesh.origin,
            spacing=mesh.spacing,
            grid_shape=mesh.grid_shape,
            diagonal=mesh.diagonal,
            domain=mesh.domain,
            extent=mesh.extent,
        )


def _square_index(loc: Locator, px: torch.Tensor, py: torch.Tensor):
    """Owning square (ix, iy) and local coordinates (s, t) ∈ [0,1]² of
    already-clamped points (closed form on the uniform grid)."""
    x0, y0 = loc.origin
    nx, ny = loc.grid_shape
    # The spacings divide as 0-dim tensors on the points' device: by a
    # Python scalar, PyTorch's CUDA kernel multiplies by the rounded
    # reciprocal instead, which is the quotient only for a spacing that
    # is a power of two. So the CPU, the card and the CUDA kernels
    # (csrc/grid.cuh::axis_f) locate alike on every grid.
    hx, hy = (torch.full((), hs, dtype=px.dtype, device=px.device)
              for hs in loc.spacing)
    fx = (px - x0) / hx
    fy = (py - y0) / hy
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 1)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 1)
    s = fx - ix.to(fx.dtype)
    t = fy - iy.to(fy.dtype)
    return ix, iy, s, t


def in_domain(loc: Locator, points: torch.Tensor) -> torch.Tensor:
    """Inside-domain predicate (boundary inclusive, ``_EPS`` slack)."""
    x, y = points[..., 0], points[..., 1]
    xmin, ymin, xmax, ymax = loc.extent
    return ((x >= xmin - _EPS) & (x <= xmax + _EPS)
            & (y >= ymin - _EPS) & (y <= ymax + _EPS))


def clamp_to_extent(loc: Locator, points: torch.Tensor):
    """Points clamped into the domain's bounding box: (px, py)."""
    xmin, ymin, xmax, ymax = loc.extent
    px = torch.clamp(points[..., 0], xmin, xmax)
    py = torch.clamp(points[..., 1], ymin, ymax)
    return px, py


def locate_points(loc: Locator, points: torch.Tensor):
    """Locate points in the mesh.

    Returns ``(cell_ids, ref_coords, inside)``; ``ref_coords`` are the
    reference-triangle coordinates (ξ, η) inside the owning cell. Points
    outside the domain get clamped-to-domain values (mask with
    ``inside``)."""
    inside = in_domain(loc, points)
    px, py = clamp_to_extent(loc, points)
    ix, iy, s, t = _square_index(loc, px, py)
    which = (t > s).to(torch.int64)      # upper triangle: above v00-v11
    cell = torch.clamp(loc.square_to_cell[iy, ix, which], min=0)
    d = torch.stack([px, py], dim=-1) - loc.cell_v0[cell]
    xi = torch.einsum("...ij,...j->...i", loc.cell_jinv[cell], d)
    return cell, xi, inside
