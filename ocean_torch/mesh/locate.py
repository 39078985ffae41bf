"""Point-to-cell location on structured triangulations (port of
``ocean_jax/mesh/locate.py``).

The owning cell of a point is an index computation on the structured
grid of squares, vectorized over any leading shape: closed form on a
uniform grid, a search over the grid lines (``torch.searchsorted``) on a
graded one. Also the inside-domain predicate (boundary inclusive,
``_EPS`` slack) that stands in for the reference's try/except around
point evaluation; with an obstacle it also asks that the point is off
the disk and that its square holds cells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .structured import Mesh2D

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Locator:
    """Device-resident tables for point location on a `Mesh2D`."""

    square_to_cell: torch.Tensor   # (ny, nx, 2) int64
    cell_v0: torch.Tensor          # (nc, 2) first vertex of each cell
    cell_jinv: torch.Tensor        # (nc, 2, 2) inverse affine Jacobian
    origin: Tuple[float, float]
    spacing: Tuple[float, float]
    grid_shape: Tuple[int, int]
    diagonal: str
    domain: str
    extent: Tuple[float, float, float, float]
    lshape_corner: Tuple[float, float] = (1.0, 1.0)
    hole: Optional[Tuple[float, float, float]] = None
    # grid lines of a graded tensor grid (None: uniform)
    xs_lines: Optional[torch.Tensor] = None       # (nx+1,) float64
    ys_lines: Optional[torch.Tensor] = None       # (ny+1,) float64

    @property
    def uniform(self) -> bool:
        return self.xs_lines is None

    @classmethod
    def from_mesh(cls, mesh: Mesh2D, device) -> "Locator":
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
            lshape_corner=mesh.lshape_corner,
            hole=mesh.hole,
            xs_lines=_lines(mesh.xs, device),
            ys_lines=_lines(mesh.ys, device),
        )


def _lines(lines, device):
    return (None if lines is None else
            torch.as_tensor(lines, dtype=torch.float64, device=device))


def _square_index(loc: Locator, px: torch.Tensor, py: torch.Tensor):
    """Owning square (ix, iy) and local coordinates (s, t) ∈ [0,1]² of
    already-clamped points: closed form on a uniform grid; on a graded one
    the count of lines ≤ p (``searchsorted(right=True)``, so a point on a
    line belongs to the square on its right, as ``floor`` gives) less one,
    clamped, and the offset over the interval's length."""
    nx, ny = loc.grid_shape
    if not loc.uniform:
        ix, s = _graded_axis(loc.xs_lines, px, nx)
        iy, t = _graded_axis(loc.ys_lines, py, ny)
        return ix, iy, s, t
    x0, y0 = loc.origin
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


def _graded_axis(lines: torch.Tensor, p: torch.Tensor, n: int):
    """One axis of the graded branch of ``_square_index``: the end points
    are gathered, then subtracted and divided (no reciprocal)."""
    i = torch.searchsorted(lines, p.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, n - 1)
    lo = lines[i]
    return i, (p - lo) / (lines[i + 1] - lo)


def in_domain(loc: Locator, points: torch.Tensor) -> torch.Tensor:
    """Inside-domain predicate (boundary inclusive, ``_EPS`` slack). With
    an obstacle a point must also be off the disk (tested on the raw
    position) and its square, located from the clamped position, must
    hold cells: the fringe between the disk and the staircase of removed
    squares has no owning cell, so evaluation there would fail."""
    x, y = points[..., 0], points[..., 1]
    xmin, ymin, xmax, ymax = loc.extent
    ok = ((x >= xmin - _EPS) & (x <= xmax + _EPS)
          & (y >= ymin - _EPS) & (y <= ymax + _EPS))
    if loc.domain == "lshape":
        cx, cy = loc.lshape_corner
        ok = ok & ((y <= cy + _EPS) | (x >= cx - _EPS))
    if loc.hole is not None:
        hx_, hy_, r = loc.hole
        ok = ok & (((x - hx_) ** 2 + (y - hy_) ** 2) >= r * r)
        px = torch.clamp(x, xmin, xmax)
        py = torch.clamp(y, ymin, ymax)
        ix, iy, _, _ = _square_index(loc, px, py)
        ok = ok & (loc.square_to_cell[iy, ix, 0] >= 0)
    return ok


def lshape_projection(loc: Locator) -> float:
    """The y that points of the L-shape's missing block are located at:
    half a square below the inner corner."""
    return loc.lshape_corner[1] - 0.5 * loc.spacing[1]


def clamp_to_extent(loc: Locator, points: torch.Tensor):
    """Points moved onto active squares: (px, py) clamped into the
    domain's bounding box and, on the L-shape, points of the missing
    upper-left block projected down into the lower rectangle (such lanes
    are outside the domain; callers mask them)."""
    xmin, ymin, xmax, ymax = loc.extent
    px = torch.clamp(points[..., 0], xmin, xmax)
    py = torch.clamp(points[..., 1], ymin, ymax)
    if loc.domain == "lshape":
        cx, cy = loc.lshape_corner
        in_block = (px < cx) & (py > cy)
        py = torch.where(in_block, lshape_projection(loc), py)
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
    if loc.diagonal == "right":
        which = (t > s).to(torch.int64)      # upper: above v00-v11
    else:
        which = (s + t > 1.0).to(torch.int64)   # upper: above v10-v01
    cell = torch.clamp(loc.square_to_cell[iy, ix, which], min=0)
    d = torch.stack([px, py], dim=-1) - loc.cell_v0[cell]
    xi = torch.einsum("...ij,...j->...i", loc.cell_jinv[cell], d)
    return cell, xi, inside
