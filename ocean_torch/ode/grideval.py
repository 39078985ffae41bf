"""Table-free FE point evaluation on the structured P2 half-grid (port of
``ocean_jax/ode/grideval.py``).

Every scalar P2 dof of a structured triangulation sits on a node of the
``(2·ny+1) × (2·nx+1)`` half-grid, every P1 dof on the ``(ny+1) × (nx+1)``
vertex grid. Point evaluation needs no index tables: the owning square
and local coordinates ``(s, t)`` are arithmetic, and the six active P2
basis functions are a closed-form 3×3 patch-weight stencil (the three
nodes outside the owning triangle get weight 0). These are the tables
the CUDA kernels read.

The patch sums here run in one fixed order (row b, then column a), the
order the kernels use, so a kernel and its plain version agree bit for
bit when the kernel is compiled without FMA contraction.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..fem.spaces import TaylorHoodSpace
from ..mesh.locate import (Locator, in_domain, clamp_to_extent,
                           _square_index)


@dataclasses.dataclass(frozen=True)
class GridEval:
    """Half-grid dof layout for a `TaylorHoodSpace` on a structured mesh."""

    dof_to_node: torch.Tensor   # (n_p2,) int64 flat half-grid node index
    vtx_to_node: torch.Tensor   # (n_p1,) int64 flat vertex-grid node index
    locator: Locator
    hg_shape: Tuple[int, int]   # (Hy, Hx) = (2·ny+1, 2·nx+1)
    vg_shape: Tuple[int, int]   # (ny+1, nx+1)


def _nearest_line_index(lines: np.ndarray, vals: np.ndarray,
                        what: str) -> np.ndarray:
    """Index of the grid line each value sits on (graded tensor grids:
    the lines are not evenly spaced, so a nearest-line search replaces
    the closed-form division)."""
    idx = np.clip(np.searchsorted(lines, vals), 1, len(lines) - 1)
    left_closer = (vals - lines[idx - 1]) < (lines[idx] - vals)
    idx = np.where(left_closer, idx - 1, idx)
    tol = 1e-9 * max(1.0, float(np.abs(lines).max()))
    if not np.all(np.abs(lines[idx] - vals) <= tol):
        raise ValueError(f"{what} do not lie on the structured half-grid")
    return idx.astype(np.int64)


def make_grideval(space: TaylorHoodSpace) -> GridEval:
    """Build the dof→half-grid map (host-side, one-time setup). The grid
    covers the bounding box: on the L-shape and around an obstacle the
    nodes without a dof stay zero in the images and no in-domain
    evaluation reads them with a weight other than 0. On a graded grid the
    half-grid lines interleave the vertex lines with the interval
    midpoints, where the P2 edge dofs sit."""
    loc = space.locator
    nx, ny = loc.grid_shape
    x0, y0 = loc.origin
    hx, hy = loc.spacing
    coords = space.dof_coords_p2.cpu().numpy()
    Hx, Hy = 2 * nx + 1, 2 * ny + 1
    if loc.uniform:
        gx = np.rint((coords[:, 0] - x0) / (0.5 * hx)).astype(np.int64)
        gy = np.rint((coords[:, 1] - y0) / (0.5 * hy)).astype(np.int64)
        if (gx.min() < 0 or gx.max() >= Hx or gy.min() < 0
                or gy.max() >= Hy
                or not np.allclose(coords[:, 0], x0 + gx * 0.5 * hx)
                or not np.allclose(coords[:, 1], y0 + gy * 0.5 * hy)):
            raise ValueError(
                "P2 dofs do not lie on the structured half-grid")
    else:
        xs = loc.xs_lines.cpu().numpy()
        ys = loc.ys_lines.cpu().numpy()
        xs_half = np.empty(Hx)
        xs_half[0::2] = xs
        xs_half[1::2] = 0.5 * (xs[:-1] + xs[1:])
        ys_half = np.empty(Hy)
        ys_half[0::2] = ys
        ys_half[1::2] = 0.5 * (ys[:-1] + ys[1:])
        gx = _nearest_line_index(xs_half, coords[:, 0], "P2 dofs")
        gy = _nearest_line_index(ys_half, coords[:, 1], "P2 dofs")
    node = gy * Hx + gx
    if len(np.unique(node)) != len(node):
        raise ValueError("duplicate half-grid nodes in dof map")
    n_p1 = space.n_p1
    if loc.uniform:
        vx = np.rint((coords[:n_p1, 0] - x0) / hx).astype(np.int64)
        vy = np.rint((coords[:n_p1, 1] - y0) / hy).astype(np.int64)
    else:
        vx = _nearest_line_index(xs, coords[:n_p1, 0], "P1 dofs")
        vy = _nearest_line_index(ys, coords[:n_p1, 1], "P1 dofs")
    vnode = vy * (nx + 1) + vx
    dev = space.device
    return GridEval(
        dof_to_node=torch.as_tensor(node, device=dev),
        vtx_to_node=torch.as_tensor(vnode, device=dev),
        locator=loc,
        hg_shape=(Hy, Hx),
        vg_shape=(ny + 1, nx + 1),
    )


def velocity_to_grid(ge: GridEval, u: torch.Tensor) -> torch.Tensor:
    """P2 velocity dofs (n_p2, 2) → half-grid image (Hy·Hx, 2)."""
    Hy, Hx = ge.hg_shape
    return u.new_zeros(Hy * Hx, 2).index_copy(0, ge.dof_to_node, u)


def grad_to_grid(ge: GridEval, g: torch.Tensor) -> torch.Tensor:
    """Projected P1 gradient (n_p1, 2, 2) → vertex-grid image
    ((ny+1)·(nx+1), 2, 2)."""
    Gy, Gx = ge.vg_shape
    return g.new_zeros(Gy * Gx, 2, 2).index_copy(0, ge.vtx_to_node, g)


def grid_coords(loc: Locator, points: torch.Tensor):
    """Owning square (ix, iy) and local coords (s, t) of clamped (on the
    L-shape: projected) points, in closed form or by the line search."""
    px, py = clamp_to_extent(loc, points)
    return _square_index(loc, px, py)


def _vert(l):
    return l * (2.0 * l - 1.0)


def upper_triangle(s: torch.Tensor, t: torch.Tensor,
                   diagonal: str) -> torch.Tensor:
    """Whether (s, t) lies in the square's second triangle: above the
    diagonal v00–v11 ("right"), or above v10–v01 ("left")."""
    if diagonal == "right":
        return t > s
    if diagonal == "left":
        return s + t > 1.0
    raise ValueError(f"unsupported diagonal {diagonal!r}")


def p2_patch_weights(s: torch.Tensor, t: torch.Tensor,
                     diagonal: str = "right") -> torch.Tensor:
    """Closed-form P2 basis values on the 3×3 half-grid patch of the
    owning square: W[..., b, a] multiplies node (2·iy+b, 2·ix+a).

    "right" diagonal: the lower triangle (t ≤ s) has barycentrics
    λ = (1−s, s−t, t) on vertices (0,0),(1,0),(1,1); the upper triangle
    λ = (1−t, s, t−s) on (0,0),(1,1),(0,1). "left": the lower triangle
    (s + t ≤ 1) λ = (1−s−t, s, t) on (0,0),(1,0),(0,1), the upper
    λ = (1−t, s+t−1, 1−s) on (1,0),(1,1),(0,1). Vertex dofs get λ(2λ−1),
    edge-midpoint dofs 4λᵢλⱼ."""
    upper = upper_triangle(s, t, diagonal)[..., None, None]
    z = torch.zeros_like(s)
    if diagonal == "right":
        lA, lB, lC = 1.0 - s, s - t, t
        Wl = torch.stack([
            torch.stack([_vert(lA), 4 * lA * lB, _vert(lB)], dim=-1),
            torch.stack([z, 4 * lA * lC, 4 * lB * lC], dim=-1),
            torch.stack([z, z, _vert(lC)], dim=-1),
        ], dim=-2)
        lA, lC, lD = 1.0 - t, s, t - s
        Wu = torch.stack([
            torch.stack([_vert(lA), z, z], dim=-1),
            torch.stack([4 * lA * lD, 4 * lA * lC, z], dim=-1),
            torch.stack([_vert(lD), 4 * lC * lD, _vert(lC)], dim=-1),
        ], dim=-2)
    else:
        lA, lB, lD = 1.0 - s - t, s, t
        Wl = torch.stack([
            torch.stack([_vert(lA), 4 * lA * lB, _vert(lB)], dim=-1),
            torch.stack([4 * lA * lD, 4 * lB * lD, z], dim=-1),
            torch.stack([_vert(lD), z, z], dim=-1),
        ], dim=-2)
        lB, lC, lD = 1.0 - t, s + t - 1.0, 1.0 - s
        Wu = torch.stack([
            torch.stack([z, z, _vert(lB)], dim=-1),
            torch.stack([z, 4 * lB * lD, 4 * lB * lC], dim=-1),
            torch.stack([_vert(lD), 4 * lC * lD, _vert(lC)], dim=-1),
        ], dim=-2)
    return torch.where(upper, Wu, Wl)


def p1_patch_weights(s: torch.Tensor, t: torch.Tensor,
                     diagonal: str = "right") -> torch.Tensor:
    """P1 basis values on the 2×2 vertex patch: W[..., b, a]."""
    upper = upper_triangle(s, t, diagonal)[..., None, None]
    z = torch.zeros_like(s)
    if diagonal == "right":
        Wl = torch.stack([torch.stack([1.0 - s, s - t], dim=-1),
                          torch.stack([z, t], dim=-1)], dim=-2)
        Wu = torch.stack([torch.stack([1.0 - t, z], dim=-1),
                          torch.stack([t - s, s], dim=-1)], dim=-2)
    else:
        Wl = torch.stack([torch.stack([1.0 - s - t, s], dim=-1),
                          torch.stack([t, z], dim=-1)], dim=-2)
        Wu = torch.stack([torch.stack([z, 1.0 - t], dim=-1),
                          torch.stack([1.0 - s, s + t - 1.0], dim=-1)],
                         dim=-2)
    return torch.where(upper, Wu, Wl)


def _patch_sum(W: torch.Tensor, img: torch.Tensor, base: torch.Tensor,
               stride: int) -> torch.Tensor:
    """Σ_b Σ_a W[..., b, a] · img[base + b·stride + a] in that order."""
    n = W.shape[-1]
    acc = None
    for b in range(n):
        for a in range(n):
            term = W[..., b, a, None] * img[base + (b * stride + a)]
            acc = term if acc is None else acc + term
    return acc


def eval_velocity_grid(ge: GridEval, u_grid: torch.Tensor,
                       points: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P2 velocity evaluation from the half-grid image (Hy·Hx, 2):
    (values (..., 2), inside (...,)), equal to rounding to
    ``fem.interpolate.eval_velocity``."""
    loc = ge.locator
    inside = in_domain(loc, points)
    ix, iy, s, t = grid_coords(loc, points)
    W = p2_patch_weights(s, t, loc.diagonal)
    Hx = ge.hg_shape[1]
    return _patch_sum(W, u_grid, (2 * iy) * Hx + 2 * ix, Hx), inside


def eval_p1_tensor_grid(ge: GridEval, g_grid: torch.Tensor,
                        points: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P1 tensor (projected ∇u) evaluation from the vertex-grid image
    ((ny+1)·(nx+1), 2, 2): (values (..., 2, 2), inside)."""
    loc = ge.locator
    inside = in_domain(loc, points)
    ix, iy, s, t = grid_coords(loc, points)
    W = p1_patch_weights(s, t, loc.diagonal)
    Gx = ge.vg_shape[1]
    flat = g_grid.reshape(g_grid.shape[0], 4)
    vals = _patch_sum(W, flat, iy * Gx + ix, Gx)
    return vals.reshape(vals.shape[:-1] + (2, 2)), inside
