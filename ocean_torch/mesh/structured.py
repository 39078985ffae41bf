"""Structured triangulations of rectangle unions (numpy copy of
``ocean_jax/mesh/structured.py``, without its native C++ triangulator, which
numbers alike).

The equivalent of ``dolfin.RectangleMesh`` / ``dolfin.UnitSquareMesh``:
the mesh is a set of plain host arrays (vertices, cells, edges, boundary
facets) plus structured-grid metadata for point location. Each grid
square is split along dolfin's "right" diagonal (lower-left to
upper-right) or its "left" one into two counter-clockwise triangles.
Numbering is identical to the JAX package's.

Domains: the rectangle, the L-shape ``[0,2]x[0,1] ∪ [1,2]x[1,2]`` and the
gen-1 pipe ``[0,2]²`` (``pipe_mesh``), uniform or on the graded tensor
grid of ``graded_lines``, with or without its circular obstacle (the
squares that touch the disk are removed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D triangle mesh with structured-grid lookup metadata.

    Cell vertices are counter-clockwise; local edge ``i`` connects local
    vertices ``(i+1)%3`` and ``(i+2)%3`` (the edge opposite vertex ``i``).
    """

    vertices: np.ndarray        # (nv, 2) float64
    cells: np.ndarray           # (nc, 3) int64, CCW
    edges: np.ndarray           # (ne, 2) int64, sorted vertex pairs
    cell_edges: np.ndarray      # (nc, 3) int64, edge opposite local vertex i

    bf_vertices: np.ndarray     # (nbf, 2) int64
    bf_cells: np.ndarray        # (nbf,) int64 owning cell
    bf_local: np.ndarray        # (nbf,) int64 local facet index
    bf_normals: np.ndarray      # (nbf, 2) float64 outward unit normals

    origin: Tuple[float, float]
    spacing: Tuple[float, float]
    grid_shape: Tuple[int, int]         # (nx, ny) squares
    square_to_cell: np.ndarray          # (ny, nx, 2) int64; -1 = inactive
    diagonal: str

    domain: str                          # "rect" | "lshape" | "pipe"
    extent: Tuple[float, float, float, float]   # xmin, ymin, xmax, ymax
    lshape_corner: Tuple[float, float] = (1.0, 1.0)  # inner corner (x, y)
    hole: Optional[Tuple[float, float, float]] = None  # (cx, cy, r) obstacle
    # grid lines of a graded tensor grid (None: uniform, located in closed
    # form; else located by a search over the lines)
    xs: Optional[np.ndarray] = None      # (nx+1,)
    ys: Optional[np.ndarray] = None      # (ny+1,)

    @property
    def uniform(self) -> bool:
        return self.xs is None

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def cell_vertices(self) -> np.ndarray:
        """(nc, 3, 2) coordinates of each cell's vertices."""
        return self.vertices[self.cells]

    def facet_midpoints(self) -> np.ndarray:
        return 0.5 * (self.vertices[self.bf_vertices[:, 0]]
                      + self.vertices[self.bf_vertices[:, 1]])

    def facet_lengths(self) -> np.ndarray:
        d = (self.vertices[self.bf_vertices[:, 1]]
             - self.vertices[self.bf_vertices[:, 0]])
        return np.linalg.norm(d, axis=1)


def _triangulate(active: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                 diagonal: str):
    """Vertices/cells/square_to_cell from an active-square mask (ny, nx)
    over the grid lines xs (nx+1,), ys (ny+1,)."""
    ny, nx = active.shape
    used = np.zeros((ny + 1, nx + 1), dtype=bool)
    iy, ix = np.nonzero(active)
    for dy in (0, 1):
        for dx in (0, 1):
            used[iy + dy, ix + dx] = True
    vid = -np.ones((ny + 1, nx + 1), dtype=np.int64)
    vid[used] = np.arange(used.sum())
    gy, gx = np.nonzero(used)
    vertices = np.stack([xs[gx], ys[gy]], axis=1)

    v00 = vid[iy, ix]
    v10 = vid[iy, ix + 1]
    v01 = vid[iy + 1, ix]
    v11 = vid[iy + 1, ix + 1]
    if diagonal == "right":                  # diagonal v00 -- v11
        t0 = np.stack([v00, v10, v11], axis=1)   # below it (t <= s)
        t1 = np.stack([v00, v11, v01], axis=1)
    elif diagonal == "left":                 # diagonal v10 -- v01
        t0 = np.stack([v00, v10, v01], axis=1)   # s + t <= 1
        t1 = np.stack([v10, v11, v01], axis=1)
    else:
        raise ValueError(f"unknown diagonal {diagonal!r}")

    nc_active = iy.shape[0]
    cells = np.empty((2 * nc_active, 3), dtype=np.int64)
    cells[0::2] = t0
    cells[1::2] = t1
    square_to_cell = -np.ones((ny, nx, 2), dtype=np.int64)
    square_to_cell[iy, ix, 0] = np.arange(0, 2 * nc_active, 2)
    square_to_cell[iy, ix, 1] = np.arange(1, 2 * nc_active, 2)
    return vertices, cells, square_to_cell


def _build_topology(vertices: np.ndarray, cells: np.ndarray):
    """Edges, cell→edge maps, and boundary facets with owning cells."""
    nc = cells.shape[0]
    e0 = cells[:, [1, 2]]
    e1 = cells[:, [2, 0]]
    e2 = cells[:, [0, 1]]
    all_edges = np.concatenate([e0, e1, e2], axis=0)
    sorted_edges = np.sort(all_edges, axis=1)
    edges, inverse, counts = np.unique(
        sorted_edges, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    cell_edges = inverse.reshape(3, nc).T.astype(np.int64)

    is_bnd = counts[inverse] == 1
    flat_idx = np.nonzero(is_bnd)[0]
    b_local = flat_idx // nc
    b_cell = flat_idx % nc
    b_edge = inverse[flat_idx]
    order = np.argsort(b_edge)
    b_local, b_cell = b_local[order], b_cell[order]

    bf_vertices = np.stack(
        [cells[b_cell, (b_local + 1) % 3], cells[b_cell, (b_local + 2) % 3]],
        axis=1)
    tang = vertices[bf_vertices[:, 1]] - vertices[bf_vertices[:, 0]]
    normals = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    opp = vertices[cells[b_cell, b_local]]
    mid = 0.5 * (vertices[bf_vertices[:, 0]] + vertices[bf_vertices[:, 1]])
    flip = np.einsum("ij,ij->i", normals, mid - opp) < 0
    normals[flip] *= -1.0
    return edges, cell_edges, bf_vertices, b_cell, b_local, normals


def _finalize(vertices, cells, square_to_cell, origin, spacing, grid_shape,
              diagonal, domain, extent, lshape_corner=(1.0, 1.0),
              hole=None, xs=None, ys=None) -> Mesh2D:
    v = vertices[cells]
    det = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
           - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0]))
    assert (det > 0).all(), "triangulation must be CCW"
    edges, cell_edges, bf_v, bf_c, bf_l, bf_n = _build_topology(vertices,
                                                                cells)
    return Mesh2D(
        vertices=vertices,
        cells=cells.astype(np.int64),
        edges=edges.astype(np.int64),
        cell_edges=cell_edges,
        bf_vertices=bf_v.astype(np.int64),
        bf_cells=bf_c.astype(np.int64),
        bf_local=bf_l.astype(np.int64),
        bf_normals=bf_n,
        origin=origin,
        spacing=spacing,
        grid_shape=grid_shape,
        square_to_cell=square_to_cell,
        diagonal=diagonal,
        domain=domain,
        extent=extent,
        lshape_corner=lshape_corner,
        hole=hole,
        xs=xs,
        ys=ys,
    )


def graded_lines(a: float, b: float, center: float, lc_min: float,
                 lc_max: float, dist_min: float, dist_max: float
                 ) -> np.ndarray:
    """1-D grid lines with gmsh-style distance-threshold size control:
    local spacing lc_min within ``dist_min`` of ``center``, ramping
    linearly to lc_max at ``dist_max``. March from ``a`` stepping by the
    local size, then snap the last line to ``b`` (dropping the one before
    it if the final interval would be shorter than half the local size
    at ``b``)."""
    if not dist_max > dist_min:
        raise ValueError(
            f"graded_lines needs dist_max > dist_min (got {dist_min}, "
            f"{dist_max}): the ramp divides by their difference")
    pts = [a]
    x = a
    while x < b - 1e-12:
        d = abs(x - center)
        f = min(max((d - dist_min) / (dist_max - dist_min), 0.0), 1.0)
        x = min(x + lc_min + (lc_max - lc_min) * f, b)
        pts.append(x)
    arr = np.asarray(pts)
    d_b = abs(b - center)
    f_b = min(max((d_b - dist_min) / (dist_max - dist_min), 0.0), 1.0)
    lc_b = lc_min + (lc_max - lc_min) * f_b
    if len(arr) > 2 and arr[-1] - arr[-2] < 0.5 * lc_b:
        arr = np.delete(arr, -2)
    arr[-1] = b
    return arr


def rectangle_mesh(p0: Tuple[float, float], p1: Tuple[float, float],
                   nx: int, ny: int, diagonal: str = "right") -> Mesh2D:
    """Equivalent of ``dolfin.RectangleMesh(Point(*p0), Point(*p1), nx,
    ny)``."""
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    active = np.ones((ny, nx), dtype=bool)
    vertices, cells, s2c = _triangulate(active, xs, ys, diagonal)
    return _finalize(
        vertices, cells, s2c,
        origin=(p0[0], p0[1]),
        spacing=((p1[0] - p0[0]) / nx, (p1[1] - p0[1]) / ny),
        grid_shape=(nx, ny),
        diagonal=diagonal,
        domain="rect",
        extent=(p0[0], p0[1], p1[0], p1[1]),
    )


def l_shape_mesh(resolution: int = 50, diagonal: str = "right") -> Mesh2D:
    """Structured triangulation of the L-shaped domain
    ``[0,2]x[0,1] ∪ [1,2]x[1,2]``. ``resolution`` is the number of squares
    along the long (length-2) axis, so the mesh size is ``2/resolution``;
    the squares of the missing upper-left block are inactive
    (``square_to_cell`` −1) and own no vertex."""
    n = resolution
    xs = np.linspace(0.0, 2.0, n + 1)
    ys = np.linspace(0.0, 2.0, n + 1)
    cx = 0.5 * (xs[:-1] + xs[1:])[None, :]
    cy = 0.5 * (ys[:-1] + ys[1:])[:, None]
    active = np.broadcast_to((cy <= 1.0) | (cx >= 1.0), (n, n)).copy()
    vertices, cells, s2c = _triangulate(active, xs, ys, diagonal)
    return _finalize(
        vertices, cells, s2c,
        origin=(0.0, 0.0),
        spacing=(2.0 / n, 2.0 / n),
        grid_shape=(n, n),
        diagonal=diagonal,
        domain="lshape",
        extent=(0.0, 0.0, 2.0, 2.0),
        lshape_corner=(1.0, 1.0),
    )


def unit_square_mesh(n: int, diagonal: str = "right") -> Mesh2D:
    """Equivalent of ``dolfin.UnitSquareMesh(n, n)``."""
    return rectangle_mesh((0.0, 0.0), (1.0, 1.0), n, n, diagonal)


PIPE_INLET_MARKER = 0
PIPE_OUTLET_MARKER = 1          # defined by gen-1, marks no facet
PIPE_WALL_MARKER = 2
PIPE_OBSTACLE_MARKER = 3


def pipe_mesh(resolution: int = 22, obstacle: bool = False,
              diagonal: str = "right", graded: bool = False,
              lc_min: float = None, lc_max: float = None):
    """The gen-1 pipe [0,2]×[0,2] with tagged boundaries and an optional
    circular obstacle: inlet {x=0} ∪ {x=2} (marker 0), walls {y=0} ∪
    {y=2} (marker 2), obstacle boundary marker 3; the disk at (0.2, 0.2),
    radius 0.05. Returns (mesh, facet_tags). ``resolution`` is the number
    of squares an axis of the uniform grid.

    ``graded=True``: tensor-product grid lines from ``graded_lines`` with
    lc_min (default r/3) within distance r of the disk's centre, ramping
    to lc_max (default 0.09) at distance 2H. ``spacing`` then holds the
    largest interval of each axis and locates nothing: point location
    searches the lines (``xs``, ``ys``)."""
    L = H = 2.0
    c_x = c_y = 0.2
    r = 0.05
    n = resolution
    if graded:
        if lc_min is None:
            lc_min = r / 3
        if lc_max is None:
            lc_max = min(0.25 * H, 0.09)
        xs = graded_lines(0.0, L, c_x, lc_min, lc_max, r, 2 * H)
        ys = graded_lines(0.0, H, c_y, lc_min, lc_max, r, 2 * H)
    else:
        xs = np.linspace(0.0, L, n + 1)
        ys = np.linspace(0.0, H, n + 1)
    nx, ny = len(xs) - 1, len(ys) - 1
    cx = 0.5 * (xs[:-1] + xs[1:])[None, :]
    cy = 0.5 * (ys[:-1] + ys[1:])[:, None]
    active = np.ones((ny, nx), dtype=bool)
    hole = None
    if obstacle:
        # every square whose distance to the disk's centre is below r goes
        hwx = 0.5 * np.diff(xs)[None, :]
        hwy = 0.5 * np.diff(ys)[:, None]
        dx = np.maximum(np.abs(cx - c_x) - hwx, 0.0)
        dy = np.maximum(np.abs(cy - c_y) - hwy, 0.0)
        active &= (dx ** 2 + dy ** 2) >= r ** 2
        hole = (c_x, c_y, r)
    vertices, cells, s2c = _triangulate(active, xs, ys, diagonal)
    # the uniform grid keeps the exact L/n of the closed-form location
    spacing = ((float(np.diff(xs).max()), float(np.diff(ys).max()))
               if graded else (L / n, H / n))
    mesh = _finalize(vertices, cells, s2c, origin=(0.0, 0.0),
                     spacing=spacing, grid_shape=(nx, ny),
                     diagonal=diagonal, domain="pipe",
                     extent=(0.0, 0.0, L, H), hole=hole,
                     xs=(xs if graded else None),
                     ys=(ys if graded else None))
    eps = 1e-12
    tags = np.full(mesh.bf_vertices.shape[0], -1, dtype=np.int64)
    tags = mark_boundary_facets(
        mesh, lambda x: (np.abs(x[:, 1]) < eps)
        | (np.abs(x[:, 1] - H) < eps), tag=PIPE_WALL_MARKER,
        base_tags=tags)
    tags = mark_boundary_facets(
        mesh, lambda x: (np.abs(x[:, 0]) < eps)
        | (np.abs(x[:, 0] - L) < eps), tag=PIPE_INLET_MARKER,
        base_tags=tags)
    if obstacle:
        # facets off the outer rectangle belong to the obstacle
        mids = mesh.facet_midpoints()
        interior = ((mids[:, 0] > eps) & (mids[:, 0] < L - eps)
                    & (mids[:, 1] > eps) & (mids[:, 1] < H - eps))
        tags[interior] = PIPE_OBSTACLE_MARKER
    return mesh, tags


def mark_boundary_facets(mesh: Mesh2D,
                         predicate: Callable[[np.ndarray], np.ndarray],
                         tag: int = 1,
                         base_tags: Optional[np.ndarray] = None) -> np.ndarray:
    """Tag boundary facets like dolfin's ``SubDomain.mark``: a facet gets
    ``tag`` iff the predicate holds at both endpoints and the midpoint.
    Unmarked facets keep ``base_tags`` (default 0)."""
    a = mesh.vertices[mesh.bf_vertices[:, 0]]
    b = mesh.vertices[mesh.bf_vertices[:, 1]]
    mid = 0.5 * (a + b)
    marked = predicate(a) & predicate(b) & predicate(mid)
    tags = (np.zeros(len(marked), dtype=np.int64)
            if base_tags is None else base_tags.copy())
    tags[marked] = tag
    return tags
