"""Structured triangulations of rectangles (numpy copy of the square
branch of ``ocean_jax/mesh/structured.py``).

The equivalent of ``dolfin.RectangleMesh`` / ``dolfin.UnitSquareMesh``:
the mesh is a set of plain host arrays (vertices, cells, edges, boundary
facets) plus structured-grid metadata for O(1) point location. Each grid
square is split along dolfin's "right" diagonal (lower-left to
upper-right) into two counter-clockwise triangles. Numbering is identical
to the JAX package's.

Only rectangles with the "right" diagonal are ported; the L-shape, pipe,
graded and hole domains raise ``NotImplementedError``.
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
    square_to_cell: np.ndarray          # (ny, nx, 2) int64
    diagonal: str

    domain: str                          # "rect"
    extent: Tuple[float, float, float, float]   # xmin, ymin, xmax, ymax

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


def _triangulate(xs: np.ndarray, ys: np.ndarray, diagonal: str):
    """Vertices/cells/square_to_cell of a full rectangle grid."""
    if diagonal != "right":
        raise NotImplementedError(
            f"ocean_torch meshes support the 'right' diagonal only, "
            f"got {diagonal!r}")
    ny, nx = len(ys) - 1, len(xs) - 1
    active = np.ones((ny, nx), dtype=bool)
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
    t0 = np.stack([v00, v10, v11], axis=1)   # below the diagonal (t <= s)
    t1 = np.stack([v00, v11, v01], axis=1)   # above the diagonal

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


def rectangle_mesh(p0: Tuple[float, float], p1: Tuple[float, float],
                   nx: int, ny: int, diagonal: str = "right") -> Mesh2D:
    """Equivalent of ``dolfin.RectangleMesh(Point(*p0), Point(*p1), nx,
    ny)``."""
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    vertices, cells, s2c = _triangulate(xs, ys, diagonal)
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
        origin=(p0[0], p0[1]),
        spacing=((p1[0] - p0[0]) / nx, (p1[1] - p0[1]) / ny),
        grid_shape=(nx, ny),
        square_to_cell=s2c,
        diagonal=diagonal,
        domain="rect",
        extent=(p0[0], p0[1], p1[0], p1[1]),
    )


def unit_square_mesh(n: int, diagonal: str = "right") -> Mesh2D:
    """Equivalent of ``dolfin.UnitSquareMesh(n, n)``."""
    return rectangle_mesh((0.0, 0.0), (1.0, 1.0), n, n, diagonal)


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
