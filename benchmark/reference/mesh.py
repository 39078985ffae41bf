"""Structured triangle meshes of the two domains, in plain NumPy.

The [0,2]² square and the L-shape [0,2]×[0,1] ∪ [1,2]×[1,2], cut into
n × n grid squares of side 2/n, each square split along its lower-left
to upper-right diagonal into two counter-clockwise triangles. The
numbering is the one the system under test uses, so that dof vectors
compare entry by entry:

  * vertices: the used grid points row by row (y, then x);
  * cells: two per active square, squares row by row, the lower one
    (v00, v10, v11) first, then (v00, v11, v01);
  * edges: the sorted vertex pairs in lexicographic order; local edge i
    of a cell is the one opposite its vertex i;
  * boundary facets: in edge order, oriented (v[(i+1)%3], v[(i+2)%3]).
"""

from __future__ import annotations

import dataclasses

import numpy as np

EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Mesh:
    domain: str                  # "square" | "lshape"
    n: int                       # squares along an axis
    vertices: np.ndarray         # (nv, 2)
    cells: np.ndarray            # (nc, 3)
    edges: np.ndarray            # (ne, 2)
    cell_edges: np.ndarray       # (nc, 3)
    bf_vertices: np.ndarray      # (nbf, 2)
    bf_cells: np.ndarray         # (nbf,)
    bf_local: np.ndarray         # (nbf,)
    bf_normals: np.ndarray       # (nbf, 2) outward
    square_to_cell: np.ndarray   # (n, n, 2), -1 where inactive

    @property
    def h(self) -> float:
        return 2.0 / self.n


def build(domain: str, n: int) -> Mesh:
    lines = np.linspace(0.0, 2.0, n + 1)
    if domain == "square":
        active = np.ones((n, n), dtype=bool)
    elif domain == "lshape":
        mid = 0.5 * (lines[:-1] + lines[1:])
        active = (mid[:, None] <= 1.0) | (mid[None, :] >= 1.0)
    else:
        raise ValueError(f"unknown domain {domain!r}")
    used = np.zeros((n + 1, n + 1), dtype=bool)
    iy, ix = np.nonzero(active)
    for dy in (0, 1):
        for dx in (0, 1):
            used[iy + dy, ix + dx] = True
    vid = -np.ones((n + 1, n + 1), dtype=np.int64)
    vid[used] = np.arange(int(used.sum()))
    gy, gx = np.nonzero(used)
    vertices = np.stack([lines[gx], lines[gy]], axis=1)

    v00, v10 = vid[iy, ix], vid[iy, ix + 1]
    v01, v11 = vid[iy + 1, ix], vid[iy + 1, ix + 1]
    nsq = iy.size
    cells = np.empty((2 * nsq, 3), dtype=np.int64)
    cells[0::2] = np.stack([v00, v10, v11], axis=1)
    cells[1::2] = np.stack([v00, v11, v01], axis=1)
    s2c = -np.ones((n, n, 2), dtype=np.int64)
    s2c[iy, ix, 0] = np.arange(0, 2 * nsq, 2)
    s2c[iy, ix, 1] = np.arange(1, 2 * nsq, 2)

    nc = cells.shape[0]
    local = [cells[:, [(i + 1) % 3, (i + 2) % 3]] for i in range(3)]
    pairs = np.sort(np.concatenate(local, axis=0), axis=1)
    edges, inverse, counts = np.unique(pairs, axis=0, return_inverse=True,
                                       return_counts=True)
    inverse = inverse.reshape(-1)
    cell_edges = inverse.reshape(3, nc).T.copy()

    flat = np.nonzero(counts[inverse] == 1)[0]
    order = np.argsort(inverse[flat])
    b_local, b_cell = (flat // nc)[order], (flat % nc)[order]
    bf = np.stack([cells[b_cell, (b_local + 1) % 3],
                   cells[b_cell, (b_local + 2) % 3]], axis=1)
    tang = vertices[bf[:, 1]] - vertices[bf[:, 0]]
    normals = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    outward = vertices[bf].mean(axis=1) - vertices[cells[b_cell, b_local]]
    normals[np.einsum("ij,ij->i", normals, outward) < 0] *= -1.0
    return Mesh(domain, n, vertices, cells, edges.astype(np.int64),
                cell_edges, bf, b_cell, b_local, normals, s2c)


def facets_where(mesh: Mesh, predicate) -> np.ndarray:
    """Indices of the boundary facets on which ``predicate`` (points
    (m, 2) → bool (m,)) holds at both ends and at the midpoint."""
    a = mesh.vertices[mesh.bf_vertices[:, 0]]
    b = mesh.vertices[mesh.bf_vertices[:, 1]]
    return np.nonzero(predicate(a) & predicate(b)
                      & predicate(0.5 * (a + b)))[0]


def gamma1(domain: str):
    """The control boundary Γ₁: {x=0} ∪ {x=2} on the square, {x=0} ∪
    {y=2} on the L-shape."""
    if domain == "square":
        return lambda x: (np.abs(x[:, 0]) < EPS) | (np.abs(2 - x[:, 0]) < EPS)
    return lambda x: (np.abs(x[:, 0]) < EPS) | (np.abs(2 - x[:, 1]) < EPS)


def gamma2(domain: str):
    """The no-slip boundary Γ₂, the rest."""
    if domain == "square":
        return lambda x: (x[:, 0] > EPS) & (np.abs(2 - x[:, 0]) > EPS)
    return lambda x: (x[:, 0] > EPS) & (np.abs(2 - x[:, 1]) > EPS)


def center(domain: str) -> np.ndarray:
    """Where an escaped buoy is put."""
    return np.array([1.0, 1.0] if domain == "square" else [1.0, 0.5])
