"""Taylor–Hood (P2/P1) mixed function space (port of
``ocean_jax/fem/spaces.py``).

Numbering is the JAX package's:

  * P2 scalar dof ``s``: vertex dofs ``0..nv-1`` then edge-midpoint dofs
    ``nv..nv+ne-1``,
  * mixed global numbering: velocity component ``c`` of scalar dof ``s``
    is ``2*s + c``; pressure dof at vertex ``v`` is ``2*n_p2 + v``.

Host tables are built with numpy and moved to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..mesh.structured import Mesh2D, mark_boundary_facets
from ..mesh.locate import Locator
from . import reference as ref

VOLUME_QUAD_DEGREE = 6
EDGE_GAUSS_POINTS = 4      # exact to degree 7 on facets

_F64 = torch.float64


def _t(a, device, dtype=_F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class BoundaryQuad:
    """Quadrature data for a tagged set of boundary facets (``ds(1)``).
    Shapes: nf facets, nq quadrature points per facet."""

    facet_ids: torch.Tensor     # (nf,)
    cells: torch.Tensor         # (nf,) owning cell
    phi2: torch.Tensor          # (nf, nq, 6)
    normals: torch.Tensor       # (nf, 2)
    weights: torch.Tensor       # (nf, nq) quadrature weight × facet length
    points: torch.Tensor        # (nf, nq, 2)
    # mixed dofs of the owning cells (nf, 15) and their transpose
    # incidence (as TaylorHoodSpace.inc_mixed): facet terms reduce by
    # gather + row sum, deterministic on the card
    dofs_mixed: torch.Tensor = None
    inc_mixed: torch.Tensor = None

    @property
    def num_facets(self) -> int:
        return self.facet_ids.shape[0]

    @property
    def num_points(self) -> int:
        return self.phi2.shape[1]


@dataclasses.dataclass(frozen=True)
class TaylorHoodSpace:
    """All tables for P2/P1 mixed FEM on a structured triangle mesh."""

    n_p2: int
    n_p1: int
    cell_dofs_p2: torch.Tensor      # (nc, 6) int64
    cell_dofs_p1: torch.Tensor      # (nc, 3)
    cell_dofs_mixed: torch.Tensor   # (nc, 15)
    cell_jinv: torch.Tensor         # (nc, 2, 2)
    cell_detj: torch.Tensor         # (nc,)
    qw: torch.Tensor                # (nq,)
    phi1: torch.Tensor              # (nq, 3)
    phi2: torch.Tensor              # (nq, 6)
    dphi2_ref: torch.Tensor         # (nq, 6, 2)
    dphi1_ref: torch.Tensor         # (3, 2)
    dof_coords_p2: torch.Tensor     # (n_p2, 2)
    locator: Locator
    # transpose incidence of cell_dofs_mixed: (max_inc, ndof) indices into
    # the flattened (nc·15,) element-contribution array, sentinel nc·15
    # for a zero pad slot. Assembly reduces by gather + row sum, which is
    # deterministic on the card (an atomic scatter is not).
    inc_mixed: torch.Tensor = None
    inc_p1: torch.Tensor = None      # the same for cell_dofs_p1

    @property
    def ndof(self) -> int:
        return 2 * self.n_p2 + self.n_p1

    @property
    def num_cells(self) -> int:
        return self.cell_dofs_p2.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cell_detj.device

    def split(self, w: torch.Tensor):
        """Mixed vector → (velocity (n_p2, 2), pressure (n_p1,))."""
        return w[: 2 * self.n_p2].reshape(self.n_p2, 2), w[2 * self.n_p2:]

    def join(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """(velocity (n_p2, 2), pressure (n_p1,)) → mixed vector."""
        return torch.cat([u.reshape(-1), p])


def _mixed_cell_dofs(cell_dofs_p2: np.ndarray, cells: np.ndarray,
                     n_p2: int) -> np.ndarray:
    nc = cell_dofs_p2.shape[0]
    vel = np.empty((nc, 12), dtype=np.int64)
    vel[:, 0::2] = 2 * cell_dofs_p2
    vel[:, 1::2] = 2 * cell_dofs_p2 + 1
    pres = 2 * n_p2 + cells
    return np.concatenate([vel, pres], axis=1)


def incidence(dofs: np.ndarray, ndof: int) -> np.ndarray:
    """Transpose incidence of a dof table: (max_inc, ndof) where column d
    lists the flat indices of ``dofs`` equal to d, padded with the
    sentinel ``dofs.size`` (callers append one zero slot)."""
    flat = np.asarray(dofs).reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=ndof)
    starts = np.zeros(ndof + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(flat.size, dtype=np.int64) - starts[flat[order]]
    inc = np.full((max(int(counts.max()), 1), ndof), flat.size,
                  dtype=np.int64)
    inc[pos, flat[order]] = order
    return inc


def make_space(mesh: Mesh2D, device="cuda") -> TaylorHoodSpace:
    """Build the Taylor–Hood space tables for a mesh on ``device`` (the
    card by default; raises without one unless ``device="cpu"``)."""
    device = resolve_device(device)
    nv, nc = mesh.num_vertices, mesh.num_cells
    n_p2 = nv + mesh.num_edges
    cell_dofs_p2 = np.concatenate([mesh.cells, nv + mesh.cell_edges], axis=1)
    cell_dofs_mixed = _mixed_cell_dofs(cell_dofs_p2, mesh.cells, n_p2)

    v = mesh.cell_vertices()
    jac = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detj = np.abs(np.linalg.det(jac))
    jinv = np.linalg.inv(jac)

    qp, qw = ref.triangle_quadrature(VOLUME_QUAD_DEGREE)
    midpoints = 0.5 * (mesh.vertices[mesh.edges[:, 0]]
                       + mesh.vertices[mesh.edges[:, 1]])
    dof_coords = np.concatenate([mesh.vertices, midpoints], axis=0)
    i64 = torch.int64
    return TaylorHoodSpace(
        n_p2=n_p2,
        n_p1=nv,
        cell_dofs_p2=_t(cell_dofs_p2, device, i64),
        cell_dofs_p1=_t(mesh.cells, device, i64),
        cell_dofs_mixed=_t(cell_dofs_mixed, device, i64),
        cell_jinv=_t(jinv, device),
        cell_detj=_t(detj, device),
        qw=_t(qw, device),
        phi1=_t(ref.p1_basis(qp), device),
        phi2=_t(ref.p2_basis(qp), device),
        dphi2_ref=_t(ref.p2_grad_ref(qp), device),
        dphi1_ref=_t(ref.P1_GRAD, device),
        dof_coords_p2=_t(dof_coords, device),
        locator=Locator.from_mesh(mesh, device),
        inc_mixed=_t(incidence(cell_dofs_mixed, 2 * n_p2 + nv), device, i64),
        inc_p1=_t(incidence(mesh.cells, nv), device, i64),
    )


def make_boundary_quad(mesh: Mesh2D, tags: np.ndarray, tag: int = 1,
                       n_gauss: int = EDGE_GAUSS_POINTS,
                       device="cuda") -> BoundaryQuad:
    """Facet quadrature tables for all boundary facets with ``tags ==
    tag`` — the discrete ``ds(tag)`` measure — on ``device`` (the card by
    default; raises without one unless ``device="cpu"``)."""
    device = resolve_device(device)
    sel = np.nonzero(tags == tag)[0]
    cells = mesh.bf_cells[sel]
    a = mesh.vertices[mesh.bf_vertices[sel, 0]]
    b = mesh.vertices[mesh.bf_vertices[sel, 1]]
    lengths = np.linalg.norm(b - a, axis=1)
    normals = mesh.bf_normals[sel]

    gp, gw = ref.gauss_legendre_01(n_gauss)
    pts = a[:, None, :] + gp[None, :, None] * (b - a)[:, None, :]
    v = mesh.cell_vertices()[cells]
    jac = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    jinv = np.linalg.inv(jac)
    d = pts - v[:, None, 0, :]
    xi = np.einsum("fij,fqj->fqi", jinv, d)
    phi2 = ref.p2_basis(xi)

    weights = lengths[:, None] * gw[None, :]
    nv = mesh.num_vertices
    n_p2 = nv + mesh.num_edges
    cdp2 = np.concatenate([mesh.cells, nv + mesh.cell_edges], axis=1)
    fdofs = _mixed_cell_dofs(cdp2, mesh.cells, n_p2)[cells]
    return BoundaryQuad(
        facet_ids=_t(sel, device, torch.int64),
        cells=_t(cells, device, torch.int64),
        phi2=_t(phi2, device),
        normals=_t(normals, device),
        weights=_t(weights, device),
        points=_t(pts, device),
        dofs_mixed=_t(fdofs, device, torch.int64),
        inc_mixed=_t(incidence(fdofs, 2 * n_p2 + nv), device, torch.int64),
    )


def dirichlet_velocity_bc(mesh: Mesh2D, space: TaylorHoodSpace,
                          predicate: Callable[[np.ndarray], np.ndarray],
                          value: Optional[Callable[[np.ndarray], np.ndarray]]
                          = None):
    """Dirichlet BC on the velocity subspace, topological method (all P2
    dofs on facets where the predicate holds at both endpoints and the
    midpoint). Returns (mixed dof indices (m,), values (m,))."""
    tags = mark_boundary_facets(mesh, predicate, tag=1)
    sel = np.nonzero(tags == 1)[0]
    nv = mesh.num_vertices
    edge_ids = mesh.cell_edges[mesh.bf_cells[sel], mesh.bf_local[sel]]
    scalar_dofs = np.unique(np.concatenate(
        [mesh.bf_vertices[sel].reshape(-1), nv + edge_ids]))
    coords = space.dof_coords_p2.cpu().numpy()[scalar_dofs]
    if value is None:
        vals = np.zeros((scalar_dofs.shape[0], 2))
    else:
        vals = np.asarray(value(coords))
    mixed = np.concatenate([2 * scalar_dofs, 2 * scalar_dofs + 1])
    values = np.concatenate([vals[:, 0], vals[:, 1]])
    return (_t(mixed, space.device, torch.int64), _t(values, space.device))


def dirichlet_pressure_bc(mesh: Mesh2D, space: TaylorHoodSpace,
                          predicate: Callable[[np.ndarray], np.ndarray],
                          value: float = 0.0):
    """Dirichlet BC on the pressure subspace (the u_d construction's
    pressure pin)."""
    tags = mark_boundary_facets(mesh, predicate, tag=1)
    sel = np.nonzero(tags == 1)[0]
    verts = np.unique(mesh.bf_vertices[sel].reshape(-1))
    mixed = 2 * space.n_p2 + verts
    return (_t(mixed, space.device, torch.int64),
            torch.full((verts.shape[0],), float(value), dtype=_F64,
                       device=space.device))


def combine_bcs(*bcs):
    """Merge (dofs, values) pairs; on shared dofs the LAST BC wins (dolfin
    applies BCs in list order)."""
    device = bcs[0][0].device
    dofs = np.concatenate([b[0].cpu().numpy() for b in bcs])
    vals = np.concatenate([b[1].cpu().numpy() for b in bcs])
    rev_dofs = dofs[::-1]
    uniq, first_idx = np.unique(rev_dofs, return_index=True)
    return (_t(uniq, device, torch.int64), _t(vals[::-1][first_idx], device))
