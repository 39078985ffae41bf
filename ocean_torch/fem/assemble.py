"""Batched assembly: gather → element compute → reduce (port of
``ocean_jax/fem/assemble.py``).

* residual vectors map the element kernels over cells with
  ``torch.func.vmap`` and reduce them into the global vector,
* element matrices are ``torch.func.jacfwd`` of the element residuals
  (consistent with the residual by construction),
* an assembled operator keeps its float64 element matrices: ``dense()``
  builds the (n, n) matrix for the LU factorization, ``matvec64`` applies
  it exactly without a dense matrix.

Every reduction runs as a gather + row sum over a precomputed transpose
incidence (``fem.spaces.incidence``) or through a coalesced sparse tensor,
so assembled values are bit-reproducible on the card (an atomic
scatter-add is not).

Dirichlet BCs follow dolfin's ``bc.apply(A); bc.apply(b)``: constrained
rows become identity rows, RHS entries the BC value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import jacfwd, vmap

from .spaces import TaylorHoodSpace, BoundaryQuad
from . import forms


def gather_sum(vals: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Σ-reduce per-entry values into global dofs through a transpose
    incidence: ``vals`` (m, ...) flat-indexed like the dof table the
    incidence was built from → (ndof, ...)."""
    tail = tuple(vals.shape[2:])
    flat = vals.reshape((-1,) + tail)
    flat = torch.cat([flat, flat.new_zeros((1,) + tail)])
    return flat[inc].sum(dim=0)


def _sparse_dense(n: int, rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Dense (n, n) Σ of (rows, cols, vals) triplets via a coalesced
    sparse tensor (deterministic duplicate summation)."""
    idx = torch.stack([rows.reshape(-1), cols.reshape(-1)])
    with torch.sparse.check_sparse_tensor_invariants(enable=False):
        a = torch.sparse_coo_tensor(idx, vals.reshape(-1), (n, n))
        return a.coalesce().to_dense()


@dataclasses.dataclass(frozen=True)
class Operator:
    """A bilinear operator assembled from element matrices, with Dirichlet
    rows replaced by identity."""

    cell_mats: torch.Tensor             # (nc, 15, 15) float64
    cell_dofs: torch.Tensor             # (nc, 15)
    facet_mats: Optional[torch.Tensor]  # (nf, 15, 15) or None
    facet_dofs: Optional[torch.Tensor]  # (nf, 15)
    bc_dofs: torch.Tensor               # (m,)
    n: int
    inc: Optional[torch.Tensor] = None        # incidence of cell_dofs
    facet_inc: Optional[torch.Tensor] = None  # incidence of facet_dofs

    def dense(self) -> torch.Tensor:
        """Dense float64 (n, n) matrix with identity Dirichlet rows."""
        k = self.cell_dofs.shape[1]
        rows = [self.cell_dofs[:, :, None].expand(-1, k, k)]
        cols = [self.cell_dofs[:, None, :].expand(-1, k, k)]
        vals = [self.cell_mats]
        if self.facet_mats is not None:
            rows.append(self.facet_dofs[:, :, None].expand(-1, k, k))
            cols.append(self.facet_dofs[:, None, :].expand(-1, k, k))
            vals.append(self.facet_mats)
        a = _sparse_dense(self.n, torch.cat([r.reshape(-1) for r in rows]),
                          torch.cat([c.reshape(-1) for c in cols]),
                          torch.cat([v.reshape(-1) for v in vals]))
        a[self.bc_dofs, :] = 0.0
        a[self.bc_dofs, self.bc_dofs] = 1.0
        return a

    def matvec64(self, x: torch.Tensor) -> torch.Tensor:
        """Exact float64 A @ x from the element matrices."""
        y = gather_sum(torch.einsum("cab,cb->ca", self.cell_mats,
                                    x[self.cell_dofs]), self.inc)
        if self.facet_mats is not None:
            y = y + gather_sum(torch.einsum("fab,fb->fa", self.facet_mats,
                                            x[self.facet_dofs]),
                               self.facet_inc)
        return y.index_copy(0, self.bc_dofs, x[self.bc_dofs])


def apply_bc_vector(r: torch.Tensor, bc_dofs: torch.Tensor,
                    bc_vals: torch.Tensor) -> torch.Tensor:
    """dolfin ``bc.apply(b)``: constrained entries take the BC value."""
    return r.index_copy(0, bc_dofs, bc_vals)


# ---------------------------------------------------------------------------
# Navier–Stokes residual / Jacobian
# ---------------------------------------------------------------------------

def ns_residual(space: TaylorHoodSpace, bq: Optional[BoundaryQuad],
                w: torch.Tensor, f_quad: Optional[torch.Tensor],
                nu: float, convection: bool = True) -> torch.Tensor:
    """Global NS residual (without BC application). f_quad: (nf, nq, 2)
    control values at the Γ₁ quadrature points, or None."""
    wl = w[space.cell_dofs_mixed]
    cell_r = vmap(lambda wl_, ji, dj: forms.ns_cell_residual(
        space, wl_, ji, dj, nu, convection))(
            wl, space.cell_jinv, space.cell_detj)
    r = gather_sum(cell_r, space.inc_mixed)
    if bq is not None:
        wf = w[bq.dofs_mixed]
        if f_quad is None:
            facet_r = vmap(lambda wl_, ph, nrm, wt: forms.ns_facet_residual(
                wl_, ph, nrm, wt, None))(wf, bq.phi2, bq.normals, bq.weights)
        else:
            facet_r = vmap(forms.ns_facet_residual)(
                wf, bq.phi2, bq.normals, bq.weights, f_quad)
        r = r + gather_sum(facet_r, bq.inc_mixed)
    return r


def ns_operator(space: TaylorHoodSpace, bq: Optional[BoundaryQuad],
                w: torch.Tensor, nu: float, bc_dofs: torch.Tensor,
                convection: bool = True) -> Operator:
    """Jacobian of the NS residual at w (the Stokes operator when
    convection=False)."""
    wl = w[space.cell_dofs_mixed]
    cell_jac = vmap(jacfwd(lambda wl_, ji, dj: forms.ns_cell_residual(
        space, wl_, ji, dj, nu, convection)))(
            wl, space.cell_jinv, space.cell_detj)
    facet_mats = facet_dofs = facet_inc = None
    if bq is not None:
        facet_mats = vmap(jacfwd(lambda wl_, ph, nrm, wt:
                                 forms.ns_facet_residual(
                                     wl_, ph, nrm, wt, None)))(
            w[bq.dofs_mixed], bq.phi2, bq.normals, bq.weights)
        facet_dofs, facet_inc = bq.dofs_mixed, bq.inc_mixed
    return Operator(cell_jac, space.cell_dofs_mixed, facet_mats, facet_dofs,
                    bc_dofs, space.ndof, inc=space.inc_mixed,
                    facet_inc=facet_inc)


def adjoint_operator(space: TaylorHoodSpace, bq: Optional[BoundaryQuad],
                     w: torch.Tensor, bc_dofs: torch.Tensor) -> Operator:
    """The adjoint bilinear form at the primal state w, as an Operator."""
    wl = w[space.cell_dofs_mixed]
    cell_jac = vmap(jacfwd(lambda zl, wl_, ji, dj:
                           forms.adjoint_cell_residual(space, zl, wl_, ji,
                                                       dj)))(
        torch.zeros_like(wl), wl, space.cell_jinv, space.cell_detj)
    facet_mats = facet_dofs = facet_inc = None
    if bq is not None:
        wf = w[bq.dofs_mixed]
        facet_mats = vmap(jacfwd(forms.adjoint_facet_residual))(
            torch.zeros_like(wf), wf, bq.phi2, bq.normals, bq.weights)
        facet_dofs, facet_inc = bq.dofs_mixed, bq.inc_mixed
    return Operator(cell_jac, space.cell_dofs_mixed, facet_mats, facet_dofs,
                    bc_dofs, space.ndof, inc=space.inc_mixed,
                    facet_inc=facet_inc)


# ---------------------------------------------------------------------------
# P1 mass matrix + grad(u) projection
# ---------------------------------------------------------------------------

def p1_mass_matrix(space: TaylorHoodSpace) -> torch.Tensor:
    """Dense P1 scalar mass matrix (n_p1, n_p1) in float64."""
    mats = vmap(lambda dj: forms.p1_mass_cell(space, dj))(space.cell_detj)
    d = space.cell_dofs_p1
    return _sparse_dense(space.n_p1, d[:, :, None].expand(-1, 3, 3),
                         d[:, None, :].expand(-1, 3, 3), mats)


def gradu_projection_rhs(space: TaylorHoodSpace, u: torch.Tensor
                         ) -> torch.Tensor:
    """RHS of the L2 projection of ∇u onto the P1 tensor space:
    u (n_p2, 2) → (n_p1, 2, 2)."""
    rhs = vmap(lambda ul_, ji, dj: forms.gradu_projection_cell_rhs(
        space, ul_, ji, dj))(u[space.cell_dofs_p2], space.cell_jinv,
                             space.cell_detj)
    return gather_sum(rhs, space.inc_p1)


# ---------------------------------------------------------------------------
# scalar functionals
# ---------------------------------------------------------------------------

def _cell_grad(space: TaylorHoodSpace, u: torch.Tensor):
    """Per-cell quadrature values (u_q (nc, nq, 2), gu (nc, nq, 2, 2))."""
    ul = u[space.cell_dofs_p2]
    dphi = torch.einsum("qad,cdi->cqai", space.dphi2_ref, space.cell_jinv)
    u_q = torch.einsum("qa,cai->cqi", space.phi2, ul)
    gu = torch.einsum("cai,cqaj->cqij", ul, dphi)
    return u_q, gu


def divergence_l2(space: TaylorHoodSpace, u: torch.Tensor) -> torch.Tensor:
    """sqrt(∫ div(u)² dx)."""
    _, gu = _cell_grad(space, u)
    divu = gu[..., 0, 0] + gu[..., 1, 1]
    w = space.qw[None, :] * space.cell_detj[:, None]
    return torch.sqrt(torch.sum(w * divu ** 2))


def velocity_norms(space: TaylorHoodSpace, u: torch.Tensor):
    """(L2, H1) norms: sqrt(∫|u|²) and sqrt(∫|u|² + |∇u|²)."""
    u_q, gu = _cell_grad(space, u)
    w = space.qw[None, :] * space.cell_detj[:, None]
    l2 = torch.sum(w * torch.sum(u_q ** 2, dim=-1))
    h1 = torch.sum(w * torch.sum(gu ** 2, dim=(-2, -1)))
    return torch.sqrt(l2), torch.sqrt(l2 + h1)
