"""Element-local weak forms of the coupled OCP system (port of
``ocean_jax/fem/forms.py``).

  * primal stationary Navier–Stokes residual with the Γ₁ outflow term and
    the Neumann control load:
        a = (ν ∇u:∇v + (∇u·u)·v + div(u) q + div(v) p) dx
            − 0.5 (u·n)(u·v) ds(1) − f·v ds(1)
  * the adjoint bilinear form (its Laplacian carries no viscosity
    coefficient, as in the reference):
        aAdj = (∇z:∇v + (∇u v)·z + (∇v u)·z + div(z) q + div(v) r) dx
               − 0.5 [(u·n)(v·z) + (v·n)(u·z)] ds(1)
  * P1 mass and the RHS of the L2 projection of ∇u.

Every function maps the local dof vector(s) of ONE cell or facet to its
local residual vector. Assembly maps them over cells with
``torch.func.vmap`` and builds element matrices with
``torch.func.jacfwd``, so they are written functorch-clean: no in-place
writes, no data-dependent Python control flow.
"""

from __future__ import annotations

from typing import Optional

import torch

from .spaces import TaylorHoodSpace


def split_local(wl: torch.Tensor):
    """Local mixed dof vector (15,) → (u (6, 2), p (3,))."""
    return wl[:12].reshape(6, 2), wl[12:]


def _dphi(space: TaylorHoodSpace, jinv: torch.Tensor) -> torch.Tensor:
    """Physical P2 gradients dphi[q, a, i] = ∂φ_a/∂x_i."""
    return torch.einsum("qad,di->qai", space.dphi2_ref, jinv)


def ns_cell_residual(space: TaylorHoodSpace, wl: torch.Tensor,
                     jinv: torch.Tensor, detj: torch.Tensor,
                     nu: float, convection: bool = True) -> torch.Tensor:
    """Volume part of the NS (Stokes when convection=False) residual;
    entries 2a+i are velocity test dof (node a, component i), 12+b
    pressure."""
    u, p = split_local(wl)
    dphi = _dphi(space, jinv)
    u_q = torch.einsum("qa,ai->qi", space.phi2, u)
    gu = torch.einsum("ai,qaj->qij", u, dphi)
    p_q = space.phi1 @ p
    w = space.qw * detj
    divu = gu[:, 0, 0] + gu[:, 1, 1]
    rv = torch.einsum("q,qij,qaj->ai", nu * w, gu, dphi)
    rv = rv + torch.einsum("q,q,qai->ai", w, p_q, dphi)
    if convection:
        conv = torch.einsum("qij,qj->qi", gu, u_q)
        rv = rv + torch.einsum("q,qi,qa->ai", w, conv, space.phi2)
    rp = torch.einsum("q,q,qb->b", w, divu, space.phi1)
    return torch.cat([rv.reshape(12), rp])


def ns_facet_residual(wl: torch.Tensor, phi2f: torch.Tensor,
                      normal: torch.Tensor, wts: torch.Tensor,
                      f_q: Optional[torch.Tensor]) -> torch.Tensor:
    """Γ₁ facet part of the NS residual: −0.5(u·n)(u·v) − f·v.
    phi2f (nq, 6); wts (nq,) weight × length; f_q (nq, 2) or None."""
    u, _ = split_local(wl)
    u_q = torch.einsum("qa,ai->qi", phi2f, u)
    un = u_q @ normal
    rv = -0.5 * torch.einsum("q,q,qi,qa->ai", wts, un, u_q, phi2f)
    if f_q is not None:
        rv = rv - torch.einsum("q,qi,qa->ai", wts, f_q, phi2f)
    return torch.cat([rv.reshape(12), rv.new_zeros(3)])


def adjoint_cell_residual(space: TaylorHoodSpace, zl: torch.Tensor,
                          wl: torch.Tensor, jinv: torch.Tensor,
                          detj: torch.Tensor) -> torch.Tensor:
    """Volume part of the adjoint form applied to the trial dofs ``zl``
    (no viscosity in the Laplacian, as in the reference)."""
    z, r = split_local(zl)
    u, _ = split_local(wl)
    dphi = _dphi(space, jinv)
    w = space.qw * detj
    z_q = torch.einsum("qa,ai->qi", space.phi2, z)
    gz = torch.einsum("ai,qaj->qij", z, dphi)
    r_q = space.phi1 @ r
    u_q = torch.einsum("qa,ai->qi", space.phi2, u)
    gu = torch.einsum("ai,qaj->qij", u, dphi)
    divz = gz[:, 0, 0] + gz[:, 1, 1]
    rv = torch.einsum("q,qij,qaj->ai", w, gz, dphi)
    rv = rv + torch.einsum("q,qkj,qk,qa->aj", w, gu, z_q, space.phi2)
    rv = rv + torch.einsum("q,qai,qi,qj->aj", w, dphi, u_q, z_q)
    rv = rv + torch.einsum("q,q,qai->ai", w, r_q, dphi)
    rp = torch.einsum("q,q,qb->b", w, divz, space.phi1)
    return torch.cat([rv.reshape(12), rp])


def adjoint_facet_residual(zl: torch.Tensor, wl: torch.Tensor,
                           phi2f: torch.Tensor, normal: torch.Tensor,
                           wts: torch.Tensor) -> torch.Tensor:
    """Γ₁ facet part of the adjoint form:
    −0.5[(u·n)(v·z) + (v·n)(u·z)]."""
    z, _ = split_local(zl)
    u, _ = split_local(wl)
    z_q = torch.einsum("qa,ai->qi", phi2f, z)
    u_q = torch.einsum("qa,ai->qi", phi2f, u)
    un = u_q @ normal
    uz = torch.einsum("qi,qi->q", u_q, z_q)
    rv = -0.5 * (torch.einsum("q,q,qa,qi->ai", wts, un, phi2f, z_q)
                 + torch.einsum("q,q,qa,i->ai", wts, uz, phi2f, normal))
    return torch.cat([rv.reshape(12), rv.new_zeros(3)])


def p1_mass_cell(space: TaylorHoodSpace, detj: torch.Tensor) -> torch.Tensor:
    """P1 scalar mass element matrix (3, 3)."""
    return torch.einsum("q,qa,qb->ab", space.qw * detj, space.phi1,
                        space.phi1)


def gradu_projection_cell_rhs(space: TaylorHoodSpace, ul: torch.Tensor,
                              jinv: torch.Tensor, detj: torch.Tensor
                              ) -> torch.Tensor:
    """RHS ∫ (∇u)_{ij} φ_b dx per cell: ul (6, 2) → (3, 2, 2)."""
    gu = torch.einsum("ai,qaj->qij", ul, _dphi(space, jinv))
    return torch.einsum("q,qb,qij->bij", space.qw * detj, space.phi1, gu)
