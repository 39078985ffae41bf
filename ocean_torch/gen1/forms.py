"""Gen-1 weak-form variants (port of ``ocean_jax/gen1/forms.py``; the
reference's ``old_dolfinx_files/solver_classes/
Navier_stokes_solver.py``).

Differences from the gen-2 forms of ``fem/forms.py``, as the JAX package
transcribes them:
  * pressure sign: ``div(u) q − div(v) p``,
  * boundary stabilization by the tanh regularization
    ``ψ_δ(u·n) = 0.5(u·n tanh(u·n/δ) − u·n + δ)`` with a PLUS sign:
    ``+0.5 ∫ ψ_δ u·v ds(1)``,
  * the adjoint keeps the viscosity coefficient and uses ψ'_δ on the
    boundary:
    ``ν∇z:∇v + ((u·∇)v)·z + ((v·∇)u)·z + div(v) p̂ − div(z) q̂
      + 0.5[(v·n) ψ'_δ(u·n) (u·z) + ψ_δ (v·z)] ds(1)``.

Each function maps the local dofs of one cell or facet to its local
residual, written for ``torch.func.vmap`` and ``jacfwd``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fem.forms import split_local
from ..fem.spaces import TaylorHoodSpace


def gen1_ns_cell_residual(space: TaylorHoodSpace, wl: torch.Tensor,
                          jinv: torch.Tensor, detj: torch.Tensor,
                          nu: float) -> torch.Tensor:
    u, p = split_local(wl)
    dphi = torch.einsum("qad,di->qai", space.dphi2_ref, jinv)
    u_q = torch.einsum("qa,ai->qi", space.phi2, u)
    gu = torch.einsum("ai,qaj->qij", u, dphi)
    p_q = space.phi1 @ p
    w = space.qw * detj
    divu = gu[:, 0, 0] + gu[:, 1, 1]
    conv = torch.einsum("qij,qj->qi", gu, u_q)
    rv = (torch.einsum("q,qij,qaj->ai", nu * w, gu, dphi)
          + torch.einsum("q,qi,qa->ai", w, conv, space.phi2)
          - torch.einsum("q,q,qai->ai", w, p_q, dphi))     # − div(v) p
    rp = torch.einsum("q,q,qb->b", w, divu, space.phi1)    # + div(u) q
    return torch.cat([rv.reshape(12), rp])


def _psi_delta(un, delta):
    return 0.5 * (un * torch.tanh(un / delta) - un + delta)


def _psi_delta_prime(un, delta):
    """ψ'_δ as the reference writes it:
    0.5(tanh(u·n/δ) + u·n/(δ cosh²(u·n/δ)) − 1)."""
    c = torch.cosh(un / delta)
    return 0.5 * (torch.tanh(un / delta) + un / (delta * c * c) - 1.0)


def gen1_ns_facet_residual(wl: torch.Tensor, phi2f: torch.Tensor,
                           normal: torch.Tensor, wts: torch.Tensor,
                           q_vals: Optional[torch.Tensor], delta: float
                           ) -> torch.Tensor:
    """+0.5 ∫ ψ_δ(u·n) u·v ds(1) − ∫ q·v ds(1)."""
    u, _ = split_local(wl)
    u_q = torch.einsum("qa,ai->qi", phi2f, u)
    un = u_q @ normal
    rv = 0.5 * torch.einsum("q,q,qi,qa->ai", wts, _psi_delta(un, delta),
                            u_q, phi2f)
    if q_vals is not None:
        rv = rv - torch.einsum("q,qi,qa->ai", wts, q_vals, phi2f)
    return torch.cat([rv.reshape(12), rv.new_zeros(3)])


def gen1_adjoint_cell_residual(space: TaylorHoodSpace, zl: torch.Tensor,
                               wl: torch.Tensor, jinv: torch.Tensor,
                               detj: torch.Tensor, nu: float
                               ) -> torch.Tensor:
    z, r = split_local(zl)
    u, _ = split_local(wl)
    dphi = torch.einsum("qad,di->qai", space.dphi2_ref, jinv)
    w = space.qw * detj
    z_q = torch.einsum("qa,ai->qi", space.phi2, z)
    gz = torch.einsum("ai,qaj->qij", z, dphi)
    r_q = space.phi1 @ r
    u_q = torch.einsum("qa,ai->qi", space.phi2, u)
    gu = torch.einsum("ai,qaj->qij", u, dphi)
    divz = gz[:, 0, 0] + gz[:, 1, 1]
    rv = (torch.einsum("q,qij,qaj->ai", nu * w, gz, dphi)
          + torch.einsum("q,qkj,qk,qa->aj", w, gu, z_q, space.phi2)
          + torch.einsum("q,qai,qi,qj->aj", w, dphi, u_q, z_q)
          + torch.einsum("q,q,qai->ai", w, r_q, dphi))     # + div(v) p̂
    rp = -torch.einsum("q,q,qb->b", w, divz, space.phi1)   # − div(z) q̂
    return torch.cat([rv.reshape(12), rp])


def gen1_adjoint_facet_residual(zl: torch.Tensor, wl: torch.Tensor,
                                phi2f: torch.Tensor, normal: torch.Tensor,
                                wts: torch.Tensor, delta: float
                                ) -> torch.Tensor:
    """0.5[(v·n) ψ'_δ(u·n)(u·z) + ψ_δ(u·n)(v·z)] ds(1)."""
    z, _ = split_local(zl)
    u, _ = split_local(wl)
    z_q = torch.einsum("qa,ai->qi", phi2f, z)
    u_q = torch.einsum("qa,ai->qi", phi2f, u)
    un = u_q @ normal
    uz = torch.einsum("qi,qi->q", u_q, z_q)
    rv = 0.5 * (torch.einsum("q,q,qa,i->ai", wts,
                             _psi_delta_prime(un, delta) * uz, phi2f, normal)
                + torch.einsum("q,q,qa,qi->ai", wts, _psi_delta(un, delta),
                               phi2f, z_q))
    return torch.cat([rv.reshape(12), rv.new_zeros(3)])
