"""Adjoint-PDE right-hand side: basis-weighted Dirac point sources (port
of ``ocean_jax/adjoint/point_sources.py``, methods "scatter" and
"fused").

Point-source application is the transpose of point interpolation. The
reference's semantics (``OCP_dolfin.py:353-366``):

  * masked (escaped) buoys are skipped,
  * at each remaining trajectory point u is re-evaluated; a point
    outside the domain uses u_x = 0 and places its source at the domain
    center,
  * the source magnitude is γ = h ((u_d − u_x) + μ), one scalar source
    per velocity component.
"""

from __future__ import annotations

import torch

from ..fem.spaces import TaylorHoodSpace
from ..fem.interpolate import p2_basis
from ..mesh.locate import locate_points


def _u_center(space: TaylorHoodSpace, u: torch.Tensor,
              center: torch.Tensor):
    """(cell, P2 basis values, u) at the domain center."""
    cell_c, xi_c, _ = locate_points(space.locator, center[None, :])
    phi_c = p2_basis(xi_c)[0]
    u_c = torch.einsum("a,ai->i", phi_c, u[space.cell_dofs_p2[cell_c[0]]])
    return cell_c[0], phi_c, u_c


def point_source_rhs(space: TaylorHoodSpace, u: torch.Tensor,
                     x: torch.Tensor, mu: torch.Tensor, u_d: torch.Tensor,
                     mask: torch.Tensor, h: float, center: torch.Tensor,
                     method: str = "scatter", grid=None,
                     u_values: torch.Tensor = None) -> torch.Tensor:
    """Assemble b = Σ_{buoys,k} γ·δ(x_k) into a mixed-space vector.

    u: (n_p2, 2); x, mu, u_d: (K, nt, 2); mask: (K,) bool.

    * "scatter": location, basis and scatter-add in plain PyTorch
      (``index_add_``: on the card its float64 atomics make the sum
      order, and so the last bits, vary from run to run),
    * "fused" (needs ``grid`` and the primal ``u_values``): γ from the
      primal ODE's own evaluations, then the CUDA point-source kernel
      (``adjoint/cuda_psrc.py``; bit-reproducible).
    """
    K, nt, _ = x.shape
    n_p1 = space.n_p1
    if method == "fused":
        if grid is None or u_values is None:
            raise ValueError("psrc_method='fused' needs the half-grid "
                             "tables and the primal u_values")
        from .cuda_psrc import point_source_image
        # a buoy whose FINAL evaluation fails is not masked: the primal
        # stores u_values[nt−1] = 0 and x[nt−1] = center, and the
        # reference re-evaluates at the stored center, getting u(center).
        # Lanes at the center exactly take u(center); elsewhere u(x_k) IS
        # u_values[k] (an unmasked buoy's points are all inside).
        _, _, u_c = _u_center(space, u, center)
        at_center = (x[..., 0] == center[0]) & (x[..., 1] == center[1])
        u_eff = torch.where(at_center[..., None], u_c, u_values)
        gamma = h * ((u_d - u_eff) + mu)
        gamma = torch.where((~mask)[:, None, None], gamma, 0.0)
        b_vel = point_source_image(grid, x, gamma)
        return torch.cat([b_vel.reshape(-1), b_vel.new_zeros(n_p1)])
    if method != "scatter":
        raise NotImplementedError(
            f"ocean_torch point sources: method {method!r} is not ported "
            "(scatter|fused)")
    pts = x.reshape(-1, 2)
    cell, xi, inside = locate_points(space.locator, pts)
    phi = p2_basis(xi)
    dofs = space.cell_dofs_p2[cell]
    u_x = torch.einsum("ma,mai->mi", phi, u[dofs])
    u_x = torch.where(inside[:, None], u_x, 0.0)
    cell_c, phi_c, _ = _u_center(space, u, center)
    cell = torch.where(inside, cell, cell_c)
    phi = torch.where(inside[:, None], phi, phi_c[None, :])
    dofs = space.cell_dofs_p2[cell]
    gamma = h * ((u_d.reshape(-1, 2) - u_x) + mu.reshape(-1, 2))
    active = (~mask).repeat_interleave(nt)
    gamma = torch.where(active[:, None], gamma, 0.0)
    vals = phi[:, :, None] * gamma[:, None, :]
    b_vel = u.new_zeros(space.n_p2, 2).index_add_(
        0, dofs.reshape(-1), vals.reshape(-1, 2))
    return torch.cat([b_vel.reshape(-1), b_vel.new_zeros(n_p1)])
