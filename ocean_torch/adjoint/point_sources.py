"""Adjoint-PDE right-hand side: basis-weighted Dirac point sources (port
of ``ocean_jax/adjoint/point_sources.py``).

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

from ..fem.assemble import gather_sum
from ..fem.spaces import TaylorHoodSpace
from ..fem.interpolate import p2_basis
from ..mesh.locate import in_domain, locate_points
from ..ops.scatter import (binned_segment_sum, sorted_segment_sum,
                           ozaki_segment_sum)
from ..utils import timing

_SEGMENT_SUMS = {"binned": binned_segment_sum, "sorted": sorted_segment_sum,
                 "ozaki": ozaki_segment_sum,
                 "ozaki_pallas": ozaki_segment_sum}


def _u_center(space: TaylorHoodSpace, u: torch.Tensor,
              center: torch.Tensor):
    """(cell, P2 basis values, u) at the domain center."""
    cell_c, xi_c, _ = locate_points(space.locator, center[None, :])
    phi_c = p2_basis(xi_c)[0]
    u_c = torch.einsum("a,ai->i", phi_c,
                       u[space.cell_dofs_p2[timing.to_host(cell_c[0])]])
    return cell_c[0], phi_c, u_c


def point_source_terms(space: TaylorHoodSpace, u: torch.Tensor,
                       x: torch.Tensor, mu: torch.Tensor, u_d: torch.Tensor,
                       active: torch.Tensor, h: float, center: torch.Tensor):
    """Per-point terms of the non-fused methods: the owning cell (M,) of
    each of the M = K·nt points (the center's cell for an out-of-domain
    point) and its basis-weighted sources φ_a·γ_i (M, 6, 2); ``active``
    (K, nt) bool zeroes γ elsewhere."""
    pts = x.reshape(-1, 2)
    cell, xi, inside = locate_points(space.locator, pts)
    phi = p2_basis(xi)
    dofs = space.cell_dofs_p2[cell]
    u_x = torch.einsum("ma,mai->mi", phi, u[dofs])
    u_x = torch.where(inside[:, None], u_x, 0.0)
    cell_c, phi_c, _ = _u_center(space, u, center)
    cell = torch.where(inside, cell, cell_c)
    phi = torch.where(inside[:, None], phi, phi_c[None, :])
    gamma = h * ((u_d.reshape(-1, 2) - u_x) + mu.reshape(-1, 2))
    gamma = torch.where(active.reshape(-1)[:, None], gamma, 0.0)
    return cell, phi[:, :, None] * gamma[:, None, :]


def fused_gamma(space: TaylorHoodSpace, u: torch.Tensor, x: torch.Tensor,
                mu: torch.Tensor, u_d: torch.Tensor, active: torch.Tensor,
                h: float, center: torch.Tensor,
                u_values: torch.Tensor) -> torch.Tensor:
    """Source magnitudes γ (K, nt, 2) of the "fused" method, from the
    primal ODE's own evaluations ``u_values``; ``active`` (K, nt) bool
    zeroes γ elsewhere."""
    # a buoy whose FINAL evaluation fails is not masked: the primal
    # stores u_values[nt−1] = 0 and x[nt−1] = center, and the
    # reference re-evaluates at the stored center, getting u(center).
    # Lanes at the center exactly take u(center); elsewhere u(x_k) IS
    # u_values[k] (an unmasked buoy's points are all inside; in
    # consistent mode an escaped buoy's pre-escape slots hold the real
    # u(x_raw[t]) and its kfail+1 slot u(center)).
    _, _, u_c = _u_center(space, u, center)
    at_center = (x[..., 0] == center[0]) & (x[..., 1] == center[1])
    u_eff = torch.where(at_center[..., None], u_c, u_values)
    gamma = h * ((u_d - u_eff) + mu)
    return torch.where(active[..., None], gamma, 0.0)


def recentred_slots(loc, x_raw: torch.Tensor, mask: torch.Tensor,
                    kfail: torch.Tensor) -> torch.Tensor:
    """The (buoy, time) slots (K, nt) bool whose stored position the
    primal ODE overwrote with the domain center, from what the primal ODE
    returns beside the positions: every slot of an escaped buoy
    (``mask``; ``kfail`` < nt says the same), and the last slot of a buoy
    whose final evaluation alone failed (``x_raw[:, nt−1]`` outside).

    ``fused_gamma`` finds these slots by comparing the stored positions
    with the center, as the reference does; that breaks silently if a
    later transform perturbs the positions. This function does not look
    at them. Nothing on a path calls it yet: the tests hold the two to
    each other."""
    nt = x_raw.shape[1]
    last_out = ~in_domain(loc, x_raw[:, nt - 1])
    t = torch.arange(nt, device=x_raw.device)[None, :]
    escaped = mask | (kfail.to(torch.int64) < nt)
    return escaped[:, None] | ((t == nt - 1) & last_out[:, None])


def point_source_rhs(space: TaylorHoodSpace, u: torch.Tensor,
                     x: torch.Tensor, mu: torch.Tensor, u_d: torch.Tensor,
                     mask: torch.Tensor, h: float, center: torch.Tensor,
                     method: str = "scatter",
                     active_t: torch.Tensor = None, grid=None,
                     u_values: torch.Tensor = None) -> torch.Tensor:
    """Assemble b = Σ_{buoys,k} γ·δ(x_k) into a mixed-space vector.

    u: (n_p2, 2); x, mu, u_d: (K, nt, 2); mask: (K,) bool. ``active_t``
    (K, nt) bool overrides the whole-buoy masking per (buoy, time): the
    consistent adjoint mode keeps escaped buoys' pre-escape sources.

    * "scatter": location, basis and scatter-add in plain PyTorch
      (``index_add_``: on the card its float64 atomics make the sum
      order, and so the last bits, vary from run to run),
    * "binned", "sorted", "ozaki": per-cell sums (S, 12) by the segment
      reductions of ``ops/scatter.py``, then a fixed-order gather onto
      the dofs. "ozaki" sums exactly, through the CUDA kernel
      ``csrc/segment_sum.cu`` on the card, so the whole stage is
      bit-reproducible; "ozaki_pallas" (the JAX name of the kernel path)
      is the same function,
    * "fused" (needs ``grid`` and the primal ``u_values``): γ from the
      primal ODE's own evaluations, then the CUDA point-source kernel
      (``adjoint/cuda_psrc.py``; bit-reproducible).
    """
    K, nt, _ = x.shape
    n_p1 = space.n_p1
    active = (~mask)[:, None].expand(K, nt) if active_t is None else active_t
    if method == "fused":
        if grid is None or u_values is None:
            raise ValueError("psrc_method='fused' needs the half-grid "
                             "tables and the primal u_values")
        from .cuda_psrc import point_source_image
        gamma = fused_gamma(space, u, x, mu, u_d, active, h, center,
                            u_values)
        b_vel = point_source_image(grid, x, gamma)
        return torch.cat([b_vel.reshape(-1), b_vel.new_zeros(n_p1)])
    if method != "scatter" and method not in _SEGMENT_SUMS:
        raise NotImplementedError(
            f"ocean_torch point sources: unknown method {method!r}")
    cell, vals = point_source_terms(space, u, x, mu, u_d, active, h, center)
    if method == "scatter":
        dofs = space.cell_dofs_p2[cell]
        b_vel = u.new_zeros(space.n_p2, 2).index_add_(
            0, dofs.reshape(-1), vals.reshape(-1, 2))
        return torch.cat([b_vel.reshape(-1), b_vel.new_zeros(n_p1)])
    per_cell = _SEGMENT_SUMS[method](cell, vals.reshape(-1, 12),
                                     space.num_cells)         # (S, 12)
    # cell → dof in a fixed order: per_cell (S, 6, 2) is laid out like the
    # velocity columns of cell_dofs_mixed; zero pressure columns make the
    # gather through its transpose incidence return the mixed vector
    per_cell = torch.cat([per_cell, per_cell.new_zeros(space.num_cells, 3)],
                         dim=1)
    return gather_sum(per_cell, space.inc_mixed)
