"""Primal buoy-advection ODE: explicit Euler over all buoys at once (port
of ``ocean_jax/ode/primal.py``).

A host loop over the nt−1 time steps replaces ``lax.scan``; every step is
vectorized over the buoy axis. Escape semantics are the reference's
(``OCP_dolfin.py:209-229``): when a buoy's position first leaves the
domain at step ``kfail``,

  * the buoy's whole trajectory is overwritten with the domain center,
  * ``mask[b] = True``,
  * u_values[j] for j < kfail keep their values, u_values[kfail] = 0,
    u_values[kfail+1] = u(center), later entries 0;

and if only the final evaluation at x[nt-1] fails, u_values[nt-1] = 0
and x[nt-1] = center with no mask set.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..fem.spaces import TaylorHoodSpace
from ..fem.interpolate import eval_velocity
from ..mesh.locate import Locator, in_domain


class PrimalODEResult(NamedTuple):
    x: torch.Tensor          # (K, nt, 2) trajectories
    u_values: torch.Tensor   # (K, nt, 2) velocities along trajectories
    mask: torch.Tensor       # (K,) bool — escaped buoys
    x_raw: torch.Tensor      # (K, nt, 2) positions before the overwrite
    kfail: torch.Tensor      # (K,) int32 first failing step (nt if none)


def euler_steps(eval_u: Callable, x0: torch.Tensor, h: float, nt: int):
    """Steps 0..nt−2 with the freeze/record rules: returns (x (K, nt, 2),
    u_rec (K, nt, 2) with u_rec[:, nt−1] = 0, failed (K,) bool, kfail
    (K,) int32)."""
    K = x0.shape[0]
    xs = x0.new_empty(K, nt, 2)
    us = x0.new_zeros(K, nt, 2)
    xs[:, 0] = x0
    pos = x0
    failed = torch.zeros(K, dtype=torch.bool, device=x0.device)
    kfail = torch.full((K,), nt, dtype=torch.int32, device=x0.device)
    for k in range(nt - 1):
        uv, inside = eval_u(pos)
        fail_now = (~inside) & (~failed)
        failed = failed | (~inside)
        kfail = torch.where(fail_now, k, kfail)
        pos = torch.where(failed[:, None], pos, pos + h * uv)
        us[:, k] = torch.where(failed[:, None], 0.0, uv)
        xs[:, k + 1] = pos
    return xs, us, failed, kfail


def finish_trajectories(loc: Locator, eval_u: Callable, x: torch.Tensor,
                        u_values: torch.Tensor, failed: torch.Tensor,
                        kfail: torch.Tensor, center: torch.Tensor
                        ) -> PrimalODEResult:
    """Post-loop semantics: the final evaluation at x[nt−1], the
    recentring, and the overwrite of escaped buoys."""
    nt = x.shape[1]
    x_raw = x
    u_center, _ = eval_u(center)
    last = x[:, nt - 1]
    last_inside = in_domain(loc, last)
    u_last, _ = eval_u(last)
    u_values = u_values.clone()
    u_values[:, nt - 1] = torch.where(last_inside[:, None], u_last, 0.0)
    x = x.clone()
    x[:, nt - 1] = torch.where(last_inside[:, None], last, center)

    ks = torch.arange(nt, device=x.device)[None, :]
    kf = kfail.to(torch.int64)[:, None]
    u_fail = torch.where((ks < kf)[..., None], u_values, 0.0)
    # in place: the same values, one trajectory-sized buffer fewer at the
    # peak of a forward solve's memory
    u_fail += torch.where((ks == kf + 1)[..., None], u_center[None, None, :],
                          0.0)
    m = failed[:, None, None]
    x = torch.where(m, center.expand_as(x), x)
    u_values = torch.where(m, u_fail, u_values)
    return PrimalODEResult(x, u_values, failed, x_raw, kfail)


def solve_primal_ode(space: TaylorHoodSpace, u: torch.Tensor,
                     x0: torch.Tensor, h: float, nt: int,
                     center: torch.Tensor, grid=None) -> PrimalODEResult:
    """Reference path: point evaluation through the locate/dofmap tables,
    or, with ``grid`` (an ``ode.grideval.GridEval``), through the
    table-free half-grid stencil (the same values to rounding). Plain
    PyTorch on every device: ``system._primal_ode`` runs the table path's
    steps on the card in ``ode/cuda_table_ode.py``'s kernel instead.
    u: (n_p2, 2) velocity dofs; x0: (K, 2) seeds; nt time samples."""
    if grid is not None:
        from .grideval import eval_velocity_grid, velocity_to_grid
        u_img = velocity_to_grid(grid, u)
        eval_u = lambda pts: eval_velocity_grid(grid, u_img, pts)
    else:
        eval_u = lambda pts: eval_velocity(space, u, pts)
    x, us, failed, kfail = euler_steps(eval_u, x0, h, nt)
    return finish_trajectories(space.locator, eval_u, x, us, failed, kfail,
                               center)
