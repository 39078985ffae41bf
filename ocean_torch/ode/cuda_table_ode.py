"""Primal buoy ODE on the locate/dofmap tables through the CUDA kernel
``csrc/table_ode.cu`` (the "gather" backend on the card).

The kernel runs steps 0..nt−2 of every buoy with the point evaluation of
``fem.interpolate.eval_velocity``: the owning cell from
``Locator.square_to_cell``, the reference coordinates from ``cell_v0`` and
``cell_jinv``, and the six P2 dofs of ``space.cell_dofs_p2``. The final
evaluation, the recentring and the escaped-buoy overwrite run afterwards
in plain float64 PyTorch (``ode.primal.finish_trajectories``), as after the
grid kernel of ``ode/cuda_ode.py``.

``table_ode_steps`` is the wrapper: on CUDA tensors it launches the kernel
(or raises); on CPU tensors it runs ``table_ode_steps_plain``, the
kernel's arithmetic in PyTorch and in its order: location by the plain
mirrors of ``csrc/grid.cuh`` in ``kernels.py``, and the two ``einsum`` of
the table path (the reference coordinates and the six-term sum) written
out as ordered sums. The kernel is bit-identical to it; it agrees with
``euler_steps(eval_velocity)`` to rounding, which sums in its own order.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fem.interpolate import eval_velocity, p2_basis
from ..fem.spaces import TaylorHoodSpace
from ..mesh.locate import _EPS
from .primal import PrimalODEResult, euler_steps, finish_trajectories

# int table_ode_launch(square_to_cell, cell_v0, cell_jinv, cell_dofs, u,
#                      x0, xs, us, failed, kfail, K, nt, Geom, h, stream)
_ARGTYPES = ([kernels.VOIDP] * 10 + [kernels.INT] * 2
             + [kernels.Geom, kernels.DOUBLE, kernels.VOIDP])


def eval_velocity_table(space: TaylorHoodSpace, u: torch.Tensor,
                        points: torch.Tensor):
    """The kernel's point evaluation in plain PyTorch: (values (M, 2),
    inside (M,)) at points (M, 2), as ``eval_velocity`` gives them to
    rounding. The clamped (on the L-shape, projected) position is located
    as ``csrc/grid.cuh::locate`` does; the owning cell is the square's
    lower or upper one (clamped to 0 where the square has none); then
    ξ = J⁻¹(p − v₀) row by row, the P2 basis at ξ, and the sum over the
    six dofs in their order."""
    loc = space.locator
    g = kernels.geom(loc, _EPS)
    px, py = points[:, 0], points[:, 1]
    qx = torch.clamp(px, g.xmin, g.xmax)
    qy = torch.clamp(py, g.ymin, g.ymax)
    inside = (px >= g.xmin_e) & (px <= g.xmax_e) & (py >= g.ymin_e) \
        & (py <= g.ymax_e)
    if g.lshape:
        qy = torch.where((qx < g.cx) & (qy > g.cy), g.y_proj, qy)
        inside = inside & ((py <= g.cy_e) | (px >= g.cx_e))
    nx, ny = loc.grid_shape
    if g.graded:
        ix, s = kernels.graded_axis(qx, loc.xs_lines, nx)
        iy, t = kernels.graded_axis(qy, loc.ys_lines, ny)
    else:
        ix, s = kernels.axis_coord(qx, g.ox, g.hx, g.inv_hx, nx)
        iy, t = kernels.axis_coord(qy, g.oy, g.hy, g.inv_hy, ny)
    if g.hole:
        inside = inside & kernels.off_obstacle(px, py, ix, iy, g,
                                               kernels.active_squares(loc))
    which = ((s + t > 1.0) if g.left else (t > s)).to(torch.int64)
    cell = torch.clamp(loc.square_to_cell[iy, ix, which], min=0)
    v0 = loc.cell_v0[cell]
    jinv = loc.cell_jinv[cell]
    d0, d1 = qx - v0[:, 0], qy - v0[:, 1]
    xi = jinv[:, 0, 0] * d0 + jinv[:, 0, 1] * d1
    eta = jinv[:, 1, 0] * d0 + jinv[:, 1, 1] * d1
    phi = p2_basis(torch.stack([xi, eta], dim=-1))
    vals = u[space.cell_dofs_p2[cell]]                   # (M, 6, 2)
    acc = phi[:, 0, None] * vals[:, 0]
    for a in range(1, 6):
        acc = acc + phi[:, a, None] * vals[:, a]
    return acc, inside


def table_ode_steps_plain(space: TaylorHoodSpace, u: torch.Tensor,
                          x0: torch.Tensor, h: float, nt: int):
    """Plain PyTorch version of the kernel: (x, u_rec, failed, kfail)."""
    return euler_steps(lambda p: eval_velocity_table(space, u, p), x0, h,
                       nt)


def table_ode_steps(space: TaylorHoodSpace, u: torch.Tensor,
                    x0: torch.Tensor, h: float, nt: int):
    """Steps 0..nt−2 of every buoy: u (n_p2, 2), x0 (K, 2) float64 →
    (x (K, nt, 2), u_rec (K, nt, 2), failed (K,) bool, kfail (K,) int32)."""
    if u.device.type == "cpu" and x0.device.type == "cpu":
        return table_ode_steps_plain(space, u, x0, h, nt)
    loc = space.locator
    u = u.contiguous()
    x0 = x0.contiguous()
    tables = (loc.square_to_cell, loc.cell_v0, loc.cell_jinv,
              space.cell_dofs_p2)
    kernels.require_cuda("table_ode", u, x0, *tables,
                         *kernels.grid_tables(loc))
    if u.dtype != torch.float64 or x0.dtype != torch.float64:
        raise ValueError("table_ode: float64 inputs required")
    K = x0.shape[0]
    if u.shape != (space.n_p2, 2) or x0.shape != (K, 2) or nt < 2:
        raise ValueError("table_ode: bad shapes")
    if u.data_ptr() % 16 or x0.data_ptr() % 16:      # read as double2
        u, x0 = u.clone(), x0.clone()
    fn = kernels.function("table_ode", "table_ode_launch", _ARGTYPES)
    xs = torch.empty(K, nt, 2, dtype=torch.float64, device=x0.device)
    us = torch.empty_like(xs)
    failed = torch.empty(K, dtype=torch.int32, device=x0.device)
    kfail = torch.empty(K, dtype=torch.int32, device=x0.device)
    status = fn(*(t.data_ptr() for t in tables), u.data_ptr(),
                x0.data_ptr(), xs.data_ptr(), us.data_ptr(),
                failed.data_ptr(), kfail.data_ptr(), K, nt,
                kernels.geom(loc, _EPS), h, kernels.stream_ptr(x0.device))
    kernels.check_launch("table_ode", status)
    kernels.LAUNCHES["table_ode"] += 1
    return xs, us, failed > 0, kfail


def solve_primal_ode_table_cuda(space: TaylorHoodSpace, u: torch.Tensor,
                                x0: torch.Tensor, h: float, nt: int,
                                center: torch.Tensor) -> PrimalODEResult:
    """``ode.primal.solve_primal_ode`` on the tables (no ``grid``) with
    its steps in the kernel: the same escape semantics, trajectories to
    rounding."""
    x, us, failed, kfail = table_ode_steps(space, u, x0, float(h), int(nt))
    eval_u = lambda pts: eval_velocity(space, u, pts)
    return finish_trajectories(space.locator, eval_u, x, us, failed, kfail,
                               center)
