"""Gen-1 FD-verification and field-evaluation helpers (port of
``ocean_jax/gen1/helpers.py``; the reference's
``old_dolfinx_files/helper_functions/helper_functions.py``).

Re-solve the coupled state+ODE system at q ± h·dq and tabulate |FD −
adjoint gradient|, including the variant where the control is a volume
force instead of a boundary force, plus batched trajectory evaluation
(``evaluate_fct``) and quiver-plot sampling (``eval_vector_field``).

The FD functions keep the gen-1 names ``test_gradient*``: import the
module (``from ocean_torch.gen1 import helpers``), not the names, where
pytest collects.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import control as ctrl_mod
from ..fem import assemble
from ..fem.interpolate import eval_velocity
from ..solve import newton_solve
from .solvers import NavierStokesSolver, ODESolver


def evaluate_fct(space, u, points) -> torch.Tensor:
    """Batched point evaluation of a velocity field along buoy
    trajectories."""
    dev = space.device
    vals, _ = eval_velocity(
        space, torch.as_tensor(u, dtype=torch.float64, device=dev),
        torch.as_tensor(points, dtype=torch.float64, device=dev))
    return vals


def _tracking(ode: ODESolver, u_vals: torch.Tensor) -> float:
    return 0.5 * float(torch.sum(ode.h * torch.sum((u_vals - ode.u_d) ** 2,
                                                   dim=-1)))


def _forward_J(ns: NavierStokesSolver, ode: ODESolver,
               q: ctrl_mod.Control) -> float:
    w = ns.state_solving_step(q)
    u, _ = ns.space.split(w)
    x = ode.ode_solving_step(u)
    return (_tracking(ode, evaluate_fct(ns.space, u, x))
            + 0.5 * ns.alpha * float(ctrl_mod.boundary_l2_sq(ns.bq, q)))


def test_gradient(ns: NavierStokesSolver, ode: ODESolver,
                  q: ctrl_mod.Control, dq: ctrl_mod.Control,
                  gradj: float, ks=range(1, 9)):
    """One-sided FD table: rows (quotient, |quotient − gradj|, h)."""
    j0 = _forward_J(ns, ode, q)
    rows = []
    for k in ks:
        h = 10.0 ** (-k)
        ga = (_forward_J(ns, ode, q.axpy(h, dq)) - j0) / h
        rows.append((ga, abs(ga - gradj), h))
    return rows


def test_gradient_centered_finite_differences_NS(
        ns: NavierStokesSolver, ode: ODESolver, q: ctrl_mod.Control,
        dq: ctrl_mod.Control, gradj: float, ks=range(1, 9)):
    """Centred FD table: rows (quotient, |quotient − gradj|, h)."""
    rows = []
    for k in ks:
        h = 10.0 ** (-k)
        jp = _forward_J(ns, ode, q.axpy(h, dq))
        jm = _forward_J(ns, ode, q.axpy(-h, dq))
        gc = (jp - jm) / (2 * h)
        rows.append((gc, abs(gc - gradj), h))
    return rows


def test_gradient_on_rhs_control(space, bq, bc, ode: ODESolver,
                                 q_p2: torch.Tensor, dq_p2: torch.Tensor,
                                 gradj: float, viscosity: float = 1.0,
                                 alpha: float = 1e-2, ks=range(1, 9)):
    """The variant where the control is a VOLUME force f ∈ P2 and J's
    Tikhonov term is ∫_Ω |f|² dx: one-sided FD rows."""
    bc_dofs, bc_vals = bc

    def f_at_quad(f_p2):
        return torch.einsum("qa,cai->cqi", space.phi2,
                            f_p2[space.cell_dofs_p2])

    def volume_load(f_p2):
        rv = torch.einsum("cq,cqi,qa->cai",
                          space.qw * space.cell_detj[:, None],
                          f_at_quad(f_p2), space.phi2)
        vals = torch.cat([rv.reshape(-1, 12),
                          rv.new_zeros((rv.shape[0], 3))], dim=1)
        return assemble.gather_sum(vals, space.inc_mixed)

    def solve_state(f_p2):
        load = volume_load(f_p2)
        res = newton_solve(
            lambda w: assemble.ns_residual(space, None, w, None,
                                           viscosity) - load,
            lambda w: assemble.ns_operator(space, None, w, viscosity,
                                           bc_dofs),
            torch.zeros(space.ndof, dtype=torch.float64,
                        device=space.device), bc_dofs, bc_vals)
        return res.w

    def j_of(f_p2):
        w = solve_state(f_p2)
        u, _ = space.split(w)
        x = ode.ode_solving_step(u)
        tikh = float(torch.sum(space.qw * space.cell_detj[:, None]
                               * torch.sum(f_at_quad(f_p2) ** 2, dim=-1)))
        return (_tracking(ode, evaluate_fct(space, u, x))
                + 0.5 * alpha * tikh)

    j0 = j_of(q_p2)
    rows = []
    for k in ks:
        h = 10.0 ** (-k)
        ga = (j_of(q_p2 + h * dq_p2) - j0) / h
        rows.append((ga, abs(ga - gradj), h))
    return rows


def eval_vector_field(space, u, nx: int = 25,
                      extent=(0.0, 0.0, 2.0, 2.0)) -> dict:
    """A velocity field sampled on a regular nx × nx grid for quiver
    plots; points outside the domain get 0. Numpy arrays."""
    xs = np.linspace(extent[0], extent[2], nx)
    ys = np.linspace(extent[1], extent[3], nx)
    xg, yg = np.meshgrid(xs, ys)
    pts = np.stack([xg.ravel(), yg.ravel()], axis=1)
    vals, inside = eval_velocity(
        space, torch.as_tensor(u, dtype=torch.float64, device=space.device),
        torch.as_tensor(pts, dtype=torch.float64, device=space.device))
    vals = np.where(inside.cpu().numpy()[:, None], vals.cpu().numpy(), 0.0)
    return {"x": xg, "y": yg,
            "u": vals[:, 0].reshape(nx, nx),
            "v": vals[:, 1].reshape(nx, nx)}
