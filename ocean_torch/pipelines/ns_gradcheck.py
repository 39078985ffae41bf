"""Coupled NS+ODE gradient-check harness (port of
``ocean_jax/pipelines/ns_gradcheck.py``).

The whole coupled system against finite differences: nonlinear NS on the
unit square (Γ₁ = {x=0} only, no boundary stabilization term), buoy
advection with the analytic measurements
u_d1(t) = 0.5 (cos(π(t − 0.5)) − 1 − cos π), the *implicit* adjoint ODE
(I + h∇uᵀ) μ_k = … with its u_d[k] time index, the point-source adjoint
RHS, and the one-sided and centred tables over h = 10⁻³ … 10⁻¹¹ in the
reference's file format.

Every stage runs in plain PyTorch on ``device``: the primal ODE is the
table path ``ode.solve_primal_ode`` and the point sources are the
"scatter" method, as the JAX harness calls its reference ODE and no
Pallas kernel.

    python -m ocean_torch.pipelines.ns_gradcheck --device cpu --nx 8 --K 3
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import control as ctrl_mod
from ..adjoint import point_source_rhs
from ..device import resolve_device
from ..fem import (assemble, make_space, make_boundary_quad,
                   dirichlet_velocity_bc)
from ..io import artifacts
from ..mesh import unit_square_mesh, mark_boundary_facets
from ..ode import solve_primal_ode, solve_adjoint_ode_implicit
from ..solve import newton_solve, solve_operator, GradProjector

_EPS = 1e-12


def build(nx: int = 32, K: int = 5, alpha: float = 1e-2,
          viscosity: float = 1.0, t0: float = 0.0, T: float = 1.0,
          dt: float = 0.005, device="cuda") -> dict:
    """The harness's problem on ``device``. u_d is sampled on
    linspace(t0, T, nt), spacing T/(nt−1), as in the reference; the seeds
    are x0 = (0.2, linspace(0.2, 0.9, K))."""
    dev = resolve_device(device)
    mesh = unit_square_mesh(nx)
    space = make_space(mesh, dev)
    tags = mark_boundary_facets(mesh, lambda x: np.abs(x[:, 0]) < _EPS)
    bq = make_boundary_quad(mesh, tags, tag=1, device=dev)
    bc_dofs, bc_vals = dirichlet_velocity_bc(
        mesh, space, lambda x: x[:, 0] > _EPS)
    nt = int(T / dt)
    t = np.linspace(t0, T, nt)
    ud1 = 0.5 * (np.cos(np.pi * (t - 0.5)) - 1 - np.cos(np.pi))
    u_d = np.zeros((K, nt, 2))
    u_d[:, :, 0] = ud1
    x0 = np.stack([np.full(K, 0.2), np.linspace(0.2, 0.9, K)], axis=1)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    return dict(mesh=mesh, space=space, bq=bq, bc=(bc_dofs, bc_vals),
                u_d=f64(u_d), x0=f64(x0), alpha=alpha, nu=viscosity, h=dt,
                nt=nt, projector=GradProjector.build(space),
                center=f64([0.5, 0.5]))


def default_control(p: dict) -> ctrl_mod.Control:
    """f = df = (y(1 − y), 0)."""
    return ctrl_mod.from_expression(
        p["space"], p["bq"],
        lambda x: np.stack([x[:, 1] * (1 - x[:, 1]),
                            np.zeros(len(x))], axis=1))


def solve_state(p: dict, f_quad: torch.Tensor):
    """Newton solve of the harness's form: ν = 1 and no Γ₁ stabilization
    term (the load stays)."""
    space, bq, (bc_dofs, bc_vals) = p["space"], p["bq"], p["bc"]

    def residual(w):
        return assemble.ns_residual(space, bq, w, f_quad, 1.0,
                                    boundary_stab=False)

    def operator(w):
        return assemble.ns_operator(space, bq, w, 1.0, bc_dofs,
                                    boundary_stab=False)

    w0 = torch.zeros(space.ndof, dtype=torch.float64, device=space.device)
    return newton_solve(residual, operator, w0, bc_dofs, bc_vals)


def forward(p: dict, f_quad: torch.Tensor):
    """(w, primal ODE result) for a control."""
    res = solve_state(p, f_quad)
    u, _ = p["space"].split(res.w)
    ode = solve_primal_ode(p["space"], u, p["x0"], p["h"], p["nt"],
                           p["center"])
    return res.w, ode


def cost(p: dict, u_values: torch.Tensor, f_quad: torch.Tensor) -> float:
    part_a = 0.5 * float(torch.sum(
        p["h"] * torch.sum((u_values - p["u_d"]) ** 2, dim=-1)))
    part_b = 0.5 * p["alpha"] * float(torch.sum(
        p["bq"].weights * torch.sum(f_quad ** 2, dim=-1)))
    return part_a + part_b


def run(nx: int = 32, K: int = 5, alpha: float = 1e-2,
        out_dir: Optional[str] = None, ks=range(3, 12), verbose=print,
        device="cuda") -> dict:
    """gradj, J0 and the one-sided and centred rows; with ``out_dir`` the
    tables ``grad_J_error_0.txt`` and ``grad_J_error_centered_0.txt``."""
    p = build(nx=nx, K=K, alpha=alpha, device=device)
    space, bq = p["space"], p["bq"]
    f = default_control(p)
    df = default_control(p)

    w, ode = forward(p, f.quad)
    u, _ = space.split(w)
    grad_u = p["projector"].project(space, u)
    mu = solve_adjoint_ode_implicit(space, grad_u, u, ode.x, p["u_d"],
                                    p["h"], ud_index="k")
    no_mask = torch.zeros(K, dtype=torch.bool, device=space.device)
    b = point_source_rhs(space, u, ode.x, mu, p["u_d"], no_mask, p["h"],
                         p["center"])
    # the harness's adjoint form: volume terms only
    op = assemble.adjoint_operator(space, None, w, p["bc"][0])
    z = solve_operator(op, b, p["bc"][1])
    zu, _ = space.split(z)
    z_ctrl = ctrl_mod.from_p2(space, bq, zu)
    g = ctrl_mod.Control(alpha * f.quad - z_ctrl.quad,
                         alpha * f.p2 - z_ctrl.p2)
    gradj = float(ctrl_mod.boundary_inner(bq, g, df))
    j0 = cost(p, ode.u_values, f.quad)
    verbose(f"J0 = {j0}")

    one_rows, cen_rows = [], []
    for k in ks:
        h_ = 10.0 ** (-k)
        _, ode_p = forward(p, f.quad + h_ * df.quad)
        jp = cost(p, ode_p.u_values, f.quad + h_ * df.quad)
        ga = (jp - j0) / h_
        one_rows.append((ga, abs(ga - gradj), h_))
        _, ode_m = forward(p, f.quad - h_ * df.quad)
        jm = cost(p, ode_m.u_values, f.quad - h_ * df.quad)
        gc = (jp - jm) / (2 * h_)
        cen_rows.append((gc, abs(gradj - gc), h_))

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        artifacts.write_grad_table(
            os.path.join(out_dir, "grad_J_error_0.txt"), gradj, one_rows)
        artifacts.write_grad_table(
            os.path.join(out_dir, "grad_J_error_centered_0.txt"), gradj,
            cen_rows)
    return {"gradj": gradj, "J0": j0, "one_sided": one_rows,
            "centered": cen_rows}


if __name__ == "__main__":
    import argparse
    _p = argparse.ArgumentParser(prog="ocean_torch.pipelines.ns_gradcheck")
    _p.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    _p.add_argument("--nx", type=int, default=32)
    _p.add_argument("--K", type=int, default=5)
    _p.add_argument("--alpha", type=float, default=1e-2)
    _p.add_argument("--out-dir", default=None)
    _a = _p.parse_args()
    run(_a.nx, _a.K, _a.alpha, out_dir=_a.out_dir, device=_a.device)
