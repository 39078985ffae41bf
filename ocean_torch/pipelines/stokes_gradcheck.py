"""Stokes gradient-check pipeline (port of
``ocean_jax/pipelines/stokes_gradcheck.py``): the canonical verification
harness of the reference.

Linear Stokes on the unit square (Nx=32), Neumann control on
Γ₁ = {x=0} ∪ {x=1}, homogeneous Dirichlet conditions on the rest, a
tracking cost against the constant field u_d = (1, 1), and the adjoint
reduced gradient against one-sided and centred finite differences over
h = 1e-3 … 1e-11, plus ‖div u‖_{L²}.

The Stokes operator does not depend on the control, so one float64 LU
factorization serves the state, the adjoint and the whole
finite-difference ladder. ``solve_state`` is differentiable as it stands
(``lu_solve`` and the element matvec carry autograd), so
``torch.autograd.grad`` of ``cost(solve_state(f), f)`` is the exact
discrete gradient.

    python -m ocean_torch.pipelines.stokes_gradcheck --device cpu --nx 16
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import control as ctrl_mod
from ..device import resolve_device
from ..fem import (make_space, make_boundary_quad, dirichlet_velocity_bc,
                   assemble)
from ..fem.spaces import TaylorHoodSpace, BoundaryQuad
from ..mesh import unit_square_mesh, mark_boundary_facets
from ..ops import linalg

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class StokesProblem:
    space: TaylorHoodSpace
    bq: BoundaryQuad
    bc_dofs: torch.Tensor
    bc_vals: torch.Tensor
    op: assemble.Operator
    fac: linalg.LUSolver
    alpha: float
    ud: torch.Tensor


def build(nx: int = 32, alpha: float = 1e-2, device="cuda") -> StokesProblem:
    """The problem on ``device``: mesh, Γ₁ quadrature, Dirichlet dofs and
    the factorized Stokes operator (ν=1, no convection, no Γ₁ term)."""
    dev = resolve_device(device)
    mesh = unit_square_mesh(nx)
    space = make_space(mesh, dev)
    tags = mark_boundary_facets(
        mesh, lambda x: (np.abs(x[:, 0]) < _EPS)
        | (np.abs(1.0 - x[:, 0]) < _EPS))
    bq = make_boundary_quad(mesh, tags, tag=1, device=dev)
    bc_dofs, bc_vals = dirichlet_velocity_bc(
        mesh, space,
        lambda x: (x[:, 0] > _EPS) & (np.abs(1.0 - x[:, 0]) > _EPS))
    w0 = torch.zeros(space.ndof, dtype=torch.float64, device=dev)
    op = assemble.ns_operator(space, None, w0, 1.0, bc_dofs, convection=False)
    fac = linalg.factorize(op.dense())
    return StokesProblem(space, bq, bc_dofs, bc_vals, op, fac, alpha,
                         torch.tensor([1.0, 1.0], dtype=torch.float64,
                                      device=dev))


def default_control(prob: StokesProblem) -> ctrl_mod.Control:
    """f = df = (y(1 − y), 0)."""
    return ctrl_mod.from_expression(
        prob.space, prob.bq,
        lambda x: np.stack([x[:, 1] * (1 - x[:, 1]),
                            np.zeros(len(x))], axis=1))


def solve_state(prob: StokesProblem, f_quad: torch.Tensor) -> torch.Tensor:
    """The Stokes state for a control given by its Γ₁ quadrature values."""
    b = assemble.boundary_load(prob.space, prob.bq, f_quad)
    b = assemble.apply_bc_vector(b, prob.bc_dofs, prob.bc_vals)
    return linalg.solve_refined(prob.fac, prob.op.matvec64, b)


def solve_adjoint(prob: StokesProblem, w: torch.Tensor) -> torch.Tensor:
    """Adjoint solve: the same operator, RHS ∫ (u − u_d)·v dx."""
    u, _ = prob.space.split(w)
    b = assemble.volume_tracking_rhs(prob.space, u, prob.ud)
    b = assemble.apply_bc_vector(b, prob.bc_dofs, prob.bc_vals)
    return linalg.solve_refined(prob.fac, prob.op.matvec64, b)


def cost(prob: StokesProblem, w: torch.Tensor,
         f_quad: torch.Tensor) -> torch.Tensor:
    """J = ∫ 0.5 |u − u_d|² dx + α/2 ∫_{Γ₁} |f|² ds."""
    u, _ = prob.space.split(w)
    part_a = assemble.l2_tracking_volume(prob.space, u, prob.ud)
    part_b = 0.5 * prob.alpha * torch.sum(
        prob.bq.weights * torch.sum(f_quad ** 2, dim=-1))
    return part_a + part_b


def gradient_tables(prob: StokesProblem,
                    f: Optional[ctrl_mod.Control] = None,
                    df: Optional[ctrl_mod.Control] = None,
                    ks=range(3, 12)) -> dict:
    """The adjoint gradient ∫ (z + αf)·df ds against finite differences:
    gradj, J0, the one-sided and centred rows (approximation, error, h),
    ‖div u‖ and the state and adjoint vectors."""
    f = default_control(prob) if f is None else f
    df = default_control(prob) if df is None else df
    w = solve_state(prob, f.quad)
    j0 = float(cost(prob, w, f.quad))
    z = solve_adjoint(prob, w)
    zu, _ = prob.space.split(z)
    z_ctrl = ctrl_mod.from_p2(prob.space, prob.bq, zu)
    gradj = float(ctrl_mod.boundary_inner(
        prob.bq, ctrl_mod.Control(z_ctrl.quad + prob.alpha * f.quad,
                                  z_ctrl.p2 + prob.alpha * f.p2), df))

    one_sided, centered = [], []
    for k in ks:
        h = 10.0 ** (-k)
        f_p = f.quad + h * df.quad
        j_p = float(cost(prob, solve_state(prob, f_p), f_p))
        ga = (j_p - j0) / h
        one_sided.append((ga, abs(ga - gradj), h))
        f_m = f.quad - h * df.quad
        j_m = float(cost(prob, solve_state(prob, f_m), f_m))
        gc = (j_p - j_m) / (2 * h)
        centered.append((gc, abs(gc - gradj), h))

    u, _ = prob.space.split(w)
    div_l2 = float(assemble.divergence_l2(prob.space, u))
    return {"gradj": gradj, "J0": j0, "one_sided": one_sided,
            "centered": centered, "div_l2": div_l2, "w": w, "z": z}


def run(nx: int = 32, alpha: float = 1e-2, out=print, device="cuda") -> dict:
    """Build, compute the tables and print them as the reference script
    does."""
    prob = build(nx, alpha, device=device)
    res = gradient_tables(prob)
    out("Gradient, one sided Approximation, Error, h")
    for ga, err, h in res["one_sided"]:
        out(f"{res['gradj']} {ga} {err} {h}")
    out("")
    out("Gradient, symmetric Approximation, Error, h")
    for gc, err, h in res["centered"]:
        out(f"{res['gradj']} {gc} {err} {h}")
    out("")
    out(f"||div u||_L2 =  {res['div_l2']}")
    return res


if __name__ == "__main__":
    import argparse
    _p = argparse.ArgumentParser(prog="ocean_torch.pipelines.stokes_gradcheck")
    _p.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    _p.add_argument("--nx", type=int, default=32)
    _p.add_argument("--alpha", type=float, default=1e-2)
    _a = _p.parse_args()
    run(_a.nx, _a.alpha, device=_a.device)
