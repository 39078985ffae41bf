"""Gen-1 orchestration driver (port of ``ocean_jax/gen1/main.py``; the
reference's ``old_dolfinx_files/main.py``).

The class-based gradient-descent loop:

    for i in range(num_steps):
        w_r   = ns.solve_stokes_step(q)
        w     = ns.state_solving_step(q, u_r, i)
        x     = ode.ode_solving_step(u)
        lam_2 = ode.adjoint_ode_solving_step(u)
        w_adj, J, u_vals = ns.adjoint_state_solving_step(...)
        q ← q − μ(αq − u_adj)          # raw dof update

Fixed learning rate, no line search. On the card by default:

    python -m ocean_torch.gen1.main                 # 3 steps, nx=32, K=5
    python -m ocean_torch.gen1.main --device cpu --nx 8 --K 3
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import control as ctrl_mod
from ..device import resolve_device
from ..fem import make_space, make_boundary_quad, dirichlet_velocity_bc
from ..mesh import unit_square_mesh, mark_boundary_facets
from .solvers import NavierStokesSolver, ODESolver
from . import helpers

_EPS = 1e-12


def run(nx: int = 32, K: int = 5, num_steps: int = 10, lr: float = 0.5,
        alpha: float = 1e-2, viscosity: float = 1.0, delta: float = 0.1,
        grad_check: bool = False, verbose: bool = True, device="cuda"):
    """Gen-1 style run on the unit square with Γ₁ = {x=0} (the inlet).
    Returns {"J": [J per step], "q": final control}, plus
    "grad_check": the centred FD rows (quotient, error, h) and "gradj"
    when ``grad_check``."""
    dev = resolve_device(device)
    mesh = unit_square_mesh(nx)
    space = make_space(mesh, dev)
    tags = mark_boundary_facets(mesh, lambda x: np.abs(x[:, 0]) < _EPS)
    bq = make_boundary_quad(mesh, tags, tag=1, device=dev)
    bc = dirichlet_velocity_bc(mesh, space, lambda x: x[:, 0] > _EPS)

    ns = NavierStokesSolver(space, bq, *bc, viscosity=viscosity,
                            alpha=alpha, delta=delta, device=dev)
    ode = ODESolver(space, K, device=dev)
    q = ctrl_mod.from_expression(
        space, bq, lambda x: np.stack(
            [x[:, 1] * (1 - x[:, 1]), np.zeros(len(x))], axis=1))

    out = {"J": []}
    for i in range(num_steps):
        if verbose:
            print(f"gen-1 GD iteration {i}")
        ns.solve_stokes_step(q)                  # the gen-1 warm-up, unused
        w = ns.state_solving_step(q, None, i)
        u, _ = space.split(w)
        x = ode.ode_solving_step(u)
        lam_2 = ode.adjoint_ode_solving_step(u)
        w_adj, J, _ = ns.adjoint_state_solving_step(u, lam_2, x, ode.h,
                                                    ode.u_d, q)
        out["J"].append(J)
        zu, _ = space.split(w_adj)
        z = ctrl_mod.from_p2(space, bq, zu)

        if grad_check and i == 0:
            g = ctrl_mod.Control(alpha * q.quad - z.quad,
                                 alpha * q.p2 - z.p2)
            dq = ctrl_mod.constant(space, bq, [0.1, 0.1])
            gradj = float(ctrl_mod.boundary_inner(bq, g, dq))
            rows = helpers.test_gradient_centered_finite_differences_NS(
                ns, ode, q, dq, gradj, ks=range(1, 7))
            out["gradj"], out["grad_check"] = gradj, rows
            if verbose:
                for gc, err, h in rows:
                    print(f"  centered FD {gc:+.6e} err {err:.3e} h={h:g}")

        # raw dof update q ← q − μ(αq − u_adj)
        q = ctrl_mod.Control(q.quad - lr * (alpha * q.quad - z.quad),
                             q.p2 - lr * (alpha * q.p2 - z.p2))
        if verbose:
            print(f"  J = {J:.6e}")
    out["q"] = q
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--K", type=int, default=5)
    ap.add_argument("--num-steps", type=int, default=3)
    ap.add_argument("--grad-check", action="store_true")
    a = ap.parse_args(argv)
    run(nx=a.nx, K=a.K, num_steps=a.num_steps, grad_check=a.grad_check,
        device=a.device)


if __name__ == "__main__":
    main()
