#!/usr/bin/env python3
"""Why ``ocean_torch/solve/krylov.py::fgmres`` orthogonalizes twice.

    python3 scripts/fgmres_orthogonalization_torch.py

On the CPU, on the L-shape at resolution 13 with the multigrid solver
(``tests/test_mg.py::test_mg_lshape_staircase``'s problem), the float32
multigrid Newton solve of the port is run three ways and its residual
after every step printed:

* the port as it is (two classical Gram–Schmidt passes an Arnoldi step,
  CGS2), with 2 and with 8 PyTorch threads;
* the same Newton with one pass (the JAX package's Arnoldi), with 2 and
  with 8 threads;
* the JAX package's own Newton steps, taken one at a time with its
  ``krylov.fgmres`` and the same damping as ``newton_solve_mg``.

Each line also lists the float32 FGMRES residual each step reached,
relative to its right-hand side (the tolerance is 1e-6). Imports both
packages: run it where JAX runs (the CPU), not on the card.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def one_pass_fgmres(matvec, b, M=None, x0=None, restart=60,
                    max_restarts=10, tol=1e-10):
    """``krylov.fgmres`` with a single Gram–Schmidt pass."""
    import torch
    from ocean_torch.solve import krylov
    x = torch.zeros_like(b)
    tiny = torch.finfo(b.dtype).tiny
    target = tol * max(float(torch.linalg.norm(b)), tiny)
    r = b - matvec(x)
    rnorm, it = float(torch.linalg.norm(r)), 0
    while rnorm > target and it < max_restarts:
        beta = torch.linalg.norm(r)
        V = b.new_zeros((restart + 1, b.shape[0]))
        Z = b.new_zeros((restart, b.shape[0]))
        H = b.new_zeros((restart + 1, restart))
        V[0] = r / beta.clamp_min(tiny)
        for j in range(restart):
            z = M(V[j])
            w = matvec(z)
            hs = V[: j + 1] @ w
            w = w - hs @ V[: j + 1]
            hnew = torch.linalg.norm(w)
            V[j + 1] = w / hnew.clamp_min(tiny)
            H[: j + 1, j] = hs
            H[j + 1, j] = hnew
            Z[j] = z
        y = torch.as_tensor(krylov._lstsq64(H, float(beta)), dtype=b.dtype)
        x_new = x + y @ Z
        r_new = b - matvec(x_new)
        rnorm_new = float(torch.linalg.norm(r_new))
        if rnorm_new < rnorm:
            x, r, rnorm = x_new, r_new, rnorm_new
        it += 1
    return krylov.FGMRESResult(x, rnorm, it, rnorm <= target)


def port_newton(label, threads, fgmres=None, max_iter=12):
    import torch
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    from ocean_torch.solve import krylov
    torch.set_num_threads(threads)
    cfg = OCPConfig(L_shape=True, L_shape_resolution=13,
                    ud_experiment="3_buoys", linear_solver="mg",
                    T=0.05, dt=0.005)
    u_d, x0 = system.lshape_ud(cfg)
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    f = system.initial_control(prob, case=0)
    original = krylov.fgmres
    reached = []

    def traced(matvec, b, **kw):
        sol = (fgmres or original)(matvec, b, **kw)
        reached.append(sol.residual_norm / float(torch.linalg.norm(b)))
        return sol

    krylov.fgmres = traced
    try:
        from ocean_torch.solve import mg
        from ocean_torch.fem import assemble
        res = mg.newton_solve_mg(
            lambda w: assemble.ns_residual(prob.space, prob.bq, w, f.quad,
                                           prob.nu),
            lambda w: assemble.ns_operator(prob.space, prob.bq, w, prob.nu,
                                           prob.bc_dofs),
            None, prob.mg, prob.space,
            torch.zeros(prob.space.ndof, dtype=torch.float64),
            prob.bc_dofs, prob.bc_vals, max_iter=max_iter)
    finally:
        krylov.fgmres = original
    print(f"{label}, {threads} threads: {res.iterations} iterations, "
          f"final residual {res.residual_norm:.3e}, converged "
          f"{res.converged}; FGMRES relative residual a step "
          f"{[f'{v:.1e}' for v in reached]}", flush=True)


def jax_steps():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ocean_jax import system
    from ocean_jax.config import OCPConfig
    from ocean_jax.fem import assemble
    from ocean_jax.solve import krylov, mg
    cfg = OCPConfig(L_shape=True, L_shape_resolution=13,
                    ud_experiment="3_buoys", linear_solver="mg",
                    T=0.05, dt=0.005)
    u_d, x0 = system.lshape_ud(cfg)
    p = system.build_problem(cfg, u_d=u_d, x0=x0)
    f = system.initial_control(p, case=0)

    def res(w):
        return assemble.ns_residual(p.space, p.bq, w, f.quad, 1.0).at[
            p.bc_dofs].set(w[p.bc_dofs] - p.bc_vals)

    w = jnp.zeros(p.space.ndof)
    M = mg.make_block_preconditioner(
        p.mg, p.space, assemble.ns_operator(p.space, p.bq, w, 1.0,
                                            p.bc_dofs),
        None, dtype=jnp.float32)
    r = res(w)
    rn = r0 = float(jnp.linalg.norm(r))
    seq, reached = [rn], []
    for k in range(6):
        tol = 1e-6 if (rn > 1e-10 and rn > 1e-9 * r0) else 1e-8
        op = assemble.ns_operator(p.space, p.bq, w, 1.0, p.bc_dofs)
        mv = mg._stencil_or_scatter(p.mg.st_mixed, op, jnp.float32)
        sol = krylov.fgmres(mv, (-r).astype(jnp.float32), M=M, restart=60,
                            max_restarts=4, tol=tol)
        reached.append(float(sol.residual_norm) / rn)
        dw = sol.x.astype(jnp.float64)
        best = None
        for theta in (1.0, 0.5, 0.25, 0.125):
            c = w + theta * dw
            rc = res(c)
            nc = float(jnp.linalg.norm(rc))
            best = best or (c, rc, nc)
            if nc < rn:
                best = (c, rc, nc)
                break
        w, r, rn = best
        seq.append(rn)
        if tol == 1e-8:
            break
    print(f"JAX package's Newton steps (one pass): residuals "
          f"{[f'{v:.3e}' for v in seq]}; FGMRES relative residual a step "
          f"{[f'{v:.1e}' for v in reached]}", flush=True)


def main() -> int:
    for threads in (2, 8):
        port_newton("port, CGS2", threads)
        port_newton("port, one pass", threads, fgmres=one_pass_fgmres)
    jax_steps()
    return 0


if __name__ == "__main__":
    sys.exit(main())
