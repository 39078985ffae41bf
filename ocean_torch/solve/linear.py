"""Linear saddle-point solves (port of ``ocean_jax/solve/linear.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..fem.assemble import Operator, apply_bc_vector
from ..ops import linalg
from ..utils import timing


def solve_operator(op: Operator, b: torch.Tensor, bc_vals: torch.Tensor,
                   refine_iters: int = 12) -> torch.Tensor:
    """Solve op x = b with Dirichlet values imposed on constrained dofs."""
    b = apply_bc_vector(b, op.bc_dofs, bc_vals)
    fac = linalg.factorize(op.dense())
    return linalg.solve_refined(fac, op.matvec64, b, refine_iters)


def solve_operator_reuse_t(op: Operator, b: torch.Tensor,
                           bc_vals: torch.Tensor, fac,
                           tol: float = 1e-12, max_iters: int = 30,
                           refine_iters: int = 12
                           ) -> Tuple[torch.Tensor, bool]:
    """Solve op x = b without a new factorization, preconditioned by the
    TRANSPOSED factors of a nearby primal operator: ``fac`` is an
    ``linalg.LUSolver`` (float64 or float32 factors, transposed through
    ``lu_solve``) or an ``linalg.InvSolver`` (its materialized A⁻ᵀ).

    For ν=1 the reference's adjoint form is exactly the transpose of the
    primal NS Jacobian, so the Newton solve's factors, applied transposed,
    precondition the adjoint solve; BC-projected Richardson refinement
    against the exact float64 adjoint matvec absorbs the state lag and the
    stale Stokes factor of the chord Newton. J has identity ROWS at
    constrained dofs, so Jᵀ has identity columns: re-projecting x onto the
    BC values each sweep keeps the boundary exact.

    Returns (x, converged). When the sweeps do not reach ``tol·‖b‖``
    within ``max_iters``, the operator is factorized afresh and solved
    with refinement, so the result is accurate either way."""
    b = apply_bc_vector(b, op.bc_dofs, bc_vals)
    target = tol * max(timing.to_host(torch.linalg.norm(b)), 1e-300)
    b_bc = b[op.bc_dofs]

    def project(x):
        return x.index_copy(0, op.bc_dofs, b_bc)

    x = project(fac.solve_t(b))
    r = b - op.matvec64(x)
    rnorm = timing.to_host(torch.linalg.norm(r))
    it = 0
    while rnorm > target and it < max_iters and rnorm == rnorm \
            and rnorm != float("inf"):
        x = project(x + fac.solve_t(r))
        r = b - op.matvec64(x)
        rnorm = timing.to_host(torch.linalg.norm(r))
        it += 1
    timing.count(rounds=it)
    converged = rnorm <= target
    if not converged:
        f2 = linalg.factorize(op.dense())
        x = linalg.solve_refined(f2, op.matvec64, b, refine_iters)
    return x, converged
