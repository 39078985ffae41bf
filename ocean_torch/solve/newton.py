"""Newton solver for the stationary Navier–Stokes system (port of
``ocean_jax/solve/newton.py``).

A host loop replaces ``lax.while_loop``. Convergence criteria are
dolfin's ``NewtonSolver`` defaults (residual criterion, rtol 1e-9, atol
1e-10, 50 iterations). Dirichlet rows follow dolfin: the residual entry
at a constrained dof is ``w[dof] - g`` and the Jacobian row is identity.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jvp

from ..ops import linalg
from ..utils import timing


class NewtonResult(NamedTuple):
    w: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool
    # factors (an LUSolver or InvSolver) of the last Jacobian the solver
    # factorized (J(w0) under reuse_factorization); the adjoint solve
    # reuses them transposed
    fac: Optional[object] = None
    # FGMRES restart cycles of each step (the multigrid Newton,
    # solve/mg.py::newton_solve_mg); empty for the dense Newton
    krylov_cycles: tuple = ()


def newton_solve(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                 operator_fn: Callable[[torch.Tensor], "object"],
                 w0: torch.Tensor,
                 bc_dofs: torch.Tensor,
                 bc_vals: torch.Tensor,
                 rtol: float = 1e-9,
                 atol: float = 1e-10,
                 max_iter: int = 50,
                 reuse_factorization: bool = False,
                 correction_iters: int = 1,
                 fac0=None,
                 residual_fn32: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None
                 ) -> NewtonResult:
    """Solve residual(w) = 0 with BC-aware Newton.

    residual_fn: raw float64 residual (no BC rows); operator_fn: w →
    ``fem.assemble.Operator`` (the Jacobian with BC rows).

    ``reuse_factorization=True`` is the chord Newton: only J(w0) is
    factorized (or ``fac0`` is taken as its factors — for w0 = 0 that is
    the problem-constant Stokes operator), and each step solves
    J(w) δ = −r through those stale factors with ``correction_iters``
    Richardson sweeps δ ← δ + M⁻¹(−r − J(w) δ) against the exact J(w)·δ,
    taken as the forward-mode tangent of the BC-aware residual
    (``torch.func.jvp``; the assembled operator is jacfwd of the same
    element residuals, so it is the same linear map).

    ``fac0``: an ``linalg.LUSolver`` or ``linalg.InvSolver`` of J(w0).
    Without reuse each later step refactors in ``fac0``'s kind
    (``refactor``): float64 LU factors by default.

    ``residual_fn32``: the float32 twin of ``residual_fn`` (the same form
    on float32 tables). Given it and ``reuse_factorization``, the
    correction sweeps (tangent, applies) run in float32 through
    ``fac0.solve32_raw``; the float64 residual stays the only convergence
    test, so the accepted state differs only below the 1e-9·‖r0‖
    threshold.
    """
    is_bc = torch.zeros(w0.shape[0], dtype=torch.bool, device=w0.device)
    is_bc[bc_dofs] = True
    g_full = torch.zeros_like(w0).index_copy(0, bc_dofs, bc_vals)

    def bc_residual(w):
        return torch.where(is_bc, w - g_full, residual_fn(w))

    if residual_fn32 is not None:
        g_full32 = g_full.to(torch.float32)

        def bc_residual32(w32):
            return torch.where(is_bc, w32 - g_full32, residual_fn32(w32))

    def residual_and_norm(w):
        with timing.span("newton.residual"):
            r = bc_residual(w)
            return r, timing.to_host(torch.linalg.norm(r))

    r, r0norm = residual_and_norm(w0)
    if fac0 is None:
        with timing.span("newton.factor"):
            fac0 = linalg.factorize(operator_fn(w0).dense())

    w, rnorm, it, fac = w0, r0norm, 0, fac0
    while rnorm > atol and rnorm > rtol * r0norm and it < max_iter:
        if not reuse_factorization and it > 0:
            with timing.span("newton.factor"):
                fac = fac.refactor(operator_fn(w).dense())
        with timing.span("newton.step"):
            if reuse_factorization and residual_fn32 is not None:
                w32, r32 = w.to(torch.float32), r.to(torch.float32)
                dw32 = fac0.solve32_raw(-r32)
                for _ in range(correction_iters):
                    _, jdw = jvp(bc_residual32, (w32,), (dw32,))
                    dw32 = dw32 + fac0.solve32_raw(-(r32 + jdw))
                dw = dw32.to(torch.float64)
            elif reuse_factorization:
                dw = fac0.solve(-r)
                for _ in range(correction_iters):
                    _, jdw = jvp(bc_residual, (w,), (dw,))
                    dw = dw + fac0.solve(-(r + jdw))
            else:
                dw = fac.solve(-r)
            w = w + dw
        r, rnorm = residual_and_norm(w)
        it += 1
    converged = (rnorm <= atol) or (rnorm <= rtol * r0norm)
    return NewtonResult(w, it, rnorm, converged, fac)
