"""Dense linear algebra for the saddle-point solves (port of
``ocean_jax/ops/linalg.py``).

The JAX package factors in float32 because the TPU has no native float64.
Hopper has, so by default the port factors in float64
(``torch.linalg.lu_factor``) and solves with ``lu_solve``, transposed
through the same factors where the adjoint asks for it. Two knobs of the
JAX package select its float32 applies, and the port has them too:

* ``dense_apply="inverse"``: ``invert32`` builds the explicit float32
  inverse (``InvSolver``), so every apply is one float32 matrix-vector
  product instead of two triangular solves;
* ``newton_chord_f32``: ``factorize(a, torch.float32)`` gives float32 LU
  factors, whose ``solve32_raw`` feeds the all-float32 chord sweeps.

Both solvers have one interface: ``solve`` / ``solve_t`` return float64
(the float32 applies are rounded up, as the JAX package's ``solve32``),
``solve32_raw`` keeps float32, ``refactor`` builds the same kind from a
fresh matrix. These solves sit outside every kernel of the JAX package,
so a library call stands here. ``solve_refined`` keeps the refinement
against the exact float64 matvec: it is what makes a float32 apply, or
float64 factors of a nearby operator (the stale Stokes factor of the
chord Newton), solve exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def _as_block(b: torch.Tensor):
    return (b[:, None], True) if b.dim() == 1 else (b, False)


@dataclasses.dataclass(frozen=True)
class LUSolver:
    """LU factors of a dense operator, float64 or float32 (``lu.dtype``)."""

    lu: torch.Tensor
    piv: torch.Tensor

    def _solve(self, b: torch.Tensor, adjoint: bool) -> torch.Tensor:
        b2, vec = _as_block(b.to(self.lu.dtype))
        x = torch.linalg.lu_solve(self.lu, self.piv, b2, adjoint=adjoint)
        return x[:, 0] if vec else x

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A⁻¹ b in float64, for a vector (n,) or a block (n, k)."""
        return self._solve(b, False).to(torch.float64)

    def solve_t(self, b: torch.Tensor) -> torch.Tensor:
        """A⁻ᵀ b in float64, through the same factors."""
        return self._solve(b, True).to(torch.float64)

    def solve32_raw(self, b: torch.Tensor) -> torch.Tensor:
        """A⁻¹ b in float32, for the all-float32 chord sweeps."""
        return self._solve(b, False).to(torch.float32)

    def refactor(self, a: torch.Tensor) -> "LUSolver":
        """Factors of a fresh matrix, in this solver's precision."""
        return factorize(a, self.lu.dtype)


@dataclasses.dataclass(frozen=True)
class InvSolver:
    """Explicit float32 inverse with the ``LUSolver`` interface: every
    apply is one float32 product, rounded to float64 for ``solve`` and
    ``solve_t``. ``ainv_t`` is the materialized A⁻ᵀ (``with_transpose``),
    so a transposed apply reads a row-major matrix too."""

    ainv: torch.Tensor                  # (n, n) float32
    ainv_t: Optional[torch.Tensor] = None

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve32_raw(b).to(torch.float64)

    def solve_t(self, b: torch.Tensor) -> torch.Tensor:
        """(Aᵀ)⁻¹ b = A⁻ᵀ b."""
        b32 = b.to(torch.float32)
        if self.ainv_t is not None:
            return (self.ainv_t @ b32).to(torch.float64)
        return (self.ainv.T @ b32).to(torch.float64)

    def solve32_raw(self, b: torch.Tensor) -> torch.Tensor:
        return self.ainv @ b.to(torch.float32)

    def with_transpose(self) -> "InvSolver":
        """The same inverse with A⁻ᵀ materialized (+n² float32)."""
        return InvSolver(self.ainv, self.ainv.T.contiguous())

    def refactor(self, a: torch.Tensor) -> "InvSolver":
        s = invert32(a)
        return s.with_transpose() if self.ainv_t is not None else s


def factorize(a: torch.Tensor, dtype=torch.float64) -> LUSolver:
    """LU-factorize a dense matrix in ``dtype`` (float64 by default).

    A singular or non-finite matrix (the operator at a diverged Newton
    state) gives factors whose solves are non-finite, as in the JAX
    package, and does not raise: the callers' residual checks report it
    (``GDStepResult.diverged``). No host sync for the error check."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a.to(dtype))
    return LUSolver(lu, piv)


def invert32(a: torch.Tensor, chunk: int = 512) -> InvSolver:
    """Explicit float32 inverse: one float32 LU, then the identity's
    columns solved ``chunk`` at a time, so the right-hand side in flight
    is n × ``chunk`` and not n × n."""
    fac = factorize(a, torch.float32)
    n = a.shape[0]
    ainv = torch.empty((n, n), dtype=torch.float32, device=a.device)
    for start in range(0, n, chunk):
        width = min(chunk, n - start)
        e = torch.zeros((n, width), dtype=torch.float32, device=a.device)
        idx = torch.arange(width, device=a.device)
        e[start + idx, idx] = 1.0
        ainv[:, start:start + width] = torch.linalg.lu_solve(fac.lu, fac.piv,
                                                             e)
    return InvSolver(ainv)


def solve_refined(fac, matvec64: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Solve A x = b with ``iters`` refinement sweeps against the exact
    float64 action ``matvec64`` of the operator the factors (an
    ``LUSolver`` or an ``InvSolver``) approximate."""
    x = fac.solve(b)
    for _ in range(iters):
        x = x + fac.solve(b - matvec64(x))
    return x


def solve_dense(a64: torch.Tensor, b: torch.Tensor, iters: int = 12
                ) -> torch.Tensor:
    """One-shot dense solve of a small system (the P1 mass matrix of a
    projection): float64 factors, refined ``iters`` times against
    ``a64``."""
    return solve_refined(factorize(a64), lambda x: a64 @ x, b, iters)
