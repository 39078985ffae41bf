"""Dense linear algebra for the saddle-point solves (port of
``ocean_jax/ops/linalg.py``).

The JAX package factors in float32 and builds an explicit float32 inverse
because the TPU has no native float64. Hopper has, so the port factors
in float64 (``torch.linalg.lu_factor``) and solves with ``lu_solve``,
transposed through the same factors where the adjoint asks for it.
These solves sit outside every kernel of the JAX package, so a library
call stands here. ``solve_refined`` keeps the refinement against the
exact float64 matvec: with float64 factors of a NEARBY operator (the
stale Stokes factor of the chord Newton) it is still what makes the
solve exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class LUSolver:
    """float64 LU factors of a dense operator."""

    lu: torch.Tensor
    piv: torch.Tensor

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A⁻¹ b for a vector (n,) or a block (n, k)."""
        vec = b.dim() == 1
        x = torch.linalg.lu_solve(self.lu, self.piv,
                                  b[:, None] if vec else b)
        return x[:, 0] if vec else x

    def solve_t(self, b: torch.Tensor) -> torch.Tensor:
        """A⁻ᵀ b through the same factors."""
        vec = b.dim() == 1
        x = torch.linalg.lu_solve(self.lu, self.piv,
                                  b[:, None] if vec else b, adjoint=True)
        return x[:, 0] if vec else x


def factorize(a: torch.Tensor) -> LUSolver:
    """LU-factorize a dense float64 matrix."""
    lu, piv = torch.linalg.lu_factor(a.to(torch.float64))
    return LUSolver(lu, piv)


def solve_refined(fac: LUSolver,
                  matvec64: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Solve A x = b with ``iters`` refinement sweeps against the exact
    float64 action ``matvec64`` of the operator the factors approximate."""
    x = fac.solve(b)
    for _ in range(iters):
        x = x + fac.solve(b - matvec64(x))
    return x
