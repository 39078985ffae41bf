"""L2 projection of ∇u onto the P1 tensor space (port of
``ocean_jax/solve/projection.py``).

Two regimes:

* **dense** (below ``DENSE_P1_CAP`` P1 dofs): the P1 mass matrix is
  constant, so it is assembled and factorized once per problem, and every
  projection is one block solve of its four component right-hand sides
  through the float64 factors (``dense_apply="lu"``), or, with
  ``dense_apply="inverse"``, through its explicit float32 inverse with 8
  float64 refinement sweeps against the mass matrix, as in the JAX
  package.
* **cg** (above the cap, where the dense matrix would take gigabytes):
  the mass matrix is never formed. The P1 element mass is detJ·M_ref, so
  the matvec is one (ncell, 3)·(3, 3) contraction and a gather-sum; the
  four systems run together through lumped-mass (Jacobi) preconditioned
  CG in float64 with a fixed trip count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..fem.spaces import TaylorHoodSpace
from ..fem import assemble
from ..ops import linalg

# above this many P1 dofs CG takes over (the dense f64 mass matrix would
# be 3.2 GB at 20k dofs); Nx=192 has 37,249
DENSE_P1_CAP = 20_000

# lumped-Jacobi CG on the P1 consistent mass contracts ~0.4× an iteration
# whatever the resolution: 60 iterations reach float64 round-off with slack
CG_ITERS = 60


def _mass_matvec(space: TaylorHoodSpace, x: torch.Tensor) -> torch.Tensor:
    """y = M x for the P1 consistent mass, matrix-free; x: (n_p1, k)."""
    m_ref = torch.einsum("q,qa,qb->ab", space.qw, space.phi1, space.phi1)
    yl = space.cell_detj[:, None, None] * torch.einsum(
        "cak,ab->cbk", x[space.cell_dofs_p1], m_ref)
    return assemble.gather_sum(yl, space.inc_p1)


def _lumped_inverse(space: TaylorHoodSpace) -> torch.Tensor:
    """1 / rowsum(M): the lumped-mass Jacobi diagonal, (n_p1, 1)."""
    ones = torch.ones(space.n_p1, 1, dtype=torch.float64, device=space.device)
    return 1.0 / _mass_matvec(space, ones)


def _pcg(space: TaylorHoodSpace, minv: torch.Tensor, b: torch.Tensor,
         iters: int) -> torch.Tensor:
    """Preconditioned CG for M x = b, the k columns of b (n_p1, k) at once.
    Fixed trip count; the divisions are guarded, so iterations past
    convergence are no-ops, not NaNs."""
    def safe_div(a, d):
        nz = d != 0.0
        return torch.where(nz, a / torch.where(nz, d, torch.ones_like(d)),
                           torch.zeros_like(a))

    x = minv * b
    r = b - _mass_matvec(space, x)
    z = minv * r
    p = z
    rz = (r * z).sum(0)
    for _ in range(iters):
        ap = _mass_matvec(space, p)
        alpha = safe_div(rz, (p * ap).sum(0))
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = (r * z).sum(0)
        p = z + safe_div(rz_new, rz) * p
        rz = rz_new
    return x


# float64 refinement sweeps of the "inverse" apply (the JAX package's)
INVERSE_REFINE_ITERS = 8


@dataclasses.dataclass(frozen=True)
class GradProjector:
    # LU factors or explicit float32 inverse of the dense P1 mass matrix
    fac: Optional[object]
    lumped_inv: Optional[torch.Tensor]      # (n_p1, 1) Jacobi diagonal
    mode: str = "lu"                        # "lu" | "inverse" | "cg"
    mass: Optional[torch.Tensor] = None     # dense float64 ("inverse")

    @classmethod
    def build(cls, space: TaylorHoodSpace, dense_apply: str = "lu",
              solver: str = "auto") -> "GradProjector":
        """solver: "auto" picks dense up to ``DENSE_P1_CAP`` P1 dofs and cg
        above; "dense" / "cg" force a regime. ``dense_apply`` picks the
        dense apply: "lu" (float64 factors) or "inverse"."""
        use_cg = (solver == "cg"
                  or (solver == "auto" and space.n_p1 > DENSE_P1_CAP))
        if use_cg:
            return cls(None, _lumped_inverse(space), mode="cg")
        mass = assemble.p1_mass_matrix(space)
        if dense_apply == "inverse":
            return cls(linalg.invert32(mass), None, "inverse", mass)
        return cls(linalg.factorize(mass), None)

    def project(self, space: TaylorHoodSpace, u: torch.Tensor
                ) -> torch.Tensor:
        """u: (n_p2, 2) velocity dofs → (n_p1, 2, 2) nodal ∇u values."""
        b = assemble.gradu_projection_rhs(space, u).reshape(space.n_p1, 4)
        if self.mode == "cg":
            sol = _pcg(space, self.lumped_inv, b, CG_ITERS)
        elif self.mode == "inverse":
            sol = linalg.solve_refined(self.fac, lambda x: self.mass @ x, b,
                                       INVERSE_REFINE_ITERS)
        else:
            sol = self.fac.solve(b)
        return sol.reshape(space.n_p1, 2, 2)
