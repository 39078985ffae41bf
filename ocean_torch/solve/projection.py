"""L2 projection of ∇u onto the P1 tensor space (port of the dense
branch of ``ocean_jax/solve/projection.py``).

The P1 mass matrix is constant: it is assembled and factorized once per
problem, and every projection is one block solve of its four component
right-hand sides through the float64 factors. The matrix-free CG branch (past 20k P1 dofs) is not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fem.spaces import TaylorHoodSpace
from ..fem import assemble
from ..ops import linalg

DENSE_P1_CAP = 20_000


@dataclasses.dataclass(frozen=True)
class GradProjector:
    fac: linalg.LUSolver           # of the dense P1 mass matrix

    @classmethod
    def build(cls, space: TaylorHoodSpace,
              solver: str = "auto") -> "GradProjector":
        use_cg = (solver == "cg"
                  or (solver == "auto" and space.n_p1 > DENSE_P1_CAP))
        if use_cg:
            raise NotImplementedError(
                "ocean_torch ports the dense ∇u projection only "
                f"(n_p1={space.n_p1}, solver={solver!r})")
        return cls(linalg.factorize(assemble.p1_mass_matrix(space)))

    def project(self, space: TaylorHoodSpace, u: torch.Tensor
                ) -> torch.Tensor:
        """u: (n_p2, 2) velocity dofs → (n_p1, 2, 2) nodal ∇u values."""
        b = assemble.gradu_projection_rhs(space, u).reshape(space.n_p1, 4)
        return self.fac.solve(b).reshape(space.n_p1, 2, 2)
