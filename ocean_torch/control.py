"""Boundary control representation (port of ``ocean_jax/control.py``).

The control is stored as its values at the Γ₁ quadrature points (what
every boundary integral of the reference consumes), plus a companion P2
coefficient vector updated in lockstep for IO.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .fem.spaces import TaylorHoodSpace, BoundaryQuad
from .fem.interpolate import boundary_eval_velocity, interpolate_p2


@dataclasses.dataclass(frozen=True)
class Control:
    """quad: (nf, nq, 2) values at Γ₁ quadrature points;
    p2: (n_p2, 2) companion P2 coefficients (IO only)."""

    quad: torch.Tensor
    p2: torch.Tensor

    def axpy(self, s: float, other: "Control") -> "Control":
        """self + s * other (the control update)."""
        return Control(self.quad + s * other.quad, self.p2 + s * other.p2)

    def scale(self, s: float) -> "Control":
        return Control(s * self.quad, s * self.p2)


def from_expression(space: TaylorHoodSpace, bq: BoundaryQuad,
                    fn: Callable[[np.ndarray], np.ndarray]) -> Control:
    """Control from an analytic expression, exact at the quad points."""
    pts = bq.points.cpu().numpy()
    quad = np.array(fn(pts.reshape(-1, 2)),
                    dtype=np.float64).reshape(pts.shape)
    return Control(torch.as_tensor(quad, device=space.device),
                   interpolate_p2(space, fn))


def from_p2(space: TaylorHoodSpace, bq: BoundaryQuad,
            u: torch.Tensor) -> Control:
    """Control from a P2 velocity field (warm starts, the adjoint state z);
    the boundary restriction is exact for P2 fields."""
    return Control(boundary_eval_velocity(space, bq, u), u)


def constant(space: TaylorHoodSpace, bq: BoundaryQuad, vec) -> Control:
    v = np.asarray(vec, dtype=np.float64)
    return from_expression(space, bq,
                           lambda x: np.broadcast_to(v, (len(x), 2)))


def boundary_l2_sq(bq: BoundaryQuad, ctrl: Control) -> torch.Tensor:
    """∫_{Γ₁} |f|² ds: the cost's Tikhonov term before the α/2 factor."""
    return torch.sum(bq.weights * torch.sum(ctrl.quad ** 2, dim=-1))


def boundary_inner(bq: BoundaryQuad, a: Control, b: Control) -> torch.Tensor:
    """∫_{Γ₁} a·b ds: the reduced-gradient inner product."""
    return torch.sum(bq.weights * torch.sum(a.quad * b.quad, dim=-1))
