"""Adjoint buoy ODE: backward recursion for the costate μ (port of the
reference mode of ``ocean_jax/ode/adjoint.py``).

    μ[nt-1] = 0
    μ[k] = μ[k+1] − h ∇u(x[k+1])ᵀ ((u(x[k+1]) − u_d[k+1]) − μ[k+1])

A host loop over time, vectorized over buoys, replaces the JAX package's
``lax.scan``/associative scan (the two agree to rounding). ∇u is the
P1-projected gradient evaluated through the locate/dofmap tables; at an
out-of-domain point the previous ∇u is reused (the reference's
leftover-variable quirk, starting from zeros). Masked (escaped) buoys get
μ ≡ 0.
"""

from __future__ import annotations

import torch

from ..fem.spaces import TaylorHoodSpace
from ..fem.interpolate import eval_p1_tensor


def backward_steps(eval_g, x: torch.Tensor, resid: torch.Tensor,
                   vlimit: torch.Tensor, h: float) -> torch.Tensor:
    """The μ recursion over explicit per-step ∇u evaluations.

    eval_g(points (K, 2)) → (∇u (K, 2, 2), inside (K,)); resid = u − u_d
    (K, nt, 2); vlimit (K,): the ∇u factor is zeroed at steps t > vlimit
    (pass nt for the unrestricted recursion)."""
    K, nt, _ = x.shape
    mu = x.new_zeros(K, nt, 2)
    mu1 = x.new_zeros(K)
    mu2 = x.new_zeros(K)
    gc = x.new_zeros(K, 2, 2)
    for kc in range(nt - 2, -1, -1):
        t = kc + 1
        g, inside = eval_g(x[:, t])
        gc = torch.where(inside[:, None, None], g, gc)
        gu = torch.where((t <= vlimit)[:, None, None], gc, 0.0)
        d1 = resid[:, t, 0] - mu1
        d2 = resid[:, t, 1] - mu2
        mu1, mu2 = (mu1 - h * (gu[:, 0, 0] * d1 + gu[:, 1, 0] * d2),
                    mu2 - h * (gu[:, 0, 1] * d1 + gu[:, 1, 1] * d2))
        mu[:, kc, 0] = mu1
        mu[:, kc, 1] = mu2
    return mu


def solve_adjoint_ode(space: TaylorHoodSpace, grad_u: torch.Tensor,
                      x: torch.Tensor, u_values: torch.Tensor,
                      u_d: torch.Tensor, mask: torch.Tensor,
                      h: float) -> torch.Tensor:
    """Reference-mode μ. grad_u: (n_p1, 2, 2); x, u_values, u_d:
    (K, nt, 2); mask (K,) bool → μ (K, nt, 2)."""
    K, nt, _ = x.shape
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=x.device)
    mu = backward_steps(lambda p: eval_p1_tensor(space, grad_u, p), x,
                        u_values - u_d, vlimit, h)
    return torch.where(mask[:, None, None], 0.0, mu)
