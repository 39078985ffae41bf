"""Adjoint buoy ODE: backward recursion for the costate μ (port of
``ocean_jax/ode/adjoint.py``: the explicit recursion, its consistent
mode and the implicit variant of the NS+ODE gradient check).

    μ[nt-1] = 0
    μ[k] = μ[k+1] − h ∇u(x[k+1])ᵀ ((u(x[k+1]) − u_d[k+1]) − μ[k+1])

∇u is the P1-projected gradient evaluated at the trajectory points; at an
out-of-domain point the previous ∇u is reused (the reference's
leftover-variable quirk, starting from zeros). Masked (escaped) buoys get
μ ≡ 0. Two forms, equal to rounding:

* ``method="parallel"`` (the default, as in the JAX package): all K·nt ∇u
  evaluations at once, then the recursion as a log-depth prefix scan of
  affine maps over time;
* ``method="scan"``: a host loop over time, vectorized over buoys.

``solve_adjoint_ode_implicit`` is the implicit recursion of the coupled
gradient check, (I + h ∇uᵀ) μ[k] = μ[k+1] − h ∇uᵀ (u(x[k+1]) − u_d[k]).
"""

from __future__ import annotations

import torch

from ..fem.spaces import TaylorHoodSpace
from ..fem.interpolate import eval_p1_tensor, eval_velocity
from .cuda_eval import eval_p1_tensor_cuda
from .grideval import grad_to_grid


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
                      u_d: torch.Tensor, mask: torch.Tensor, h: float,
                      method: str = "parallel", grid=None) -> torch.Tensor:
    """Reference-mode μ. grad_u: (n_p1, 2, 2); x, u_values, u_d:
    (K, nt, 2); mask (K,) bool → μ (K, nt, 2).

    ``grid`` (a ``GridEval``, parallel form only): the K·nt ∇u
    evaluations go through the CUDA kernel ``csrc/p1_eval.cu`` (its plain
    version on CPU tensors) instead of the cell tables."""
    if method == "parallel":
        return _adjoint_ode_parallel(space, grad_u, x, u_values, u_d, mask,
                                     h, grid=grid)
    if method != "scan":
        raise ValueError(f"unknown adjoint ODE method {method!r}")
    K, nt, _ = x.shape
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=x.device)
    mu = backward_steps(lambda p: eval_p1_tensor(space, grad_u, p), x,
                        u_values - u_d, vlimit, h)
    return torch.where(mask[:, None, None], 0.0, mu)


def solve_adjoint_ode_consistent(space: TaylorHoodSpace,
                                 grad_u: torch.Tensor, x_raw: torch.Tensor,
                                 u_values: torch.Tensor, u_d: torch.Tensor,
                                 mask: torch.Tensor, kfail: torch.Tensor,
                                 h: float, grid=None) -> torch.Tensor:
    """Consistent-mode μ: an escaped buoy keeps its pre-escape adjoint
    contributions. The recursion runs on the raw (pre-overwrite)
    trajectory over each escaped buoy's window t ≤ kfail−1 and is zero
    beyond it; unmasked buoys are unchanged."""
    nt = x_raw.shape[1]
    t = torch.arange(nt, device=x_raw.device)[None, :]
    valid = (~mask[:, None]) | (t <= (kfail[:, None].to(torch.int64) - 1))
    return _adjoint_ode_parallel(space, grad_u, x_raw, u_values, u_d,
                                 torch.zeros_like(mask), h, valid=valid,
                                 grid=grid)


def _next_valid_fill(g_all: torch.Tensor, inside: torch.Tensor):
    """∇u at the smallest in-domain time ≥ t, for every (buoy, t): the
    reuse-previous quirk of the backward recursion. A reverse running
    minimum of the next in-domain time index, then a gather, so each
    entry is an element of ``g_all`` (or 0 where none follows)."""
    K, nt = inside.shape
    t = torch.arange(nt, device=inside.device).expand(K, nt)
    nxt = torch.where(inside, t, nt)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    has_valid = nxt < nt
    idx = torch.clamp(nxt, max=nt - 1)[..., None, None].expand(K, nt, 2, 2)
    g = torch.gather(g_all, 1, idx)
    return torch.where(has_valid[..., None, None], g, 0.0)


def _affine_prefix(a11, a12, a21, a22, b1, b2):
    """Inclusive prefix composition over dim 0 of affine maps
    μ ↦ A_j μ + b_j, applied in order j = 0, 1, ...: log-depth doubling
    (Hillis–Steele). Returns the composed b planes, i.e. the image of 0."""
    n = a11.shape[0]
    off = 1
    while off < n:
        la11, la12, la21, la22, lb1, lb2 = (p[:-off] for p in
                                            (a11, a12, a21, a22, b1, b2))
        ra11, ra12, ra21, ra22, rb1, rb2 = (p[off:] for p in
                                            (a11, a12, a21, a22, b1, b2))
        # A = A_r @ A_l ; b = A_r @ b_l + b_r, as the JAX package combines
        c = (ra11 * la11 + ra12 * la21,
             ra11 * la12 + ra12 * la22,
             ra21 * la11 + ra22 * la21,
             ra21 * la12 + ra22 * la22,
             ra11 * lb1 + ra12 * lb2 + rb1,
             ra21 * lb1 + ra22 * lb2 + rb2)
        a11, a12, a21, a22, b1, b2 = (torch.cat([p[:off], q]) for p, q in
                                      zip((a11, a12, a21, a22, b1, b2), c))
        off *= 2
    return b1, b2


def _adjoint_ode_parallel(space: TaylorHoodSpace, grad_u: torch.Tensor,
                          x: torch.Tensor, u_values: torch.Tensor,
                          u_d: torch.Tensor, mask: torch.Tensor, h: float,
                          valid: torch.Tensor = None,
                          grid=None) -> torch.Tensor:
    """Parallel-prefix form of the backward μ recursion:

        μ[k] = A_k μ[k+1] + b_k,  A_k = I + h ∇u(x[k+1])ᵀ,
                                  b_k = −h ∇u(x[k+1])ᵀ (u[k+1] − u_d[k+1]).

    ``valid`` (K, nt) bool: outside it a step is the identity map
    (consistent mode)."""
    K, nt, _ = x.shape
    if grid is not None:
        g_all, inside = eval_p1_tensor_cuda(grid, grad_to_grid(grid, grad_u),
                                            x)
    else:
        g_all, inside = eval_p1_tensor(space, grad_u, x)   # (K, nt, 2, 2)
    g = _next_valid_fill(g_all, inside)

    # steps k = nt-2 .. 0 use time t = k+1; gt_ij = (∇u)ᵀ_ij = g_ji.
    # Planes are (nt-1, K) in reversed time: the scan runs over dim 0.
    def plane(a):
        a = a[:, 1:]
        if valid is not None:
            a = torch.where(valid[:, 1:], a, 0.0)
        return torch.flip(a, [1]).T.contiguous()

    gt00, gt01 = plane(g[..., 0, 0]), plane(g[..., 1, 0])
    gt10, gt11 = plane(g[..., 0, 1]), plane(g[..., 1, 1])
    r1 = plane(u_values[..., 0] - u_d[..., 0])
    r2 = plane(u_values[..., 1] - u_d[..., 1])
    b1, b2 = _affine_prefix(1.0 + h * gt00, h * gt01, h * gt10,
                            1.0 + h * gt11,
                            -h * (gt00 * r1 + gt01 * r2),
                            -h * (gt10 * r1 + gt11 * r2))
    mu = torch.stack([torch.flip(b1.T, [1]), torch.flip(b2.T, [1])], dim=-1)
    mu = torch.cat([mu, mu.new_zeros(K, 1, 2)], dim=1)
    return torch.where(mask[:, None, None], 0.0, mu)


def solve_adjoint_ode_implicit(space: TaylorHoodSpace, grad_u: torch.Tensor,
                               u: torch.Tensor, x: torch.Tensor,
                               u_d: torch.Tensor, h: float,
                               ud_index: str = "k") -> torch.Tensor:
    """Implicit backward recursion of the coupled NS+ODE gradient check:
    (I + h ∇uᵀ) μ[k] = μ[k+1] − h ∇uᵀ (u(x[k+1]) − u_d[idx]), the 2×2
    system solved in closed form. ``ud_index``: "k" reproduces the
    reference's u_d[k]; "k+1" is the consistent variant. The inside flag
    is ignored (clamped evaluation), as in the JAX package.

    u: (n_p2, 2) velocity; x, u_d: (K, nt, 2) → μ (K, nt, 2)."""
    K, nt, _ = x.shape
    shift = {"k": 0, "k+1": 1}[ud_index]
    # ∇u and u at all K·(nt−1) points x[:, 1:] at once
    g_all, _ = eval_p1_tensor(space, grad_u, x[:, 1:])    # (K, nt-1, 2, 2)
    uv_all, _ = eval_velocity(space, u, x[:, 1:])         # (K, nt-1, 2)
    mu = x.new_zeros(K, nt, 2)
    mu0 = x.new_zeros(K)
    mu1 = x.new_zeros(K)
    for k in range(nt - 2, -1, -1):
        g = g_all[:, k]
        r = uv_all[:, k] - u_d[:, k + shift]
        # a = I + h gᵀ; b = μ[k+1] − (h gᵀ) r, in the JAX order
        a00, a01 = 1.0 + h * g[:, 0, 0], h * g[:, 1, 0]
        a10, a11 = h * g[:, 0, 1], 1.0 + h * g[:, 1, 1]
        b0 = mu0 - (h * g[:, 0, 0] * r[:, 0] + h * g[:, 1, 0] * r[:, 1])
        b1 = mu1 - (h * g[:, 0, 1] * r[:, 0] + h * g[:, 1, 1] * r[:, 1])
        det = a00 * a11 - a01 * a10
        mu0, mu1 = ((a11 / det) * b0 + (-a01 / det) * b1,
                    (-a10 / det) * b0 + (a00 / det) * b1)
        mu[:, k, 0] = mu0
        mu[:, k, 1] = mu1
    return mu
