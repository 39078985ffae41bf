"""The buoy ODEs and the adjoint point sources, in plain PyTorch.

Buoys move by explicit Euler through the P2 velocity. The reference
program's escape rule holds: a buoy whose position leaves the domain
(boundary included, with 1e-12 of slack) at step k_f freezes there;
afterwards its whole trajectory is the domain's center, it is masked,
and its recorded velocities are kept before k_f, 0 at k_f, u(center) at
k_f + 1 and 0 after. A buoy whose last position alone is outside keeps
its trajectory, with the center as last position and velocity 0 there.

The costate runs backwards, μ[nt−1] = 0,
    μ[k] = μ[k+1] − h ∇u(x[k+1])ᵀ ((u[k+1] − u_d[k+1]) − μ[k+1]),
with ∇u the P1 projection; outside the domain the last ∇u found is
used again (zeros before any). Masked buoys have μ ≡ 0 and no sources.
"""

from __future__ import annotations

import torch

from .fem import Space, p1_torch, p2_torch
from .mesh import EPS


def inside(sp: Space, x: torch.Tensor) -> torch.Tensor:
    px, py = x[..., 0], x[..., 1]
    ok = (px >= -EPS) & (px <= 2 + EPS) & (py >= -EPS) & (py <= 2 + EPS)
    if sp.mesh.domain == "lshape":
        ok = ok & ((py <= 1 + EPS) | (px >= 1 - EPS))
    return ok


def locate(sp: Space, x: torch.Tensor):
    """(cell, reference coordinates) of points (..., 2), taken clamped
    into the domain's box; on the L-shape a point of the missing block is
    moved half a square below its inner corner."""
    n, h = sp.mesh.n, sp.mesh.h
    px = torch.clamp(x[..., 0], 0.0, 2.0)
    py = torch.clamp(x[..., 1], 0.0, 2.0)
    if sp.mesh.domain == "lshape":
        py = torch.where((px < 1.0) & (py > 1.0), 1.0 - 0.5 * h, py)
    hs = torch.full((), h, dtype=x.dtype, device=x.device)
    fx, fy = px / hs, py / hs
    ix = torch.clamp(torch.floor(fx).long(), 0, n - 1)
    iy = torch.clamp(torch.floor(fy).long(), 0, n - 1)
    upper = ((fy - iy) > (fx - ix)).long()
    cell = torch.clamp(sp.s2c[iy, ix, upper], min=0)
    d = torch.stack([px, py], dim=-1) - sp.v0[cell]
    return cell, torch.einsum("...ij,...j->...i", sp.jinv[cell], d)


def eval_u(sp: Space, u: torch.Tensor, x: torch.Tensor):
    cell, xi = locate(sp, x)
    val = torch.einsum("...a,...ai->...i", p2_torch(xi), u[sp.dofs2[cell]])
    return val, inside(sp, x)


def eval_grad(sp: Space, g: torch.Tensor, x: torch.Tensor):
    cell, xi = locate(sp, x)
    val = torch.einsum("...a,...aij->...ij", p1_torch(xi), g[sp.dofs1[cell]])
    return val, inside(sp, x)


def primal(sp: Space, u: torch.Tensor, x0: torch.Tensor, h: float, nt: int,
           center: torch.Tensor):
    """(x, u_values, mask), each (K, nt, 2) or (K,)."""
    K = x0.shape[0]
    xs = x0.new_zeros(K, nt, 2)
    us = x0.new_zeros(K, nt, 2)
    xs[:, 0] = x0
    pos = x0
    failed = torch.zeros(K, dtype=torch.bool, device=x0.device)
    kfail = torch.full((K,), nt, dtype=torch.long, device=x0.device)
    for k in range(nt - 1):
        v, ok = eval_u(sp, u, pos)
        kfail = torch.where(~ok & ~failed, k, kfail)
        failed = failed | ~ok
        pos = torch.where(failed[:, None], pos, pos + h * v)
        us[:, k] = torch.where(failed[:, None], 0.0, v)
        xs[:, k + 1] = pos
    v, ok = eval_u(sp, u, xs[:, nt - 1])
    us[:, nt - 1] = torch.where(ok[:, None], v, 0.0)
    xs[:, nt - 1] = torch.where(ok[:, None], xs[:, nt - 1], center)
    u_c, _ = eval_u(sp, u, center)
    t = torch.arange(nt, device=x0.device)[None, :]
    kept = torch.where((t < kfail[:, None])[..., None], us, 0.0)
    kept = kept + torch.where((t == kfail[:, None] + 1)[..., None], u_c, 0.0)
    m = failed[:, None, None]
    return (torch.where(m, center.expand_as(xs), xs),
            torch.where(m, kept, us), failed)


def costate(sp: Space, grad_u: torch.Tensor, x: torch.Tensor,
            u_values: torch.Tensor, u_d: torch.Tensor, mask: torch.Tensor,
            h: float) -> torch.Tensor:
    K, nt, _ = x.shape
    mu = x.new_zeros(K, nt, 2)
    g_last = x.new_zeros(K, 2, 2)
    resid = u_values - u_d
    for t in range(nt - 1, 0, -1):
        g, ok = eval_grad(sp, grad_u, x[:, t])
        g_last = torch.where(ok[:, None, None], g, g_last)
        d = resid[:, t] - mu[:, t]
        mu[:, t - 1] = mu[:, t] - h * torch.einsum("kij,ki->kj", g_last, d)
    return torch.where(mask[:, None, None], 0.0, mu)


def point_sources(sp: Space, u: torch.Tensor, x: torch.Tensor,
                  mu: torch.Tensor, u_d: torch.Tensor, mask: torch.Tensor,
                  h: float, center: torch.Tensor) -> torch.Tensor:
    """b = Σ over unmasked buoys and times of γ δ(x), γ = h ((u_d − u(x))
    + μ), as a mixed vector; a point outside the domain has u(x) = 0 and
    puts its source at the center."""
    pts = x.reshape(-1, 2)
    cell, xi = locate(sp, pts)
    ok = inside(sp, pts)
    phi = p2_torch(xi)
    ux = torch.einsum("ma,mai->mi", phi, u[sp.dofs2[cell]])
    ux = torch.where(ok[:, None], ux, 0.0)
    c_cell, c_xi = locate(sp, center[None])
    cell = torch.where(ok, cell, c_cell[0])
    phi = torch.where(ok[:, None], phi, p2_torch(c_xi))
    gamma = h * ((u_d.reshape(-1, 2) - ux) + mu.reshape(-1, 2))
    active = (~mask)[:, None].expand(x.shape[0], x.shape[1]).reshape(-1)
    gamma = torch.where(active[:, None], gamma, 0.0)
    bv = u.new_zeros(sp.n_p2, 2)
    bv.index_add_(0, sp.dofs2[cell].reshape(-1),
                  (phi[:, :, None] * gamma[:, None, :]).reshape(-1, 2))
    return torch.cat([bv.reshape(-1), bv.new_zeros(sp.n_p1)])
