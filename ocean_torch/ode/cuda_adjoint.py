"""Adjoint buoy ODE through the CUDA kernel ``csrc/adjoint_ode.cu`` (the
port of ``ocean_jax/ode/pallas_adjoint.py``).

``adjoint_ode_steps`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs ``adjoint_ode_steps_plain``,
the same recursion in PyTorch on the same vertex-grid image. Masking μ to
0 for escaped buoys happens outside the kernel, as in the JAX package.

The kernel does not walk the recursion point by point: a block takes
``TILE`` buoys and ``CHUNK`` time steps at a time, evaluates ∇u and the
inside flag at all of the chunk's points first (they depend on x alone),
and only then runs the carry and the μ update over the stored values.
``adjoint_ode_steps_staged`` is that schedule in plain PyTorch, held to
``adjoint_ode_steps_plain`` bit for bit by the CPU tests.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..mesh.locate import _EPS
from .adjoint import backward_steps
from .grideval import GridEval, grad_to_grid, eval_p1_tensor_grid

# int adjoint_ode_launch(g_img, x, resid, vlimit, mu, K, nt, Gx, Geom, h,
#                        stream)
_ARGTYPES = ([kernels.VOIDP] * 5 + [kernels.INT] * 3
             + [kernels.Geom, kernels.DOUBLE, kernels.VOIDP])


# buoys of a block and time steps of a chunk in csrc/adjoint_ode.cu
# (kTile, kChunk there)
TILE = 8
CHUNK = 16


def adjoint_ode_steps_plain(ge: GridEval, g_img: torch.Tensor,
                            x: torch.Tensor, resid: torch.Tensor,
                            vlimit: torch.Tensor, h: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return backward_steps(lambda p: eval_p1_tensor_grid(ge, g_img, p), x,
                          resid, vlimit, h)


def adjoint_ode_steps_staged(ge: GridEval, g_img: torch.Tensor,
                             x: torch.Tensor, resid: torch.Tensor,
                             vlimit: torch.Tensor, h: float,
                             tile: int = TILE, chunk: int = CHUNK
                             ) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: tile by tile of buoys and,
    from the last time step down, chunk by chunk, first ∇u and the inside
    flag of every point of the chunk (gather phase), then the carry of the
    last in-domain ∇u, the window and the μ update from the stored values
    (chain phase). μ[t−1] overwrites the residual of t in place and the
    chunk is written out shifted by one, as the kernel does."""
    K, nt, _ = x.shape
    mu = x.new_zeros(K, nt, 2)
    for k0 in range(0, K, tile):
        rows = slice(k0, min(k0 + tile, K))
        nb = rows.stop - k0
        mu1, mu2 = x.new_zeros(nb), x.new_zeros(nb)
        gc = x.new_zeros(nb, 2, 2)
        vl = vlimit[rows]
        for t_hi in range(nt - 1, 0, -chunk):
            t_lo = max(1, t_hi - chunk + 1)
            g_all, inside = eval_p1_tensor_grid(ge, g_img,
                                                x[rows, t_lo:t_hi + 1])
            slot = resid[rows, t_lo:t_hi + 1].clone()
            for t in range(t_hi, t_lo - 1, -1):
                j = t - t_lo
                gc = torch.where(inside[:, j, None, None], g_all[:, j], gc)
                gu = torch.where((t <= vl)[:, None, None], gc, 0.0)
                d1 = slot[:, j, 0] - mu1
                d2 = slot[:, j, 1] - mu2
                mu1, mu2 = (mu1 - h * (gu[:, 0, 0] * d1 + gu[:, 1, 0] * d2),
                            mu2 - h * (gu[:, 0, 1] * d1 + gu[:, 1, 1] * d2))
                slot[:, j, 0] = mu1
                slot[:, j, 1] = mu2
            mu[rows, t_lo - 1:t_hi] = slot
    return mu


def adjoint_ode_steps(ge: GridEval, g_img: torch.Tensor, x: torch.Tensor,
                      resid: torch.Tensor, vlimit: torch.Tensor,
                      h: float) -> torch.Tensor:
    """μ (K, nt, 2) from the ∇u vertex image g_img ((ny+1)·(nx+1), 2, 2),
    positions x and residuals u − u_d (K, nt, 2), and the window vlimit
    (K,) int32 (nt = unrestricted)."""
    if all(t.device.type == "cpu" for t in (g_img, x, resid, vlimit)):
        return adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit, h)
    g_img, x, resid = (t.contiguous() for t in (g_img, x, resid))
    vlimit = vlimit.to(torch.int32).contiguous()
    kernels.require_cuda("adjoint_ode", g_img, x, resid, vlimit,
                         *kernels.grid_tables(ge.locator))
    if any(t.dtype != torch.float64 for t in (g_img, x, resid)):
        raise ValueError("adjoint_ode: float64 inputs required")
    Gy, Gx = ge.vg_shape
    K, nt, _ = x.shape
    if (g_img.shape != (Gy * Gx, 2, 2) or resid.shape != x.shape
            or vlimit.shape != (K,) or nt < 2):
        raise ValueError("adjoint_ode: bad shapes")
    fn = kernels.function("adjoint_ode", "adjoint_ode_launch", _ARGTYPES)
    mu = torch.empty_like(x)
    status = fn(g_img.data_ptr(), x.data_ptr(), resid.data_ptr(),
                vlimit.data_ptr(), mu.data_ptr(), K, nt, Gx,
                kernels.geom(ge.locator, _EPS), h,
                kernels.stream_ptr(x.device))
    kernels.check_launch("adjoint_ode", status)
    kernels.LAUNCHES["adjoint_ode"] += 1
    return mu


def solve_adjoint_ode_cuda(ge: GridEval, grad_u: torch.Tensor,
                           x: torch.Tensor, u_values: torch.Tensor,
                           u_d: torch.Tensor, mask: torch.Tensor, h: float,
                           vlimit: torch.Tensor = None) -> torch.Tensor:
    """Drop-in for ``ode.adjoint.solve_adjoint_ode`` through the kernel.
    ``vlimit`` (K,): valid window t ≤ vlimit; None = unrestricted."""
    K, nt, _ = x.shape
    if vlimit is None:
        vlimit = torch.full((K,), nt, dtype=torch.int32, device=x.device)
    mu = adjoint_ode_steps(ge, grad_to_grid(ge, grad_u), x, u_values - u_d,
                           vlimit, float(h))
    return torch.where(mask[:, None, None], 0.0, mu)
