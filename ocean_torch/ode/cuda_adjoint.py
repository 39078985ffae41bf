"""Adjoint buoy ODE through the CUDA kernel ``csrc/adjoint_ode.cu`` (the
port of ``ocean_jax/ode/pallas_adjoint.py``).

``adjoint_ode_steps`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs ``adjoint_ode_steps_plain``,
the same recursion in PyTorch on the same vertex-grid image. Masking μ to
0 for escaped buoys happens outside the kernel, as in the JAX package.
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


def adjoint_ode_steps_plain(ge: GridEval, g_img: torch.Tensor,
                            x: torch.Tensor, resid: torch.Tensor,
                            vlimit: torch.Tensor, h: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return backward_steps(lambda p: eval_p1_tensor_grid(ge, g_img, p), x,
                          resid, vlimit, h)


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
    kernels.require_cuda("adjoint_ode", g_img, x, resid, vlimit)
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
