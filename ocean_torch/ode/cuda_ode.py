"""Primal buoy ODE through the CUDA kernel ``csrc/primal_ode.cu`` (the
port of ``ocean_jax/ode/pallas_ode.py``).

The kernel runs steps 0..nt−2 of every buoy on the half-grid velocity
image; the final evaluation, the recentring and the escaped-buoy
overwrite run afterwards in plain float64 PyTorch
(``ode.primal.finish_trajectories``), the host/kernel split of
``solve_primal_ode_pallas``.

``primal_ode_steps`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs ``primal_ode_steps_plain``,
the same arithmetic in PyTorch.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..mesh.locate import _EPS
from .grideval import GridEval, velocity_to_grid, eval_velocity_grid
from .primal import PrimalODEResult, euler_steps, finish_trajectories

# int primal_ode_launch(u_img, x0, xs, us, failed, kfail, K, nt, Hx, Geom,
#                       h, stream)
_ARGTYPES = ([kernels.VOIDP] * 6 + [kernels.INT] * 3
             + [kernels.Geom, kernels.DOUBLE, kernels.VOIDP])


def primal_ode_steps_plain(ge: GridEval, u_img: torch.Tensor,
                           x0: torch.Tensor, h: float, nt: int):
    """Plain PyTorch version of the kernel: (x, u_rec, failed, kfail)."""
    return euler_steps(lambda p: eval_velocity_grid(ge, u_img, p), x0, h,
                       nt)


def primal_ode_steps(ge: GridEval, u_img: torch.Tensor, x0: torch.Tensor,
                     h: float, nt: int):
    """Steps 0..nt−2 of every buoy: u_img (Hy·Hx, 2), x0 (K, 2) float64 →
    (x (K, nt, 2), u_rec (K, nt, 2), failed (K,) bool, kfail (K,) int32)."""
    if u_img.device.type == "cpu" and x0.device.type == "cpu":
        return primal_ode_steps_plain(ge, u_img, x0, h, nt)
    u_img = u_img.contiguous()
    x0 = x0.contiguous()
    kernels.require_cuda("primal_ode", u_img, x0)
    if u_img.dtype != torch.float64 or x0.dtype != torch.float64:
        raise ValueError("primal_ode: float64 inputs required")
    Hy, Hx = ge.hg_shape
    K = x0.shape[0]
    if u_img.shape != (Hy * Hx, 2) or x0.shape != (K, 2) or nt < 2:
        raise ValueError("primal_ode: bad shapes")
    fn = kernels.function("primal_ode", "primal_ode_launch", _ARGTYPES)
    xs = torch.empty(K, nt, 2, dtype=torch.float64, device=x0.device)
    us = torch.empty_like(xs)
    failed = torch.empty(K, dtype=torch.int32, device=x0.device)
    kfail = torch.empty(K, dtype=torch.int32, device=x0.device)
    status = fn(u_img.data_ptr(), x0.data_ptr(), xs.data_ptr(),
                us.data_ptr(), failed.data_ptr(), kfail.data_ptr(), K, nt,
                Hx, kernels.geom(ge.locator, _EPS), h,
                kernels.stream_ptr(x0.device))
    kernels.check_launch("primal_ode", status)
    kernels.LAUNCHES["primal_ode"] += 1
    return xs, us, failed > 0, kfail


def solve_primal_ode_cuda(ge: GridEval, u: torch.Tensor, x0: torch.Tensor,
                          h: float, nt: int, center: torch.Tensor
                          ) -> PrimalODEResult:
    """Drop-in for ``ode.primal.solve_primal_ode`` through the kernel
    (same escape semantics; trajectories within ~1e-12 of the table
    path)."""
    u_img = velocity_to_grid(ge, u)
    x, us, failed, kfail = primal_ode_steps(ge, u_img, x0, float(h), int(nt))
    eval_u = lambda pts: eval_velocity_grid(ge, u_img, pts)
    return finish_trajectories(ge.locator, eval_u, x, us, failed, kfail,
                               center)
