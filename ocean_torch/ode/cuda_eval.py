"""P1 tensor (∇u) point evaluation through the CUDA kernel
``csrc/p1_eval.cu`` (the port of ``ocean_jax/ode/pallas_eval.py``).

``eval_p1_tensor_cuda`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs the plain version,
``grideval.eval_p1_tensor_grid``, on the same vertex-grid image.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..mesh.locate import _EPS
from .grideval import GridEval, eval_p1_tensor_grid

# int p1_eval_launch(g_img, pts, vals, inside, N, Gx, Geom, stream)
_ARGTYPES = ([kernels.VOIDP] * 4 + [kernels.LONG, kernels.INT, kernels.Geom,
                                    kernels.VOIDP])


def eval_p1_tensor_cuda(ge: GridEval, g_grid: torch.Tensor,
                        points: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``grideval.eval_p1_tensor_grid``: g_grid
    ((ny+1)·(nx+1), 2, 2) from ``grad_to_grid``; points (..., 2) →
    (values (..., 2, 2), inside (...,))."""
    if g_grid.device.type == "cpu" and points.device.type == "cpu":
        return eval_p1_tensor_grid(ge, g_grid, points)
    shape = points.shape[:-1]
    pts = points.reshape(-1, 2).contiguous()
    if pts.data_ptr() % 16:                # the kernel reads double2
        pts = pts.clone()
    g_grid = g_grid.contiguous()
    kernels.require_cuda("p1_eval", g_grid, pts,
                         *kernels.grid_tables(ge.locator))
    if g_grid.dtype != torch.float64 or pts.dtype != torch.float64:
        raise ValueError("p1_eval: float64 inputs required")
    Gy, Gx = ge.vg_shape
    if g_grid.shape != (Gy * Gx, 2, 2):
        raise ValueError("p1_eval: bad image shape")
    N = pts.shape[0]
    fn = kernels.function("p1_eval", "p1_eval_launch", _ARGTYPES)
    vals = torch.empty(N, 2, 2, dtype=torch.float64, device=pts.device)
    inside = torch.empty(N, dtype=torch.bool, device=pts.device)
    status = fn(g_grid.data_ptr(), pts.data_ptr(), vals.data_ptr(),
                inside.data_ptr(), N, Gx, kernels.geom(ge.locator, _EPS),
                kernels.stream_ptr(pts.device))
    kernels.check_launch("p1_eval", status)
    kernels.LAUNCHES["p1_eval"] += 1
    return vals.reshape(shape + (2, 2)), inside.reshape(shape)
