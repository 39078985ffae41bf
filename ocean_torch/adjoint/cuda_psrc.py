"""Fused point sources through the CUDA kernel ``csrc/point_sources.cu``
(the port of ``ocean_jax/adjoint/pallas_psrc.py``).

b_vel (n_p2, 2) = Σ_m γ_m φ(x_m): γ is divided by a per-component power
of two ``scale`` (exact, |γ/scale| ≤ 1), each point's P2 patch
contributions are accumulated as two fixed-point int64 limbs per image
entry (integer sums: bit-reproducible in any order), and the image is
converted back to float64 and gathered onto the P2 dofs. The kernel
source note states the error bound.

``point_source_limbs`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs ``point_source_limbs_plain``,
the same fixed-point arithmetic with integer ``index_add_``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..mesh.locate import _EPS
from ..ode.grideval import GridEval, grid_coords, p2_patch_weights

_TWO40 = 2.0 ** 40
_TWO_M40 = 2.0 ** -40
_TWO_M80 = 2.0 ** -80

# int point_sources_launch(pts, r, acc_hi, acc_lo, M, Hx, Geom, stream)
_ARGTYPES = ([kernels.VOIDP] * 4 + [kernels.LONG, kernels.INT, kernels.Geom,
                                    kernels.VOIDP])


def point_source_limbs_plain(ge: GridEval, points: torch.Tensor,
                             r: torch.Tensor):
    """Plain PyTorch version of the kernel: (hi, lo) int64 (Hy·Hx, 2)."""
    Hy, Hx = ge.hg_shape
    M = points.shape[0]
    ix, iy, s, t = grid_coords(ge.locator, points)
    W = p2_patch_weights(s, t, ge.locator.diagonal).reshape(M, 9)
    offs = torch.tensor([b * Hx + a for b in range(3) for a in range(3)],
                        device=points.device)
    nodes = ((2 * iy) * Hx + 2 * ix)[:, None] + offs           # (M, 9)
    y = (W[:, :, None] * r[:, None, :]) * _TWO40               # (M, 9, 2)
    qh = torch.floor(y)
    ql = torch.round((y - qh) * _TWO40)
    hi = torch.zeros(Hy * Hx, 2, dtype=torch.int64, device=points.device)
    lo = torch.zeros_like(hi)
    idx = nodes.reshape(-1)
    hi.index_add_(0, idx, qh.reshape(-1, 2).to(torch.int64))
    lo.index_add_(0, idx, ql.reshape(-1, 2).to(torch.int64))
    return hi, lo


def point_source_limbs(ge: GridEval, points: torch.Tensor, r: torch.Tensor):
    """Fixed-point image limbs of Σ_m r_m φ(x_m): points and r (M, 2)
    float64 with |r| ≤ 1 → (hi, lo) int64 (Hy·Hx, 2)."""
    if points.device.type == "cpu" and r.device.type == "cpu":
        return point_source_limbs_plain(ge, points, r)
    points, r = points.contiguous(), r.contiguous()
    kernels.require_cuda("point_sources", points, r)
    if points.dtype != torch.float64 or r.dtype != torch.float64:
        raise ValueError("point_sources: float64 inputs required")
    M = points.shape[0]
    if points.shape != (M, 2) or r.shape != (M, 2):
        raise ValueError("point_sources: bad shapes")
    Hy, Hx = ge.hg_shape
    fn = kernels.function("point_sources", "point_sources_launch",
                          _ARGTYPES)
    hi = torch.zeros(Hy * Hx, 2, dtype=torch.int64, device=points.device)
    lo = torch.zeros_like(hi)
    status = fn(points.data_ptr(), r.data_ptr(), hi.data_ptr(),
                lo.data_ptr(), M, Hx, kernels.geom(ge.locator, _EPS),
                kernels.stream_ptr(points.device))
    kernels.check_launch("point_sources", status)
    kernels.LAUNCHES["point_sources"] += 1
    return hi, lo


def gamma_scale(gamma: torch.Tensor) -> torch.Tensor:
    """Per-component power of two ≥ max|γ| (1 where γ ≡ 0)."""
    maxabs = gamma.abs().amax(dim=0)
    return torch.exp2(torch.ceil(torch.log2(
        torch.where(maxabs > 0, maxabs, torch.ones_like(maxabs)))))


def point_source_image(ge: GridEval, points: torch.Tensor,
                       gamma: torch.Tensor) -> torch.Tensor:
    """b_vel (n_p2, 2) = Σ_m γ_m φ(x_m) through the kernel. ``gamma``
    (M, 2) already carries the masking (escaped lanes zeroed); points are
    located clamped, as ``mesh.locate.locate_points`` does."""
    points = points.reshape(-1, 2)
    gamma = gamma.reshape(-1, 2)
    scale = gamma_scale(gamma)
    hi, lo = point_source_limbs(ge, points, gamma / scale)
    img = (hi.to(torch.float64) * _TWO_M40
           + lo.to(torch.float64) * _TWO_M80) * scale
    return img[ge.dof_to_node]
