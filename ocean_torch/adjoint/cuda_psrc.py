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

The kernel sums the limbs of each (32 consecutive points, grid square)
group over the warp before it adds them to the counters, and it sums a
41-bit limb as two 32-bit pieces. ``split20``/``join20`` and
``point_source_limbs_grouped`` are that arithmetic in plain PyTorch, so
that tests without a card can hold it to the plain version bit for bit.
Nothing on the paths calls them.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..mesh.locate import _EPS
from ..ode.grideval import GridEval, grid_coords, p2_patch_weights
from ..ops.scatter import pow2_scale

_TWO40 = 2.0 ** 40
_TWO_M40 = 2.0 ** -40
_TWO_M80 = 2.0 ** -80

# int point_sources_launch(pts, r, acc_hi, acc_lo, M, Hx, Geom, stream)
_ARGTYPES = ([kernels.VOIDP] * 4 + [kernels.LONG, kernels.INT, kernels.Geom,
                                    kernels.VOIDP])


def _patch_offsets(Hx: int, device) -> torch.Tensor:
    """Offsets of the 3×3 patch nodes from node (2·iy, 2·ix): (9,)."""
    return torch.tensor([b * Hx + a for b in range(3) for a in range(3)],
                        device=device)


def _term_limbs(ge: GridEval, points: torch.Tensor, r: torch.Tensor):
    """The fixed-point limbs of every term W·r, (M, 9, 2) int64 each, and
    the square (ix, iy) of every point."""
    ix, iy, s, t = grid_coords(ge.locator, points)
    W = p2_patch_weights(s, t, ge.locator.diagonal).reshape(-1, 9)
    y = (W[:, :, None] * r[:, None, :]) * _TWO40               # (M, 9, 2)
    qh = torch.floor(y)
    ql = torch.round((y - qh) * _TWO40)
    return qh.to(torch.int64), ql.to(torch.int64), ix, iy


def point_source_limbs_plain(ge: GridEval, points: torch.Tensor,
                             r: torch.Tensor):
    """Plain PyTorch version of the kernel: (hi, lo) int64 (Hy·Hx, 2)."""
    Hy, Hx = ge.hg_shape
    qh, ql, ix, iy = _term_limbs(ge, points, r)
    nodes = (((2 * iy) * Hx + 2 * ix)[:, None]
             + _patch_offsets(Hx, points.device))              # (M, 9)
    hi = torch.zeros(Hy * Hx, 2, dtype=torch.int64, device=points.device)
    lo = torch.zeros_like(hi)
    idx = nodes.reshape(-1)
    hi.index_add_(0, idx, qh.reshape(-1, 2))
    lo.index_add_(0, idx, ql.reshape(-1, 2))
    return hi, lo


def split20(q: torch.Tensor):
    """A limb q (int64, |q| ≤ 2^40) as two int32 pieces with
    q = a·2^20 + b exactly: a = floor(q / 2^20), 0 ≤ b < 2^20. Up to 32
    of either piece sum inside an int32."""
    return (q >> 20).to(torch.int32), (q & 0xFFFFF).to(torch.int32)


def join20(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ q from the int32 sums of its pieces: Σa·2^20 + Σb, int64."""
    return a.to(torch.int64) * (1 << 20) + b.to(torch.int64)


def point_source_limbs_grouped(ge: GridEval, points: torch.Tensor,
                               r: torch.Tensor):
    """The kernel's order of summation in plain PyTorch: the limbs of each
    (32 consecutive points, square) group are summed first, as int32
    pieces, and the group sums are added to the counters second. Points
    with r == 0 join no group. Returns (hi, lo) equal to
    ``point_source_limbs_plain``."""
    Hy, Hx = ge.hg_shape
    nx, ny = ge.locator.grid_shape
    dev = points.device
    qh, ql, ix, iy = _term_limbs(ge, points, r)
    live = (r != 0).any(dim=1)
    tile = torch.arange(points.shape[0], device=dev)[live] // kernels.WARP
    keys, group = torch.unique(tile * (nx * ny) + (iy * nx + ix)[live],
                               return_inverse=True)
    square = keys % (nx * ny)                                  # (G,)
    nodes = (((2 * (square // nx)) * Hx + 2 * (square % nx))[:, None]
             + _patch_offsets(Hx, dev))                        # (G, 9)
    out = []
    for q in (qh[live], ql[live]):
        pieces = []
        for piece in split20(q):
            total = torch.zeros(keys.numel(), 9, 2, dtype=torch.int32,
                                device=dev)
            pieces.append(total.index_add_(0, group, piece))
        acc = torch.zeros(Hy * Hx, 2, dtype=torch.int64, device=dev)
        acc.index_add_(0, nodes.reshape(-1), join20(*pieces).reshape(-1, 2))
        out.append(acc)
    return tuple(out)


def point_source_limbs(ge: GridEval, points: torch.Tensor, r: torch.Tensor):
    """Fixed-point image limbs of Σ_m r_m φ(x_m): points and r (M, 2)
    float64 with |r| ≤ 1 → (hi, lo) int64 (Hy·Hx, 2)."""
    if points.device.type == "cpu" and r.device.type == "cpu":
        return point_source_limbs_plain(ge, points, r)
    # the kernel reads double2
    points, r = (t.clone() if t.data_ptr() % 16 else t
                 for t in (points.contiguous(), r.contiguous()))
    kernels.require_cuda("point_sources", points, r,
                         *kernels.grid_tables(ge.locator))
    if points.dtype != torch.float64 or r.dtype != torch.float64:
        raise ValueError("point_sources: float64 inputs required")
    M = points.shape[0]
    if points.shape != (M, 2) or r.shape != (M, 2):
        raise ValueError("point_sources: bad shapes")
    Hy, Hx = ge.hg_shape
    fn = kernels.function("point_sources", "point_sources_launch", _ARGTYPES)
    hi = torch.zeros(Hy * Hx, 2, dtype=torch.int64, device=points.device)
    lo = torch.zeros_like(hi)
    status = fn(points.data_ptr(), r.data_ptr(), hi.data_ptr(),
                lo.data_ptr(), M, Hx, kernels.geom(ge.locator, _EPS),
                kernels.stream_ptr(points.device))
    kernels.check_launch("point_sources", status)
    kernels.LAUNCHES["point_sources"] += 1
    return hi, lo


def point_source_image(ge: GridEval, points: torch.Tensor,
                       gamma: torch.Tensor) -> torch.Tensor:
    """b_vel (n_p2, 2) = Σ_m γ_m φ(x_m) through the kernel. ``gamma``
    (M, 2) already carries the masking (escaped lanes zeroed); points are
    located clamped, as ``mesh.locate.locate_points`` does."""
    points = points.reshape(-1, 2)
    gamma = gamma.reshape(-1, 2)
    scale = pow2_scale(gamma)
    hi, lo = point_source_limbs(ge, points, gamma / scale)
    img = (hi.to(torch.float64) * _TWO_M40
           + lo.to(torch.float64) * _TWO_M80) * scale
    return img[ge.dof_to_node]
