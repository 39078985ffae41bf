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

Two things the kernel does otherwise than the plain version have plain
mirrors here, held to it by the CPU tests: it sums the six nodes of the
owning triangle instead of the nine of the patch
(``eval_velocity_six_nodes``), and a warp keeps ``STEPS`` steps of its 32
buoys in shared memory and writes them out with time along the lanes
(``staged_store_index``).
"""

from __future__ import annotations

import torch

import numpy as np

from .. import kernels
from ..mesh.locate import _EPS, in_domain
from .grideval import (GridEval, velocity_to_grid, eval_velocity_grid,
                       grid_coords, upper_triangle)
from .primal import PrimalODEResult, euler_steps, finish_trajectories

# int primal_ode_launch(u_img, x0, xs, us, failed, kfail, K, nt, Hx, Geom,
#                       h, stream)
_ARGTYPES = ([kernels.VOIDP] * 6 + [kernels.INT] * 3
             + [kernels.Geom, kernels.DOUBLE, kernels.VOIDP])


# csrc/primal_ode.cu: steps a warp stages in shared memory before it
# writes them out (kSteps), buoys of a block (kThreads), and the shared
# memory a block may ask for on the card (kSharedLimit)
STEPS = 16
THREADS = 96
SHARED_LIMIT = 227 * 1024


def shared_bytes(ge: GridEval) -> int:
    """Dynamic shared memory of a block, by the size rule of
    ``primal_ode_launch``: the staging rows (x and u of ``THREADS`` buoys,
    ``STEPS`` steps, odd row stride), a graded grid's lines (8 B each)
    and, where it fits beside them, the half-grid velocity image (16 B a
    node)."""
    Hy, Hx = ge.hg_shape
    stage = (THREADS // 32) * 2 * 32 * (STEPS | 1) * 16
    if not ge.locator.uniform:
        stage += 8 * ((Hx + 1) // 2 + (Hy + 1) // 2)
    with_image = stage + Hy * Hx * 16
    return with_image if with_image <= SHARED_LIMIT else stage


def eval_velocity_six_nodes(ge: GridEval, u_img: torch.Tensor,
                            points: torch.Tensor):
    """The kernel's patch sum in plain PyTorch. Three of the nine patch
    weights are structurally zero (the nodes outside the owning triangle),
    so the kernel sums the other six, in the same row-major order: the
    dropped terms are ±0 and change no value (a zero may change its sign).
    With the barycentrics (l0, l1, l2) below and above the diagonal
    ("right": (1−s, s−t, t) and (1−t, t−s, s); "left": (1−s−t, s, t) and
    (1−t, 1−s, s+t−1)), the six weights are the same expressions in both
    triangles and only two of them trade places; 4·l is exact, so
    (4·l1)·l2 and (4·l2)·l1 are one rounding of one product."""
    loc = ge.locator
    inside = in_domain(loc, points)
    ix, iy, s, t = grid_coords(loc, points)
    up = upper_triangle(s, t, loc.diagonal)
    Hx = ge.hg_shape[1]
    if loc.diagonal == "right":
        l0 = torch.where(up, 1.0 - t, 1.0 - s)
        l1 = torch.where(up, t - s, s - t)
        l2 = torch.where(up, s, t)
        lower = (0, 1, 2, Hx + 1, Hx + 2, 2 * Hx + 2)
        upper = (0, Hx, Hx + 1, 2 * Hx, 2 * Hx + 1, 2 * Hx + 2)
    else:
        l0 = torch.where(up, 1.0 - t, 1.0 - s - t)
        l1 = torch.where(up, 1.0 - s, s)
        l2 = torch.where(up, s + t - 1.0, t)
        lower = (0, 1, 2, Hx, Hx + 1, 2 * Hx)
        upper = (2, Hx + 1, Hx + 2, 2 * Hx, 2 * Hx + 1, 2 * Hx + 2)
    v0, v1, v2 = (l * (2.0 * l - 1.0) for l in (l0, l1, l2))
    e01, e02, e12 = 4.0 * l0 * l1, 4.0 * l0 * l2, 4.0 * l1 * l2
    w = (v0, e01, torch.where(up, e02, v1), torch.where(up, v1, e02), e12,
         v2)
    base = (2 * iy) * Hx + 2 * ix
    acc = None
    for wi, lo, hi in zip(w, lower, upper):
        term = wi[..., None] * u_img[base + torch.where(up, hi, lo)]
        acc = term if acc is None else acc + term
    return acc, inside


def staged_store_index(K: int, nt: int, steps: int = STEPS):
    """Where the kernel's staged stores go, as index arithmetic: two
    (n, 2) int arrays of the (buoy, time) pairs written to x and to u_rec
    by the flushes of all warps (the prologue's x[:, 0] and u_rec[:, nt−1]
    not included), in the kernel's order: warp (32 consecutive buoys),
    chunk of ``steps`` steps, store instruction, lane. A store instruction writes ``steps``
    consecutive times of 32 // steps buoys."""
    lane = np.arange(32)
    j, sub = lane % steps, lane // steps
    xs, us = [], []
    for k0 in range(0, K, 32):               # first buoy of a warp
        for c0 in range(0, nt - 1, steps):
            cn = min(steps, nt - 1 - c0)
            for b0 in range(0, 32, 32 // steps):
                kb = k0 + b0 + sub
                live = (kb < K) & (j < cn)
                us.append(np.stack([kb, c0 + j], 1)[live])
                xs.append(np.stack([kb, c0 + j + 1], 1)[live])
    return np.concatenate(xs), np.concatenate(us)


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
    kernels.require_cuda("primal_ode", u_img, x0,
                         *kernels.grid_tables(ge.locator))
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
