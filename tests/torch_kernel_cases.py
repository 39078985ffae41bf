"""Hard inputs for the two scatter kernels (point sources, Ozaki segment
sum) and the two ODE kernels (primal, adjoint), made from fixed numpy
seeds: what is hard for the warp grouping and the integer splits, and
for the buoy tiles, time chunks, escape tests and point location of the
ODE kernels. The CPU tests run them through the plain arithmetic mirrors,
the card-only tests and ``chip_smoke.py`` through the kernels; each is
held to the plain version with ``torch.equal``.

Every case is small (M ≤ 4,096 points, K ≤ 77 buoys). Tensors are made on
the CPU; the caller moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from ocean_torch.ops.scatter import pow2_scale

PSRC_CASES = ("random", "trajectories", "one_square", "square_per_lane",
              "nodes_and_diagonal", "negative_and_zero_r", "all_zero_r",
              "M=1", "M=31", "M=33", "M=513")

SEG_CASES = ("random", "runs", "one_segment", "segment_per_lane",
             "dropped_ids", "plus_minus_scale", "zero_column", "ties",
             "M=0", "M=1", "M=31", "M=33", "M=513", "D=1", "D=5")

# K around a warp and off every buoy tile; nt = 2 and off every time
# chunk; buoys that leave at step 0, at the last step nt−2, only at the
# final evaluation, or never; starts within and beyond the 1e-12 slack of
# each edge and corner; starts on grid lines and on the diagonal t == s
# (a flow along the diagonal keeps them there); a spacing that is no
# power of two (nx=12 on [0, 2]: the kernels divide) and a half-grid
# image of 266 KB (nx=64)
PRIMAL_CASES = ("K=1", "K=31", "K=33", "K=77", "nt=2", "nt=37",
                "leave_step_0", "leave_step_nt-2", "leave_last_eval",
                "leave_never", "edge_slack", "grid_lines_and_diagonal",
                "nx=12", "nx=64")

# the same K and nt edges (nt−1 = one chunk of 16, one more, ragged);
# trajectories that are outside in stretches (the carry of the last
# in-domain ∇u, across chunk borders too), outside at the late times only
# (the carry starts from zeros), outside throughout (μ stays 0); every
# window vlimit
ADJOINT_CASES = ("K=1", "K=31", "K=33", "K=77", "nt=2", "nt=17", "nt=18",
                 "nt=137", "outside_stretches", "outside_late",
                 "outside_throughout", "edge_slack",
                 "grid_lines_and_diagonal", "vlimit=0", "vlimit=1",
                 "vlimit=nt-1", "vlimit=nt", "vlimit_mixed", "nx=12",
                 "nx=64")

_SLACK = 1e-12                     # mesh/locate.py::_EPS


def point_source_case(case: str, nx: int, length: float = 2.0):
    """(points, r) of one case of ``PSRC_CASES`` on the nx × nx grid of
    the square [0, length]², (M, 2) float64 each, |r| ≤ 1. Points may lie
    outside the square (the kernel clamps)."""
    h = length / nx
    rng = np.random.default_rng(11)
    M = 1000
    pts = rng.uniform(-0.05 * length, 1.05 * length, (M, 2))
    r = rng.uniform(-1.0, 1.0, (M, 2))
    if case == "random":
        r[::7] = 0.0
    elif case == "trajectories":           # buoy-major, short steps
        M = 4096
        x0 = rng.uniform(0.1 * length, 0.9 * length, (32, 1, 2))
        steps = 0.005 * np.arange(128)[None, :, None] * rng.uniform(
            -1.0, 1.0, (32, 1, 2))
        pts = (x0 + steps).reshape(M, 2)
        r = rng.uniform(-1.0, 1.0, (M, 2))
    elif case == "one_square":
        pts = rng.uniform(3 * h, 4 * h, (M, 2))
    elif case == "square_per_lane":         # 32 lanes, 32 squares
        lane = np.arange(M) % 32
        pts = np.stack([(lane % nx + 0.3) * h, (lane // nx + 0.6) * h], 1)
    elif case == "nodes_and_diagonal":
        half = 0.5 * h * rng.integers(0, 2 * nx + 1, (M, 2))
        diag = np.repeat(rng.uniform(0.0, length, (M, 1)), 2, axis=1)
        pts = np.where((np.arange(M) % 2 == 0)[:, None], half, diag)
    elif case == "negative_and_zero_r":
        r = -np.abs(r)
        r[::3] = 0.0
        r[1::3, 0] = 0.0
        r[5] = [-1.0, 1.0]
    elif case == "all_zero_r":
        r[:] = 0.0
    elif case.startswith("M="):
        M = int(case[2:])
        pts, r = pts[:M], r[:M]
    else:
        raise ValueError(case)
    return torch.as_tensor(pts), torch.as_tensor(r)


def segment_sum_case(case: str):
    """(ids, values, scale, S) of one case of ``SEG_CASES``: ids (M,) int64
    in [0, S], values (M, D) float64, scale (D,) their ``pow2_scale`` (1
    where there is no value)."""
    rng = np.random.default_rng(13)
    M, D, S = 3000, 12, 128
    if case.startswith("M="):
        M = int(case[2:])
    elif case.startswith("D="):
        D = int(case[2:])
    ids = rng.integers(0, S, M)
    vals = rng.standard_normal((M, D)) * 10.0 ** rng.integers(-6, 3, (M, 1))
    if case == "runs":                       # trajectory order: short runs
        ids = np.repeat(rng.integers(0, S, M // 6 + 1), 6)[:M]
    elif case == "one_segment":
        ids[:] = 5
    elif case == "segment_per_lane":
        ids = (np.arange(M) % 32) * 3
    elif case == "dropped_ids":
        ids = rng.integers(0, S + 1, M)
        ids[:40] = S
    elif case == "plus_minus_scale":         # slices of ±128
        vals = rng.uniform(-1.0, 1.0, (M, D))
        vals[0] = 4.0
        vals[1] = -4.0
        vals[2::5] = 4.0 * rng.choice([-1.0, 1.0], (len(vals[2::5]), D))
    elif case == "zero_column":
        vals[:, 3] = 0.0
    elif case == "ties":                     # halves at every slice
        vals = rng.integers(-2 ** 12, 2 ** 12, (M, D)) / 2.0 ** 12
        vals[0] = 1.0
    elif case != "random" and case[:2] not in ("M=", "D="):
        raise ValueError(case)
    vals = torch.as_tensor(vals)
    scale = pow2_scale(vals) if M else torch.ones(D, dtype=torch.float64)
    return torch.as_tensor(ids), vals, scale, S


def ode_case_nx(case: str, nx: int) -> int:
    """The grid a case of ``PRIMAL_CASES`` / ``ADJOINT_CASES`` runs on:
    its own where it names one (``"nx=12"``), else the caller's."""
    return int(case[3:]) if case.startswith("nx=") else nx


def _edge_points(length: float) -> np.ndarray:
    """Points on, within the slack of, and just beyond each edge and
    corner of [0, length]²."""
    offs = (0.0, 0.5 * _SLACK, -0.5 * _SLACK, 2.0 * _SLACK)
    pts = []
    for d in offs:
        lo, hi, mid = -d, length + d, 0.37 * length
        pts += [(lo, mid), (hi, mid), (mid, lo), (mid, hi),
                (lo, lo), (lo, hi), (hi, lo), (hi, hi)]
    return np.array(pts)


def _line_points(nx: int, length: float, rng) -> np.ndarray:
    """Points on grid nodes, on grid lines and on the diagonal of a
    square (t == s)."""
    h = length / nx
    nodes = h * rng.integers(0, nx + 1, (16, 2))
    on_x = np.stack([h * rng.integers(0, nx + 1, 16),
                     rng.uniform(0.0, length, 16)], 1)
    on_y = on_x[:, ::-1]
    diag = np.repeat(rng.uniform(0.0, length, (16, 1)), 2, axis=1)
    shifted = diag + h * rng.integers(-2, 3, (16, 1)) * np.array([[1, 0]])
    return np.concatenate([nodes, on_x, on_y, diag,
                           np.clip(shifted, 0.0, length)])


def primal_ode_case(case: str, nx: int, length: float = 2.0):
    """(u_img, x0, h, nt) of one case of ``PRIMAL_CASES`` on the
    ``ode_case_nx(case, nx)``² grid of [0, length]²: the half-grid
    velocity image ((2·nx+1)², 2), starts (K, 2), step and time samples."""
    nx = ode_case_nx(case, nx)
    rng = np.random.default_rng(17)
    H = 2 * nx + 1
    gy, gx = np.meshgrid(np.linspace(0.0, length, H),
                         np.linspace(0.0, length, H), indexing="ij")
    img = np.stack([1.0 + 0.3 * np.sin(3.0 * gy) + 0.1 * gx,
                    0.4 * np.cos(2.0 * gx) - 0.2 * gy], -1)
    K, nt, h = 50, 40, 0.01
    x0 = rng.uniform(0.05 * length, 0.95 * length, (77, 2))
    if case.startswith("K="):
        K = int(case[2:])
    elif case.startswith("nt="):
        nt = int(case[3:])
    elif case.startswith("leave_"):
        # unit flow along x: x_k = x0 + k·h to rounding, so a start half a
        # step short of the mark crosses the right edge at a known step
        img = np.stack([np.ones_like(gx), np.zeros_like(gx)], -1)
        first_outside = {"leave_step_0": 0, "leave_step_nt-2": nt - 2,
                         "leave_last_eval": nt - 1,
                         "leave_never": 2 * nt}[case]
        x0[:, 0] = length - h * first_outside + 0.5 * h
    elif case == "edge_slack":
        img = 1e-3 * img
        x0 = _edge_points(length)
        K = len(x0)
    elif case == "grid_lines_and_diagonal":
        img = np.full_like(img, 0.7)
        x0 = _line_points(nx, length, rng)
        K = len(x0)
    elif not case.startswith("nx="):
        raise ValueError(case)
    return (torch.as_tensor(img.reshape(H * H, 2)), torch.as_tensor(x0[:K]),
            h, nt)


def adjoint_ode_case(case: str, nx: int, length: float = 2.0):
    """(g_img, x, resid, vlimit, h) of one case of ``ADJOINT_CASES``: the
    ∇u vertex image ((nx+1)², 2, 2), positions and residuals (K, nt, 2),
    windows (K,) int32 and the step."""
    nx = ode_case_nx(case, nx)
    rng = np.random.default_rng(19)
    K, nt, h = 50, 120, 0.01
    if case.startswith("K="):
        K = int(case[2:])
    elif case.startswith("nt="):
        nt = int(case[3:])
    g_img = rng.standard_normal(((nx + 1) ** 2, 2, 2))
    start = rng.uniform(0.1 * length, 0.9 * length, (K, 1, 2))
    walk = np.cumsum(0.004 * length * rng.standard_normal((K, nt, 2)), 1)
    x = np.clip(start + walk, 0.0, length)
    resid = 0.1 * rng.standard_normal((K, nt, 2))
    vlimit = np.full(K, nt)
    if case == "outside_stretches":
        out = np.repeat(rng.random((K, nt // 8 + 1)) < 0.4, 8, 1)[:, :nt]
        x[..., 0] = np.where(out, length + 0.3, x[..., 0])
    elif case == "outside_late":
        x[:, nt // 3:, 1] = -0.2
    elif case == "outside_throughout":
        x[..., 0] += length + 1.0
    elif case == "edge_slack":
        edge = _edge_points(length)
        x = np.resize(edge, (K, nt, 2))
    elif case == "grid_lines_and_diagonal":
        x = np.resize(_line_points(nx, length, rng), (K, nt, 2))
    elif case.startswith("vlimit="):
        vlimit[:] = {"0": 0, "1": 1, "nt-1": nt - 1, "nt": nt}[case[7:]]
    elif case == "vlimit_mixed":
        vlimit = rng.integers(0, nt + 1, K)
        vlimit[:4] = [0, 1, nt - 1, nt]
    elif case[:2] not in ("K=", "nt", "nx"):
        raise ValueError(case)
    return (torch.as_tensor(g_img), torch.as_tensor(x),
            torch.as_tensor(resid),
            torch.as_tensor(vlimit, dtype=torch.int32), h)
