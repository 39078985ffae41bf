"""Hard inputs for the two scatter kernels (point sources, Ozaki segment
sum) and the two ODE kernels (primal, adjoint), made from fixed numpy
seeds: what is hard for the warp grouping and the integer splits, and
for the buoy tiles, time chunks, escape tests and point location of the
ODE kernels. The CPU tests run them through the plain arithmetic mirrors,
the card-only tests and ``chip_smoke.py`` through the kernels; each is
held to the plain version with ``torch.equal`` (``same`` where NaN
positions make NaN outputs). The rectangle's and the L-shape's cases run
on either diagonal; the pipe cases (graded lines, the obstacle's fringe
and removed squares, NaN) on the meshes of ``PIPE_MESHES``.

Every case is small (M ≤ 4,096 points, K ≤ 300 buoys). Tensors are made
on the CPU; the caller moves them.
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


# ---------------------------------------------------------------------------
# the L-shape [0,2]x[0,1] ∪ [1,2]x[1,2]: inner corner (1, 1), missing block
# x < 1, y > 1
# ---------------------------------------------------------------------------

# Seeds on both sides of the corner's slack (x ≥ 1 − 1e-12 or y ≤ 1 + 1e-12
# is inside) and on the corner itself; buoys that leave through the two
# re-entrant edges at the first, a middle and the last step; seeds in the
# missing block (located by projection, outside from step 0); the
# resolution whose half-grid image just fits in shared memory beside the
# staging rows (50: 163,216 B) and one whose image does not (64)
LSHAPE_PRIMAL_CASES = ("corner_slack", "leave_reentrant_first",
                       "leave_reentrant_middle", "leave_reentrant_last",
                       "missing_block", "res=50", "res=64")

# walks that cross the re-entrant edges both ways (the carry of the last
# in-domain ∇u), stay in the missing block, or sit around the corner
LSHAPE_ADJOINT_CASES = ("walk", "corner_slack", "missing_block",
                        "vlimit_mixed", "res=50", "res=64")

# for the point sources, the ∇u evaluation and (as cell ids) the segment sum
LSHAPE_POINT_CASES = ("random", "corner_slack", "missing_block",
                      "reentrant_edges")

LSHAPE_CORNER = (1.0, 1.0)


def lshape_case_res(case: str, res: int) -> int:
    """The L-shape resolution a case runs on: its own where it names one
    (``"res=50"``), else the caller's."""
    return int(case[4:]) if case.startswith("res=") else res


def _corner_points() -> np.ndarray:
    """Points on the inner corner, and on, within and beyond the slack of
    its two re-entrant edges, on both sides."""
    cx, cy = LSHAPE_CORNER
    offs = (0.0, 0.5 * _SLACK, -0.5 * _SLACK, 2.0 * _SLACK, -2.0 * _SLACK,
            1.0 * _SLACK)
    pts = []
    for dx in offs:
        for dy in offs:
            pts.append((cx - dx, cy + dy))          # around the corner
        pts.append((cx - dx, cy + 0.63))            # along the edge x = cx
        pts.append((cx - 0.41, cy + dx))            # along the edge y = cy
    return np.array(pts)


def _lshape_image(res: int, fn) -> np.ndarray:
    """Half-grid image ((2·res+1)², 2) of ``fn(gx, gy)`` with the nodes
    strictly inside the missing block at zero, as ``velocity_to_grid``
    leaves them."""
    H = 2 * res + 1
    gy, gx = np.meshgrid(np.linspace(0.0, 2.0, H), np.linspace(0.0, 2.0, H),
                         indexing="ij")
    img = np.stack(fn(gx, gy), -1)
    cx, cy = LSHAPE_CORNER
    img[(gx < cx) & (gy > cy)] = 0.0
    return img.reshape(H * H, 2)


def lshape_point_case(case: str, res: int):
    """(points, r) of one case of ``LSHAPE_POINT_CASES``, (M, 2) float64
    each, |r| ≤ 1, on and around the L-shape."""
    rng = np.random.default_rng(29)
    cx, cy = LSHAPE_CORNER
    M = 1500
    pts = rng.uniform(-0.1, 2.1, (M, 2))
    if case == "corner_slack":
        pts = np.resize(_corner_points(), (M, 2))
    elif case == "missing_block":
        pts = np.stack([rng.uniform(-0.1, cx, M),
                        rng.uniform(cy, 2.1, M)], 1)
        pts[::5] = rng.uniform(0.0, 2.0, (len(pts[::5]), 2))
    elif case == "reentrant_edges":         # on the edges and half a square
        h = 2.0 / res                       # either side of them
        t = rng.uniform(0.0, 1.0, M)
        side = rng.choice([-0.5 * h, 0.0, 0.5 * h], M)
        pts = np.where((np.arange(M) % 2 == 0)[:, None],
                       np.stack([cx + side, cy + t], 1),
                       np.stack([cx - t, cy + side], 1))
    elif case != "random":
        raise ValueError(case)
    r = rng.uniform(-1.0, 1.0, (M, 2))
    r[::11] = 0.0
    return torch.as_tensor(pts), torch.as_tensor(r)


def lshape_primal_case(case: str, res: int):
    """(u_img, x0, h, nt) of one case of ``LSHAPE_PRIMAL_CASES`` on the
    L-shape at resolution ``lshape_case_res(case, res)``."""
    res = lshape_case_res(case, res)
    rng = np.random.default_rng(31)
    cx, cy = LSHAPE_CORNER
    K, nt, h = 60, 40, 0.01
    img = _lshape_image(res, lambda gx, gy: (
        0.4 * np.sin(3.0 * gy) - 0.9 + 0.1 * gx,
        0.8 * np.cos(2.0 * gx) + 0.3 * gy))
    # seeds inside the L, many near the re-entrant edges
    x0 = np.concatenate([
        np.stack([rng.uniform(1.0, 1.3, 30), rng.uniform(1.0, 1.9, 30)], 1),
        np.stack([rng.uniform(0.1, 1.0, 30), rng.uniform(0.7, 1.0, 30)], 1),
        rng.uniform([0.05, 0.05], [1.95, 0.95], (17, 2))])
    if case == "corner_slack":
        img = 1e-3 * img
        x0 = _corner_points()
        K = len(x0)
    elif case.startswith("leave_reentrant_"):
        # unit flow (−1, +1): x_k = x0 − k·h and y_k = y0 + k·h to
        # rounding. A start half a step short of the mark crosses the edge
        # x = cx (from the upper block) or y = cy (from the lower left) at a
        # known step
        first_outside = {"first": 0, "middle": nt // 2,
                         "last": nt - 2}[case[16:]]
        img = _lshape_image(res, lambda gx, gy: (-np.ones_like(gx),
                                                 np.ones_like(gx)))
        K = 40
        x0 = np.empty((K, 2))
        x0[:20, 0] = cx + h * first_outside - 0.5 * h
        x0[:20, 1] = rng.uniform(1.05, 1.5, 20)
        x0[20:, 0] = rng.uniform(0.5, 0.9, 20)
        x0[20:, 1] = cy - h * first_outside + 0.5 * h
    elif case == "missing_block":
        x0[::2] = np.stack([rng.uniform(0.0, 0.99, len(x0[::2])),
                            rng.uniform(1.01, 2.0, len(x0[::2]))], 1)
        K = len(x0)
    elif not case.startswith("res="):
        raise ValueError(case)
    return torch.as_tensor(img), torch.as_tensor(x0[:K]), h, nt


def lshape_adjoint_case(case: str, res: int):
    """(g_img, x, resid, vlimit, h) of one case of
    ``LSHAPE_ADJOINT_CASES`` on the L-shape at resolution
    ``lshape_case_res(case, res)``."""
    res = lshape_case_res(case, res)
    rng = np.random.default_rng(37)
    cx, cy = LSHAPE_CORNER
    K, nt, h = 50, 120, 0.01
    g_img = rng.standard_normal(((res + 1) ** 2, 2, 2))
    start = np.stack([rng.uniform(0.6, 1.4, K), rng.uniform(0.6, 1.4, K)],
                     1)[:, None, :]
    walk = np.cumsum(0.03 * rng.standard_normal((K, nt, 2)), 1)
    x = np.clip(start + walk, -0.05, 2.05)
    resid = 0.1 * rng.standard_normal((K, nt, 2))
    vlimit = np.full(K, nt)
    if case == "corner_slack":
        x = np.resize(_corner_points(), (K, nt, 2))
    elif case == "missing_block":
        x[: K // 2, :, 0] = np.clip(x[: K // 2, :, 0], 0.0, 0.95)
        x[: K // 2, :, 1] = np.clip(x[: K // 2, :, 1], 1.05, 2.0)
    elif case == "vlimit_mixed":
        vlimit = rng.integers(0, nt + 1, K)
    elif case != "walk" and not case.startswith("res="):
        raise ValueError(case)
    return (torch.as_tensor(g_img), torch.as_tensor(x),
            torch.as_tensor(resid),
            torch.as_tensor(vlimit, dtype=torch.int32), h)


# ---------------------------------------------------------------------------
# the "left" diagonal (v10 -- v01): points on s + t = 1 of every square
# ---------------------------------------------------------------------------

def anti_diagonal_points(nx: int, length: float = 2.0, n: int = 64,
                         seed: int = 47) -> np.ndarray:
    """Points on the "left" diagonal s + t = 1 of random squares of the
    nx × nx grid of [0, length]², on its ends (grid nodes) and a few ulps
    off it."""
    rng = np.random.default_rng(seed)
    h = length / nx
    i = rng.integers(0, nx, (n, 2))
    s = rng.uniform(0.0, 1.0, n)
    s[:4] = [0.0, 1.0, 0.5, 0.25]
    pts = np.stack([(i[:, 0] + s) * h, (i[:, 1] + 1.0 - s) * h], 1)
    off = np.nextafter(pts, np.where(rng.random((n, 2)) < 0.5, -np.inf,
                                     np.inf))
    return np.concatenate([pts, off])


def left_primal_case(nx: int, length: float = 2.0):
    """(u_img, x0, h, nt) for the "left" diagonal: starts on the
    anti-diagonals, a flow along them (−1, +1) that keeps them near, on the
    nx × nx grid of [0, length]²."""
    H = 2 * nx + 1
    gy, gx = np.meshgrid(np.linspace(0.0, length, H),
                         np.linspace(0.0, length, H), indexing="ij")
    img = np.stack([-0.7 + 0.05 * np.sin(2.0 * gy), 0.7 + 0.0 * gx], -1)
    return (torch.as_tensor(img.reshape(H * H, 2)),
            torch.as_tensor(anti_diagonal_points(nx, length)), 0.01, 40)


# ---------------------------------------------------------------------------
# the gen-1 pipe [0,2]²: graded tensor grids and the obstacle (the disk at
# (0.2, 0.2), radius 0.05, and the staircase of squares that touch it)
# ---------------------------------------------------------------------------

# pipe_mesh keyword arguments of the meshes the pipe cases run on, at the
# JAX package's test sizes
PIPE_MESHES = {
    "hole": dict(resolution=12, obstacle=True),
    "graded": dict(graded=True, lc_min=0.08, lc_max=0.3),
    "hole_graded": dict(obstacle=True, graded=True, lc_min=0.08,
                        lc_max=0.3),
    "hole_graded_left": dict(obstacle=True, graded=True, lc_min=0.08,
                             lc_max=0.3, diagonal="left"),
}

# seeds in the fringe between the disk and the staircase (outside from
# step 0); buoys that enter the removed squares at the first, a middle and
# the last step; starts on grid lines, on the first and the last line and
# at −0.0; NaN and infinite starts; random starts in a random flow
PIPE_PRIMAL_CASES = ("fringe", "enter_hole_first", "enter_hole_middle",
                     "enter_hole_last", "on_lines", "nan", "random")



def pipe_primal_cases():
    """(mesh name, case) pairs: the fringe and the staircase are cases of
    the meshes with an obstacle."""
    return [(name, case) for name, kw in sorted(PIPE_MESHES.items())
            for case in PIPE_PRIMAL_CASES
            if kw.get("obstacle") or case in ("on_lines", "nan", "random")]

# walks across the removed squares (the carry of the last in-domain ∇u),
# seeds in the fringe, points on grid lines, NaN positions, every window
PIPE_ADJOINT_CASES = ("walk", "fringe", "on_lines", "nan", "vlimit_mixed")

# for the point sources and the ∇u evaluation (no NaN: an escaped buoy
# carries no source, and its sources are not at NaN)
PIPE_POINT_CASES = ("random", "fringe", "on_lines")

HOLE = (0.2, 0.2, 0.05)

# the JAX package's record of its pipe kernels on its TPU
# (scripts/pallas_domains_hw.py, results/bench_stages/pallas_domains_hw.json):
# pipe_mesh keyword arguments and the escapes of K=512 buoys
PIPE_RECORD = {
    "pipe_hole_uniform": (dict(resolution=22, obstacle=True), 25),
    "pipe_graded": (dict(obstacle=False, graded=True, lc_min=0.06,
                         lc_max=0.2), 19),
    "pipe_hole_graded": (dict(obstacle=True, graded=True, lc_min=0.06,
                              lc_max=0.2), 24),
}


def _half_lines(lines: np.ndarray) -> np.ndarray:
    """The half-grid lines of one axis: the grid lines interleaved with
    the interval midpoints."""
    half = np.empty(2 * len(lines) - 1)
    half[0::2] = lines
    half[1::2] = 0.5 * (lines[:-1] + lines[1:])
    return half


def _axis_lines(mesh, axis: int) -> np.ndarray:
    lines = mesh.xs if axis == 0 else mesh.ys
    if lines is not None:
        return lines
    n = mesh.grid_shape[axis]
    return mesh.origin[axis] + mesh.spacing[axis] * np.arange(n + 1)


def fringe_points(mesh, n: int, seed: int = 53) -> np.ndarray:
    """n points off the disk in squares that hold no cells: outside, though
    not in the obstacle itself. Without an obstacle: points off the disk
    in the squares that it would have removed (inside)."""
    rng = np.random.default_rng(seed)
    xs, ys = _axis_lines(mesh, 0), _axis_lines(mesh, 1)
    inactive = mesh.square_to_cell[:, :, 0] < 0
    if not inactive.any():
        cx = 0.5 * (xs[:-1] + xs[1:])[None, :]
        cy = 0.5 * (ys[:-1] + ys[1:])[:, None]
        inactive = (np.maximum(np.abs(cx - HOLE[0]) - 0.5 * np.diff(xs), 0)
                    ** 2 + np.maximum(np.abs(cy - HOLE[1])
                                      - 0.5 * np.diff(ys)[:, None], 0) ** 2
                    < HOLE[2] ** 2)
    iy, ix = np.nonzero(inactive)
    out = []
    while len(out) < n:
        k = rng.integers(0, len(ix), 4 * n)
        p = np.stack([rng.uniform(xs[ix[k]], xs[ix[k] + 1]),
                      rng.uniform(ys[iy[k]], ys[iy[k] + 1])], 1)
        far = ((p[:, 0] - HOLE[0]) ** 2 + (p[:, 1] - HOLE[1]) ** 2
               >= HOLE[2] ** 2)
        out.extend(p[far])
    return np.array(out[:n])


def line_points(mesh, n: int = 96, seed: int = 59) -> np.ndarray:
    """Points exactly on grid lines and nodes, on the first and the last
    line of each axis, at −0.0, and two just beyond the slack."""
    rng = np.random.default_rng(seed)
    xs, ys = _axis_lines(mesh, 0), _axis_lines(mesh, 1)
    on_x = np.stack([rng.choice(xs, n), rng.uniform(0.0, 2.0, n)], 1)
    on_y = np.stack([rng.uniform(0.0, 2.0, n), rng.choice(ys, n)], 1)
    nodes = np.stack([rng.choice(xs, n), rng.choice(ys, n)], 1)
    ends = np.array([[xs[0], 1.3], [xs[-1], 0.7], [1.1, ys[0]],
                     [0.9, ys[-1]], [-0.0, 1.0], [1.0, -0.0], [-0.0, -0.0],
                     [xs[-1], ys[-1]], [xs[-1] + 1e-9, 0.5],
                     [0.5, ys[0] - 1e-9]])
    return np.concatenate([ends, on_x, on_y, nodes])


def _pipe_image(mesh, fn) -> np.ndarray:
    """Half-grid image of ``fn(gx, gy)`` on the pipe's half-grid (the
    nodes in removed squares hold values a dof would not; no in-domain
    evaluation reads them with a weight other than 0)."""
    hx, hy = _half_lines(_axis_lines(mesh, 0)), _half_lines(
        _axis_lines(mesh, 1))
    gy, gx = np.meshgrid(hy, hx, indexing="ij")
    return np.stack(fn(gx, gy), -1).reshape(-1, 2)


def pipe_primal_case(case: str, mesh):
    """(u_img, x0, h, nt) of one case of ``PIPE_PRIMAL_CASES`` on the pipe
    ``mesh`` (``mesh.structured.pipe_mesh``)."""
    rng = np.random.default_rng(61)
    K, nt, h = 60, 40, 0.01
    img = _pipe_image(mesh, lambda gx, gy: (
        0.6 * np.sin(2.0 * gy) - 0.3 + 0.1 * gx,
        0.5 * np.cos(3.0 * gx) - 0.2 * gy))
    x0 = rng.uniform(0.02, 1.98, (K, 2))
    x0[:20] = rng.uniform(0.05, 0.45, (20, 2))         # around the obstacle
    if case == "fringe":
        x0[::2] = fringe_points(mesh, len(x0[::2]))
    elif case.startswith("enter_hole_"):
        # unit flow (−1, 0): x_k = x0 − k·h to rounding. In the rows of
        # removed squares, a start that puts x_step half a step short of
        # the right edge X_e of the row's last removed square (a point on
        # X_e belongs to the active square on its right) enters the
        # staircase at step `step`
        step = {"first": 0, "middle": nt // 2, "last": nt - 2}[case[11:]]
        img = _pipe_image(mesh, lambda gx, gy: (-np.ones_like(gx),
                                                np.zeros_like(gx)))
        xs, ys = _axis_lines(mesh, 0), _axis_lines(mesh, 1)
        rows = np.nonzero((mesh.square_to_cell[:, :, 0] < 0).any(1))[0]
        iy = rng.choice(rows, K)
        y = rng.uniform(ys[iy], ys[iy + 1])
        last = np.array([np.nonzero(mesh.square_to_cell[r, :, 0] < 0)[0][-1]
                         for r in iy])
        x0 = np.stack([xs[last + 1] + h * step - 0.5 * h, y], 1)
    elif case == "on_lines":
        img = 1e-3 * img
        x0 = line_points(mesh)
        K = len(x0)
    elif case == "nan":
        x0[::3, 0] = np.nan
        x0[1::7, 1] = np.nan
        x0[2] = [np.inf, 1.0]
        x0[5] = [1.0, -np.inf]
    elif case != "random":
        raise ValueError(case)
    return torch.as_tensor(img), torch.as_tensor(x0[:K]), h, nt


def pipe_adjoint_case(case: str, mesh):
    """(g_img, x, resid, vlimit, h) of one case of ``PIPE_ADJOINT_CASES``
    on the pipe ``mesh``."""
    rng = np.random.default_rng(67)
    nx, ny = mesh.grid_shape
    K, nt, h = 50, 120, 0.01
    g_img = rng.standard_normal(((nx + 1) * (ny + 1), 2, 2))
    start = rng.uniform(0.05, 0.5, (K, 1, 2))
    walk = np.cumsum(0.02 * rng.standard_normal((K, nt, 2)), 1)
    x = np.clip(start + walk, -0.05, 2.05)
    resid = 0.1 * rng.standard_normal((K, nt, 2))
    vlimit = np.full(K, nt)
    if case == "fringe":
        x[: K // 2, nt // 3:] = np.resize(fringe_points(mesh, 64),
                                           (K // 2, nt - nt // 3, 2))
    elif case == "on_lines":
        x = np.resize(line_points(mesh), (K, nt, 2))
    elif case == "nan":
        x[::4, 10:30, 0] = np.nan
        x[1::4, 50:, 1] = np.nan
    elif case == "vlimit_mixed":
        vlimit = rng.integers(0, nt + 1, K)
    elif case != "walk":
        raise ValueError(case)
    return (torch.as_tensor(g_img), torch.as_tensor(x),
            torch.as_tensor(resid),
            torch.as_tensor(vlimit, dtype=torch.int32), h)


def pipe_point_case(case: str, mesh):
    """(points, r) of one case of ``PIPE_POINT_CASES`` on and around the
    pipe ``mesh``, (M, 2) float64 each, |r| ≤ 1."""
    rng = np.random.default_rng(71)
    M = 1500
    pts = rng.uniform(-0.1, 2.1, (M, 2))
    pts[: M // 3] = rng.uniform(0.0, 0.5, (M // 3, 2))   # around the disk
    if case == "fringe":
        pts[::2] = fringe_points(mesh, len(pts[::2]))
    elif case == "on_lines":
        pts = np.resize(line_points(mesh), (M, 2))
    elif case != "random":
        raise ValueError(case)
    r = rng.uniform(-1.0, 1.0, (M, 2))
    r[::11] = 0.0
    return torch.as_tensor(pts), torch.as_tensor(r)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal``, with NaN equal to NaN: a buoy that starts at NaN
    keeps its NaN position, and a NaN point has a NaN ∇u."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
