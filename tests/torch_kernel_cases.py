"""Hard inputs for the two scatter kernels (point sources, Ozaki segment
sum), made from fixed numpy seeds: what is hard for the warp grouping and
for the integer splits. The CPU tests run them through the plain
arithmetic mirrors, the card-only tests and ``chip_smoke.py`` through the
kernels; each is held to the plain version with ``torch.equal``.

Every case is small (M ≤ 4,096). Tensors are made on the CPU; the caller
moves them.
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
