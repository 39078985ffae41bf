"""The arithmetic and the schedules that the two ODE kernels rely on, in
plain PyTorch on the CPU, held bit for bit (``torch.equal``) to the
kernels' plain versions.

``csrc/adjoint_ode.cu`` evaluates ∇u and the inside flag at all points of
a (tile of buoys, chunk of time steps) first and only then runs the carry
and the μ update from the stored values; ``csrc/grid.cuh`` multiplies by
the reciprocal of a spacing that is a power of two instead of dividing;
``csrc/primal_ode.cu`` clamps the coordinate instead of the position,
sums the six nodes of the owning triangle instead of the nine of the
patch and writes its outputs chunk by chunk with time along the lanes. ``ode/cuda_adjoint.py``, ``ode/cuda_ode.py`` and
``kernels.py`` hold those steps as plain functions. Inputs are the ODE
hard inputs of ``tests/torch_kernel_cases.py`` at Nx=8 (12 and 64 where a
case names its grid), which the card-only tests and the smoke test run
through the kernels. No comparison has a tolerance.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ocean_torch import kernels
from ocean_torch.mesh import structured
from ocean_torch.mesh.locate import (_EPS, _square_index, clamp_to_extent,
                                     in_domain)
from ocean_torch.fem.spaces import make_space
from ocean_torch.ode import cuda_adjoint, cuda_ode
from ocean_torch.ode.grideval import (eval_velocity_grid, grid_coords,
                                      make_grideval)
from ocean_torch.ode.primal import euler_steps
from torch_kernel_cases import (ADJOINT_CASES, PRIMAL_CASES, adjoint_ode_case,
                                ode_case_nx, primal_ode_case)

NX = 8


@functools.lru_cache(maxsize=None)
def grid(nx: int):
    return make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), nx, nx), "cpu"))


# --- adjoint ODE: gather phase, then chain phase ---------------------------

@pytest.mark.parametrize("case", ADJOINT_CASES)
def test_staged_adjoint_equals_plain(case):
    ge = grid(ode_case_nx(case, NX))
    g_img, x, resid, vlimit, h = adjoint_ode_case(case, NX)
    plain = cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                                 h)
    staged = cuda_adjoint.adjoint_ode_steps_staged(ge, g_img, x, resid,
                                                   vlimit, h)
    assert staged.shape == x.shape and torch.equal(staged, plain)
    if case in ("outside_throughout", "vlimit=0"):
        assert not bool(plain.any())
    else:
        assert bool(plain.any())
    if case.startswith("outside"):
        assert not bool(in_domain(ge.locator, x).all())


@pytest.mark.parametrize("tile,chunk", [(1, 1), (3, 7), (8, 25), (32, 50),
                                        (64, 200)])
@pytest.mark.parametrize("case", ["K=33", "outside_stretches",
                                  "vlimit_mixed"])
def test_staged_adjoint_any_tile_and_chunk(case, tile, chunk):
    ge = grid(NX)
    g_img, x, resid, vlimit, h = adjoint_ode_case(case, NX)
    plain = cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                                 h)
    staged = cuda_adjoint.adjoint_ode_steps_staged(
        ge, g_img, x, resid, vlimit, h, tile=tile, chunk=chunk)
    assert torch.equal(staged, plain)


def _source_constant(source: str, name: str) -> int:
    text = (kernels.CSRC / source).read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, f"{name} not found in {source}"
    return int(found.group(1))


def test_mirror_constants_are_the_kernels():
    """The plain mirrors run the schedule of the sources: the same tile
    and chunk sizes."""
    assert cuda_adjoint.TILE == _source_constant("adjoint_ode.cu", "kTile")
    assert cuda_adjoint.CHUNK == _source_constant("adjoint_ode.cu", "kChunk")
    assert cuda_ode.STEPS == _source_constant("primal_ode.cu", "kSteps")
    assert cuda_ode.THREADS == _source_constant("primal_ode.cu", "kThreads")
    text = (kernels.CSRC / "primal_ode.cu").read_text()
    assert "kSharedLimit = 227 * 1024" in text
    assert cuda_ode.SHARED_LIMIT == 227 * 1024
    # the hard inputs are off all of them: ragged tiles, chunks and blocks
    assert 77 % cuda_adjoint.TILE and 136 % cuda_adjoint.CHUNK
    assert 36 % cuda_ode.STEPS and 77 % cuda_ode.THREADS


@pytest.mark.parametrize("nx,image", [(8, True), (32, True), (52, True),
                                      (53, False), (64, False)])
def test_shared_image_size_rule(nx, image):
    """The velocity image goes to shared memory where it fits beside the
    staging rows: 67,600 B at Nx=32, not the 266 KB of Nx=64."""
    ge = grid(nx)
    stage = cuda_ode.shared_bytes(grid(64))
    assert stage == 3 * 2 * 32 * 17 * 16
    got = cuda_ode.shared_bytes(ge)
    assert got <= cuda_ode.SHARED_LIMIT
    assert got == stage + (16 * (2 * nx + 1) ** 2 if image else 0)


# --- location: reciprocal of a power-of-two spacing ------------------------

@pytest.mark.parametrize("hs,exact", [
    (2.0 / 32, True), (2.0 / 64, True), (1.0, True), (2.0 ** -1022, True),
    (2.0 ** 1022, True), (2.0 / 12, False), (0.1, False), (3.0, False),
    (2.0 ** 1023, False), (2.0 ** -1023, False), (5e-324, False),
    (0.0, False), (-0.5, False), (float("inf"), False),
    (float("nan"), False), (0.0625 * (1 + 2.0 ** -52), False)])
def test_exact_reciprocal_marks_powers_of_two(hs, exact):
    inv = kernels.exact_reciprocal(hs)
    if exact:
        assert inv == 1.0 / hs and inv * hs == 1.0
        assert 2.0 ** -1022 <= inv < float("inf")
    else:
        assert inv == 0.0


@settings(max_examples=300, deadline=None)
@given(hs=st.floats(min_value=0.0, allow_nan=False, width=64))
def test_exact_reciprocal_exactly_when_power_of_two(hs):
    """Marked exactly when hs = 2^e with hs and 1/hs normal."""
    mant, _ = np.frexp(hs)
    is_pow2 = (mant == 0.5 and 2.0 ** -1022 <= hs <= 2.0 ** 1022)
    assert (kernels.exact_reciprocal(hs) != 0.0) == is_pow2


def test_geom_carries_the_reciprocal():
    g = kernels.geom(grid(NX).locator, _EPS)
    assert (g.hx, g.hy, g.inv_hx, g.inv_hy) == (0.25, 0.25, 4.0, 4.0)
    g = kernels.geom(grid(12).locator, _EPS)            # 2/12: divided
    assert g.hx == 2.0 / 12 and (g.inv_hx, g.inv_hy) == (0.0, 0.0)


@settings(max_examples=300, deadline=None)
@given(e=st.integers(-40, 40), n=st.integers(1, 4096),
       o=st.floats(-8.0, 8.0), frac=st.floats(0.0, 1.0),
       ulps=st.integers(-3, 3))
def test_location_by_reciprocal_equals_division(e, n, o, frac, ulps):
    """For a power-of-two spacing the square index and the local
    coordinate by ``(p − o) · (1/hs)`` are those by ``(p − o) / hs``, bit
    for bit, at positions across the axis, a few ulps around grid lines
    and at the clamped ends."""
    hs = 2.0 ** e
    inv = kernels.exact_reciprocal(hs)
    assert inv != 0.0
    hi = o + n * hs
    lines = o + hs * np.arange(0, n + 1, max(1, n // 8))
    p = np.concatenate([[o, hi, o + frac * n * hs], lines])
    for _ in range(abs(ulps)):
        p = np.nextafter(p, np.inf if ulps > 0 else -np.inf)
    p = torch.as_tensor(np.clip(p, o, hi))
    i_r, s_r = kernels.axis_coord(p, o, hs, inv, n)
    i_d, s_d = kernels.axis_coord(p, o, hs, 0.0, n)
    assert torch.equal(i_r, i_d)
    assert torch.equal(s_r.view(torch.int64), s_d.view(torch.int64))


@settings(max_examples=300, deadline=None)
@given(e=st.integers(-12, 12), pow2=st.booleans(), n=st.integers(1, 512),
       o=st.floats(-8.0, 8.0), p=st.floats(allow_nan=True, width=64),
       frac=st.floats(-0.5, 1.5))
def test_clamp_on_the_coordinate_equals_clamp_on_the_position(e, pow2, n, o,
                                                               p, frac):
    """The primal ODE clamps the coordinate, not the position: for any
    position (inside, on and beyond the ends, huge, infinite, NaN) and a
    spacing that is or is not a power of two, f chosen among f(p), f(lo)
    and f(hi) has the bits of f(clamp(p, lo, hi))."""
    hs = 2.0 ** e if pow2 else 2.0 ** e / 3.0
    inv = kernels.exact_reciprocal(hs)
    assert (inv != 0.0) == pow2
    lo, hi = o, o + n * hs
    pts = torch.tensor([p, lo, hi, lo + frac * (hi - lo),
                        np.nextafter(lo, -np.inf), np.nextafter(hi, np.inf)],
                       dtype=torch.float64)
    want = kernels.axis_f(pts.clamp(lo, hi), o, hs, inv)
    got = kernels.axis_f_clamped(pts, lo, hi, o, hs, inv)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(nan=0.0).view(torch.int64),
                       want.nan_to_num(nan=0.0).view(torch.int64))


@pytest.mark.parametrize("nx", [8, 12, 64])
def test_axis_coord_mirror_is_the_locator(nx):
    """``kernels.axis_coord`` with the geometry's own reciprocals is
    ``mesh.locate._square_index`` on the hard positions."""
    loc = grid(nx).locator
    g = kernels.geom(loc, _EPS)
    _, x, _, _, _ = adjoint_ode_case("edge_slack", nx)
    _, y, _, _, _ = adjoint_ode_case("grid_lines_and_diagonal", nx)
    pts = torch.cat([x.reshape(-1, 2), y.reshape(-1, 2)])
    px = pts[:, 0].clamp(g.xmin, g.xmax)
    py = pts[:, 1].clamp(g.ymin, g.ymax)
    ix, iy, s, t = _square_index(loc, px, py)
    jx, sx = kernels.axis_coord(px, g.ox, g.hx, g.inv_hx, g.nx)
    jy, sy = kernels.axis_coord(py, g.oy, g.hy, g.inv_hy, g.ny)
    assert torch.equal(ix, jx) and torch.equal(iy, jy)
    assert torch.equal(s, sx) and torch.equal(t, sy)
    assert bool((s == t).any()) and bool((s == 0).any())


# --- primal ODE: six-node patch sum, staged stores -------------------------

def _six_node_steps(ge, u_img, x0, h, nt):
    return euler_steps(
        lambda p: cuda_ode.eval_velocity_six_nodes(ge, u_img, p), x0, h, nt)


@pytest.mark.parametrize("case", PRIMAL_CASES)
def test_six_node_primal_equals_plain(case):
    """Whole trajectories through the six-node sum equal the plain
    nine-node ones: positions, recorded velocities, escape flags and
    steps. The cases do what their names say."""
    ge = grid(ode_case_nx(case, NX))
    u_img, x0, h, nt = primal_ode_case(case, NX)
    xp, up, fp, kp = cuda_ode.primal_ode_steps_plain(ge, u_img, x0, h, nt)
    xs, us, fs, ks = _six_node_steps(ge, u_img, x0, h, nt)
    assert torch.equal(xs, xp) and torch.equal(us, up)
    assert torch.equal(fs, fp) and torch.equal(ks, kp)
    last_inside = in_domain(ge.locator, xp[:, nt - 1])
    if case == "leave_step_0":
        assert bool(fp.all()) and bool((kp == 0).all())
    elif case == "leave_step_nt-2":
        assert bool(fp.all()) and bool((kp == nt - 2).all())
    elif case == "leave_last_eval":
        assert not bool(fp.any()) and not bool(last_inside.any())
    elif case == "leave_never":
        assert not bool(fp.any()) and bool(last_inside.all())
    elif case == "edge_slack":
        # beyond the slack: out at step 0; on or within it: not
        assert 0 < int((kp == 0).sum()) < len(kp)
    elif case == "grid_lines_and_diagonal":
        ix, iy, s, t = grid_coords(ge.locator, xp[:, :nt // 2])
        assert bool((s == t).any()) and bool((s == 0).any())


@pytest.mark.parametrize("nx", [8, 12])
def test_six_node_sum_on_hard_points(nx):
    """Point by point: nodes, grid lines, the diagonal, the slack of every
    edge and corner, and random points inside and outside."""
    ge = grid(nx)
    rng = np.random.default_rng(23)
    Hy, Hx = ge.hg_shape
    u_img = torch.as_tensor(rng.standard_normal((Hy * Hx, 2)))
    _, a, _, _, _ = adjoint_ode_case("edge_slack", nx)
    _, b, _, _, _ = adjoint_ode_case("grid_lines_and_diagonal", nx)
    pts = torch.cat([a.reshape(-1, 2), b.reshape(-1, 2),
                     torch.as_tensor(rng.uniform(-0.2, 2.2, (4000, 2)))])
    v9, i9 = eval_velocity_grid(ge, u_img, pts)
    v6, i6 = cuda_ode.eval_velocity_six_nodes(ge, u_img, pts)
    assert torch.equal(v6, v9) and torch.equal(i6, i9)


@pytest.mark.parametrize("K,nt", [(1, 2), (1, 200), (31, 17), (33, 18),
                                  (77, 37), (64, 33), (100, 200)])
@pytest.mark.parametrize("steps", [8, 16, 32])
def test_staged_stores_cover_every_slot_once(K, nt, steps):
    """The flushes of all warps write x[k, t] for t = 1..nt−1 and
    u_rec[k, t] for t = 0..nt−2 exactly once each, for ragged K and nt;
    the lanes of a store instruction write runs of consecutive times."""
    xs, us = cuda_ode.staged_store_index(K, nt, steps)
    for pairs, t0 in ((xs, 1), (us, 0)):
        hits = np.zeros((K, nt), dtype=np.int64)
        np.add.at(hits, (pairs[:, 0], pairs[:, 1]), 1)
        want = np.zeros((K, nt), dtype=np.int64)
        want[:, t0:t0 + nt - 1] = 1
        assert np.array_equal(hits, want)
    same_buoy = xs[1:, 0] == xs[:-1, 0]
    assert np.all(xs[1:, 1][same_buoy] == xs[:-1, 1][same_buoy] + 1)


# --- the L-shape: projection on the raw position, the five plain mirrors ---

from torch_kernel_cases import (LSHAPE_ADJOINT_CASES, LSHAPE_POINT_CASES,
                                LSHAPE_PRIMAL_CASES, lshape_adjoint_case,
                                lshape_case_res, lshape_point_case,
                                lshape_primal_case)

RES = 8


@functools.lru_cache(maxsize=None)
def lgrid(res: int):
    return make_grideval(make_space(structured.l_shape_mesh(res), "cpu"))


def test_geom_carries_the_lshape_constants():
    g = kernels.geom(lgrid(RES).locator, _EPS)
    assert g.lshape == 1 and (g.cx, g.cy) == (1.0, 1.0)
    assert (g.cx_e, g.cy_e) == (1.0 - _EPS, 1.0 + _EPS)
    assert g.y_proj == 1.0 - 0.5 * 0.25 and (g.nx, g.ny) == (RES, RES)
    r = kernels.geom(grid(NX).locator, _EPS)
    assert r.lshape == 0 and (r.nx, r.ny) == (NX, NX)
    # the raw-position block test needs the corner inside the extent
    bad = dataclasses.replace(lgrid(RES).locator, lshape_corner=(0.0, 1.0))
    with pytest.raises(ValueError):
        kernels.geom(bad, _EPS)


def _short_locate(loc, pts):
    """``csrc/grid.cuh::locate_short`` on the L-shape in plain PyTorch:
    clamps on the coordinate, block test on the raw position."""
    g = kernels.geom(loc, _EPS)
    px, py = pts[..., 0], pts[..., 1]
    fx = kernels.axis_f_clamped(px, g.xmin, g.xmax, g.ox, g.hx, g.inv_hx)
    fy = kernels.lshape_fy_short(px, py, g)
    ix = torch.clamp(torch.floor(fx).nan_to_num(0.0).to(torch.int64), 0,
                     g.nx - 1)
    iy = torch.clamp(torch.floor(fy).nan_to_num(0.0).to(torch.int64), 0,
                     g.ny - 1)
    return ix, iy, fx - ix.to(fx.dtype), fy - iy.to(fy.dtype)


@pytest.mark.parametrize("res", [8, 12, 50])
def test_lshape_short_locate_equals_plain_on_hard_points(res):
    """Corner, slack, re-entrant edges, missing block, random points in
    and around the bounding box, huge and infinite positions: the square
    and the local coordinates from the raw position are the plain
    version's from the clamped and projected one, bit for bit."""
    loc = lgrid(res).locator
    rng = np.random.default_rng(41)
    pts = torch.cat(
        [lshape_point_case(c, res)[0] for c in LSHAPE_POINT_CASES]
        + [torch.as_tensor(rng.uniform(-0.5, 2.5, (3000, 2))),
           torch.tensor([[np.inf, 1.5], [-np.inf, 1.5], [0.5, np.inf],
                         [0.5, -np.inf], [1e300, 1e300], [-1e300, 1e300],
                         [1.0, 1.0], [np.nextafter(1.0, 0.0), 1.5],
                         [0.5, np.nextafter(1.0, 2.0)]])])
    want = grid_coords(loc, pts)
    got = _short_locate(loc, pts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ix, iy, _, _ = want
    # no point is located in the missing block's interior squares
    assert not bool(((ix < res // 2) & (iy > res // 2)).any())
    assert bool((~in_domain(loc, pts)).any())


@settings(max_examples=300, deadline=None)
@given(px=st.floats(allow_nan=True, width=64),
       py=st.floats(allow_nan=True, width=64), res=st.sampled_from([8, 12]))
def test_lshape_block_test_on_raw_equals_clamped(px, py, res):
    """For any position, NaN included: f_y by the raw-position block test
    has the bits of f_y of the clamped and projected position."""
    loc = lgrid(res).locator
    g = kernels.geom(loc, _EPS)
    pts = torch.tensor([[px, py], [px, 1.5], [0.5, py]], dtype=torch.float64)
    _, qy = clamp_to_extent(loc, pts)
    want = kernels.axis_f(qy, g.oy, g.hy, g.inv_hy)
    got = kernels.lshape_fy_short(pts[:, 0], pts[:, 1], g)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(nan=0.0).view(torch.int64),
                       want.nan_to_num(nan=0.0).view(torch.int64))


@pytest.mark.parametrize("case", LSHAPE_PRIMAL_CASES)
def test_six_node_primal_equals_plain_on_lshape(case):
    res = lshape_case_res(case, RES)
    ge = lgrid(res)
    u_img, x0, h, nt = lshape_primal_case(case, RES)
    xp, up, fp, kp = cuda_ode.primal_ode_steps_plain(ge, u_img, x0, h, nt)
    xs, us, fs, ks = _six_node_steps(ge, u_img, x0, h, nt)
    assert torch.equal(xs, xp) and torch.equal(us, up)
    assert torch.equal(fs, fp) and torch.equal(ks, kp)
    if case.startswith("leave_reentrant_"):
        step = {"first": 0, "middle": nt // 2, "last": nt - 2}[case[16:]]
        assert bool(fp.all()) and bool((kp == step).all())
        # through the re-entrant edges, not the outer boundary
        assert bool((xp >= 0.0).all()) and bool((xp <= 2.0).all())
    elif case == "corner_slack":
        assert 0 < int((kp == 0).sum()) < len(kp)
    elif case == "missing_block":
        assert int((kp == 0).sum()) >= len(kp) // 2
    else:
        assert 0 < int(fp.sum()) < len(fp)     # some leave, some stay


@pytest.mark.parametrize("case", LSHAPE_ADJOINT_CASES)
def test_staged_adjoint_equals_plain_on_lshape(case):
    ge = lgrid(lshape_case_res(case, RES))
    g_img, x, resid, vlimit, h = lshape_adjoint_case(case, RES)
    plain = cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                                 h)
    staged = cuda_adjoint.adjoint_ode_steps_staged(ge, g_img, x, resid,
                                                   vlimit, h)
    assert torch.equal(staged, plain) and bool(plain.any())
    inside = in_domain(ge.locator, x)
    assert bool(inside.any()) and not bool(inside.all())


@pytest.mark.parametrize("res,image", [(8, True), (50, True), (52, True),
                                       (54, False), (64, False)])
def test_shared_image_size_rule_on_lshape(res, image):
    """The image covers the bounding box: at resolution 50 its 163,216 B
    fit beside the 52,224 B of staging rows, at 64 they do not."""
    got = cuda_ode.shared_bytes(lgrid(res))
    stage = 3 * 2 * 32 * 17 * 16
    assert got == stage + (16 * (2 * res + 1) ** 2 if image else 0)
    assert got <= cuda_ode.SHARED_LIMIT
    if res == 50:
        assert got == 52224 + 163216
