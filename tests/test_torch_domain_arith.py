"""The arithmetic the four grid kernels use on the other structured
domains, in plain PyTorch on the CPU, held bit for bit to the plain
versions: the binary search over a graded grid's lines
(``kernels.graded_axis``, the mirror of ``csrc/grid.cuh::axis_search``),
the obstacle test as the kernels evaluate it (``kernels.off_obstacle``),
the six-node patch sum of the primal ODE and the P2/P1 weights on the
"left" diagonal, the staged adjoint schedule and the grouped point-source
sums on the pipe meshes, and the kernel geometry of each domain. Inputs
are the hard inputs of ``tests/torch_kernel_cases.py`` (positions on
grid lines and on the anti-diagonal s + t = 1, in the fringe between the
disk and the removed squares, entering the removed squares at known
steps, NaN and infinite) and hypothesis over float64 positions. No
comparison has a tolerance.
"""

import functools
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ocean_torch import kernels
from ocean_torch.adjoint import cuda_psrc
from ocean_torch.fem.spaces import make_space
from ocean_torch.mesh import structured
from ocean_torch.mesh.locate import (_EPS, _square_index, in_domain,
                                     locate_points)
from ocean_torch.ode import cuda_adjoint, cuda_ode
from ocean_torch.ode.grideval import (eval_p1_tensor_grid,
                                      eval_velocity_grid, grid_coords,
                                      make_grideval, p1_patch_weights,
                                      p2_patch_weights)
from ocean_torch.ode.primal import euler_steps
import torch_kernel_cases as kc

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def pipe(name: str):
    mesh, _ = structured.pipe_mesh(**kc.PIPE_MESHES[name])
    return mesh, make_grideval(make_space(mesh, "cpu"))


@functools.lru_cache(maxsize=None)
def left_rect(nx: int):
    return make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), nx, nx, diagonal="left"), "cpu"))


@functools.lru_cache(maxsize=None)
def left_lshape(res: int):
    return make_grideval(make_space(structured.l_shape_mesh(
        res, diagonal="left"), "cpu"))


# --- the graded search -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lines(lc_min: float, lc_max: float, center: float) -> torch.Tensor:
    return torch.as_tensor(structured.graded_lines(
        0.0, 2.0, center, lc_min, lc_max, 0.05, 4.0))


@settings(max_examples=400, deadline=None)
@given(p=st.floats(allow_nan=True, width=64),
       lc=st.sampled_from([(0.05 / 3, 0.09), (0.06, 0.2), (0.08, 0.3),
                           (0.01, 0.5)]),
       center=st.sampled_from([0.2, 1.0, 1.9]),
       pick=st.integers(0, 10 ** 6), ulps=st.integers(-2, 2))
def test_graded_search_counts_like_searchsorted(p, lc, center, pick, ulps):
    """For any float64 position, clamped as the kernels clamp it (NaN stays
    NaN): the binary search gives searchsorted(right=True)'s square, and
    the local coordinate's bits. Positions on a line, a few ulps off one,
    on the first and last line, −0.0, huge and infinite ones."""
    lines = _lines(*lc, center)
    n = len(lines) - 1
    line = float(lines[pick % (n + 1)])
    for _ in range(abs(ulps)):
        line = float(np.nextafter(line, np.inf if ulps > 0 else -np.inf))
    raw = torch.tensor([p, line, -0.0, 0.0, 2.0, float(lines[1]),
                        float(np.nextafter(2.0, 0.0)), math.inf, -math.inf,
                        math.nan], dtype=torch.float64)
    q = torch.clamp(raw, 0.0, 2.0)
    i, s = kernels.graded_axis(q, lines, n)
    j = torch.clamp(torch.searchsorted(lines, q, right=True) - 1, 0, n - 1)
    lo = lines[j]
    want = (q - lo) / (lines[j + 1] - lo)
    assert torch.equal(i, j)
    assert kc.same(s, want)
    assert torch.equal(s.nan_to_num(0.0).view(torch.int64),
                       want.nan_to_num(0.0).view(torch.int64))
    assert int(i[-1]) == n - 1                   # NaN: the last square


def test_searchsorted_counts_nan_as_every_line():
    """What the kernels copy: NaN and +inf count every line, −inf none."""
    lines = torch.tensor([0.0, 0.3, 0.5, 1.0, 2.0], dtype=torch.float64)
    p = torch.tensor([math.nan, math.inf, -math.inf, 0.3, -0.0])
    got = torch.searchsorted(lines, p.double(), right=True).tolist()
    assert got == [5, 5, 0, 2, 1]
    i, _ = kernels.graded_axis(p.double(), lines, 4)
    assert i.tolist() == [3, 3, 0, 1, 0]


@pytest.mark.parametrize("name", ["graded", "hole_graded"])
def test_graded_search_is_the_locator(name):
    """On the pipe meshes' own lines and hard points, clamped: the mirror
    is ``mesh.locate._square_index``'s graded branch."""
    mesh, ge = pipe(name)
    loc = ge.locator
    pts = torch.cat([torch.as_tensor(kc.line_points(mesh)),
                     torch.as_tensor(kc.fringe_points(mesh, 200)),
                     kc.pipe_point_case("random", mesh)[0]])
    px, py = pts[:, 0].clamp(0.0, 2.0), pts[:, 1].clamp(0.0, 2.0)
    ix, iy, s, t = _square_index(loc, px, py)
    jx, sx = kernels.graded_axis(px, loc.xs_lines, loc.grid_shape[0])
    jy, ty = kernels.graded_axis(py, loc.ys_lines, loc.grid_shape[1])
    assert torch.equal(ix, jx) and torch.equal(iy, jy)
    assert torch.equal(s, sx) and torch.equal(t, ty)
    assert bool((s == 0).any()) and bool((t == 0).any())


# --- the obstacle test -------------------------------------------------------

@settings(max_examples=400, deadline=None)
@given(d=st.floats(allow_nan=True, width=64))
def test_square_by_pow_is_the_product(d):
    """torch's ``** 2`` on float64 is one rounded product, d · d, as the
    kernels compute it (NaN and infinities included)."""
    a = torch.tensor([d, -d, d * 0.5], dtype=torch.float64)
    assert kc.same(a ** 2, a * a)


@settings(max_examples=300, deadline=None)
@given(x=st.floats(allow_nan=True, width=64),
       y=st.floats(allow_nan=True, width=64),
       name=st.sampled_from(["hole", "hole_graded", "hole_graded_left"]))
def test_obstacle_test_as_the_kernels_do_it(x, y, name):
    """extent ∧ off_obstacle (dx·dx + dy·dy ≥ r² on the raw position, the
    active square of the clamped one) is ``in_domain`` for any position,
    also near the disk and in its fringe."""
    mesh, ge = pipe(name)
    loc = ge.locator
    g = kernels.geom(loc, _EPS)
    pts = torch.tensor([[x, y], [0.2 + 1e-3 * math.tanh(x or 0.0), y],
                        [x, 0.25], [0.2, 0.25], [0.25, 0.2]],
                       dtype=torch.float64)
    _check_obstacle(loc, g, pts)


def _check_obstacle(loc, g, pts):
    px, py = pts[:, 0], pts[:, 1]
    ix, iy, _, _ = _square_index(loc, px.clamp(0.0, 2.0), py.clamp(0.0, 2.0))
    ext = ((px >= g.xmin_e) & (px <= g.xmax_e) & (py >= g.ymin_e)
           & (py <= g.ymax_e))
    got = ext & kernels.off_obstacle(px, py, ix, iy, g,
                                     kernels.active_squares(loc))
    assert torch.equal(got, in_domain(loc, pts))


@pytest.mark.parametrize("name", sorted(kc.PIPE_MESHES))
def test_obstacle_test_on_hard_points(name):
    mesh, ge = pipe(name)
    loc = ge.locator
    pts = torch.cat([torch.as_tensor(kc.fringe_points(mesh, 300)),
                     torch.as_tensor(kc.line_points(mesh)),
                     kc.pipe_point_case("random", mesh)[0]])
    if loc.hole is None:
        assert bool(in_domain(loc, pts[300:]).any())
        return
    _check_obstacle(loc, kernels.geom(loc, _EPS), pts)
    # the fringe is outside though off the disk
    assert not bool(in_domain(loc, pts[:300]).any())


# --- the kernel geometry -----------------------------------------------------

def test_geom_of_each_domain():
    """Flags of the host description; a graded grid hands the kernels no
    spacing (NaN), r² is the Python float r * r; a uniform pipe without
    an obstacle is a rectangle."""
    for name, (graded, hole, left) in {
            "hole": (0, 1, 0), "graded": (1, 0, 0),
            "hole_graded": (1, 1, 0), "hole_graded_left": (1, 1, 1)}.items():
        loc = pipe(name)[1].locator
        g = kernels.geom(loc, _EPS)
        assert (g.graded, g.hole, g.left, g.lshape) == (graded, hole, left,
                                                         0)
        assert (g.nx, g.ny) == loc.grid_shape
        if graded:
            assert math.isnan(g.hx) and math.isnan(g.hy)
            assert (g.inv_hx, g.inv_hy) == (0.0, 0.0)
            assert g.xs and g.ys
        else:
            assert (g.hx, g.inv_hx) == (2.0 / 12, 0.0) and not g.xs
        if hole:
            assert (g.hcx, g.hcy, g.r2) == (0.2, 0.2, 0.05 * 0.05)
            assert g.active == kernels.active_squares(loc).data_ptr()
        assert len(kernels.grid_tables(loc)) == 2 * graded + hole
    plain, _ = structured.pipe_mesh(resolution=12)
    g = kernels.geom(make_grideval(make_space(plain, "cpu")).locator, _EPS)
    assert (g.graded, g.hole, g.left, g.lshape) == (0, 0, 0, 0)
    g = kernels.geom(left_lshape(8).locator, _EPS)
    assert (g.lshape, g.left, g.y_proj) == (1, 1, 1.0 - 0.5 * 0.25)
    act = kernels.active_squares(pipe("hole")[1].locator)
    assert act.dtype == torch.uint8 and act.shape == (12, 12)
    assert int((act == 0).sum()) == 4


def test_shared_image_size_rule_on_graded_pipes():
    """The graded grid's lines (8 B each) go behind the staging rows; the
    image joins them where all fit: at lc 0.08/0.3 it does, at the gmsh
    defaults (73 squares an axis, 345,744 B of image) it does not."""
    stage = 3 * 2 * 32 * 17 * 16
    _, ge = pipe("hole_graded")
    nx, ny = ge.locator.grid_shape
    Hy, Hx = ge.hg_shape
    lines = 8 * (nx + 1 + ny + 1)
    assert cuda_ode.shared_bytes(ge) == stage + lines + 16 * Hy * Hx
    mesh, _ = structured.pipe_mesh(obstacle=True, graded=True)
    big = make_grideval(make_space(mesh, "cpu"))
    assert mesh.grid_shape == (73, 73) and big.hg_shape == (147, 147)
    assert cuda_ode.shared_bytes(big) == stage + 8 * 148
    assert stage + 8 * 148 + 16 * 147 ** 2 > cuda_ode.SHARED_LIMIT


# --- the "left" diagonal ------------------------------------------------------

def _hard_points(nx):
    rng = np.random.default_rng(73)
    return torch.cat([torch.as_tensor(kc.anti_diagonal_points(nx)),
                      torch.as_tensor(rng.uniform(-0.2, 2.2, (3000, 2))),
                      torch.as_tensor(kc._line_points(nx, 2.0, rng))])


@pytest.mark.parametrize("nx", [8, 12])
def test_left_six_node_sum_on_hard_points(nx):
    ge = left_rect(nx)
    rng = np.random.default_rng(79)
    Hy, Hx = ge.hg_shape
    u_img = torch.as_tensor(rng.standard_normal((Hy * Hx, 2)))
    pts = _hard_points(nx)
    v9, i9 = eval_velocity_grid(ge, u_img, pts)
    v6, i6 = cuda_ode.eval_velocity_six_nodes(ge, u_img, pts)
    assert torch.equal(v6, v9) and torch.equal(i6, i9)
    _, _, s, t = grid_coords(ge.locator, pts)
    assert bool((s + t == 1.0).any())


def test_left_weights_vanish_off_the_owning_triangle():
    """The nodes outside the owning triangle get weight 0 exactly, the
    weights sum to 1 (to rounding), on both sides of s + t = 1."""
    pts = _hard_points(8)
    _, _, s, t = grid_coords(left_rect(8).locator, pts)
    W2, W1 = p2_patch_weights(s, t, "left"), p1_patch_weights(s, t, "left")
    up = s + t > 1.0
    assert bool(up.any()) and bool((~up).any())
    for W, zero_lo, zero_up in ((W2, [(1, 2), (2, 1), (2, 2)],
                                 [(0, 0), (0, 1), (1, 0)]),
                                (W1, [(1, 1)], [(0, 0)])):
        for b, a in zero_lo:
            assert bool((W[~up][:, b, a] == 0).all())
        for b, a in zero_up:
            assert bool((W[up][:, b, a] == 0).all())
        assert float((W.sum((-1, -2)) - 1).abs().max()) < 1e-14


def test_left_locator_picks_the_cell_that_holds_the_point():
    ge = left_rect(8)
    pts = _hard_points(8)
    cell, xi, inside = locate_points(ge.locator, pts)
    mesh = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8, "left")
    v = torch.as_tensor(mesh.vertices[mesh.cells])[cell]
    rec = v[:, 0] + xi[:, :1] * (v[:, 1] - v[:, 0]) + xi[:, 1:] * (
        v[:, 2] - v[:, 0])
    sel = inside
    assert float((rec[sel] - pts[sel]).abs().max()) < 1e-14
    assert float(xi[sel].min()) > -1e-14
    assert float(xi[sel].sum(1).max()) < 1 + 1e-14


# --- the primal ODE: six-node sum on the new domains ------------------------

def _six_node_steps(ge, u_img, x0, h, nt):
    return euler_steps(
        lambda p: cuda_ode.eval_velocity_six_nodes(ge, u_img, p), x0, h, nt)


def _same_steps(ge, u_img, x0, h, nt):
    plain = cuda_ode.primal_ode_steps_plain(ge, u_img, x0, h, nt)
    six = _six_node_steps(ge, u_img, x0, h, nt)
    assert all(kc.same(a, b) for a, b in zip(six, plain))
    return plain


@pytest.mark.parametrize("name,case", kc.pipe_primal_cases())
def test_six_node_primal_equals_plain_on_pipes(name, case):
    """Whole trajectories through the six-node sum equal the plain
    nine-node ones on the pipes; the cases do what their names say."""
    mesh, ge = pipe(name)
    u_img, x0, h, nt = kc.pipe_primal_case(case, mesh)
    x, _, failed, kfail = _same_steps(ge, u_img, x0, h, nt)
    if case.startswith("enter_hole_"):
        step = {"first": 0, "middle": nt // 2, "last": nt - 2}[case[11:]]
        assert bool(failed.all()) and bool((kfail == step).all())
        # through the removed squares, not the outer boundary
        assert bool((x >= 0.0).all()) and bool((x <= 2.0).all())
    elif case == "fringe":
        assert bool((kfail[::2] == 0).all())
    elif case == "nan":
        bad = ~torch.isfinite(x0).all(1)
        assert bool((kfail[bad] == 0).all())
        assert bool(x[bad].isnan().any()) and not bool(x[~bad].isnan().any())
    else:
        assert 0 < int(failed.sum()) < len(failed) or case == "on_lines"


@pytest.mark.parametrize("case", kc.PRIMAL_CASES + ("anti_diagonal",))
def test_six_node_primal_equals_plain_on_left_rectangle(case):
    if case == "anti_diagonal":
        ge = left_rect(8)
        u_img, x0, h, nt = kc.left_primal_case(8)
    else:
        ge = left_rect(kc.ode_case_nx(case, 8))
        u_img, x0, h, nt = kc.primal_ode_case(case, 8)
    _same_steps(ge, u_img, x0, h, nt)


@pytest.mark.parametrize("case", kc.LSHAPE_PRIMAL_CASES)
def test_six_node_primal_equals_plain_on_left_lshape(case):
    ge = left_lshape(kc.lshape_case_res(case, 8))
    u_img, x0, h, nt = kc.lshape_primal_case(case, 8)
    _, _, failed, _ = _same_steps(ge, u_img, x0, h, nt)
    assert bool(failed.any())


# --- the adjoint ODE and the point sources on the new domains ---------------

@pytest.mark.parametrize("case", kc.PIPE_ADJOINT_CASES)
@pytest.mark.parametrize("name", sorted(kc.PIPE_MESHES))
def test_staged_adjoint_equals_plain_on_pipes(name, case):
    mesh, ge = pipe(name)
    g_img, x, resid, vlimit, h = kc.pipe_adjoint_case(case, mesh)
    plain = cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                                 h)
    staged = cuda_adjoint.adjoint_ode_steps_staged(ge, g_img, x, resid,
                                                   vlimit, h)
    assert torch.equal(staged, plain) and bool(plain.isfinite().all())
    inside = in_domain(ge.locator, x)
    assert bool(inside.any()) and not bool(inside.all())


@pytest.mark.parametrize("case", kc.ADJOINT_CASES)
def test_staged_adjoint_equals_plain_on_left_rectangle(case):
    ge = left_rect(kc.ode_case_nx(case, 8))
    g_img, x, resid, vlimit, h = kc.adjoint_ode_case(case, 8)
    assert torch.equal(
        cuda_adjoint.adjoint_ode_steps_staged(ge, g_img, x, resid, vlimit, h),
        cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit, h))


@pytest.mark.parametrize("case", kc.PIPE_POINT_CASES)
@pytest.mark.parametrize("name", sorted(kc.PIPE_MESHES))
def test_grouped_point_sources_and_p1_eval_on_pipes(name, case):
    """The warp-grouped limb sums are the plain ones; the ∇u evaluation
    flags the fringe outside."""
    mesh, ge = pipe(name)
    pts, r = kc.pipe_point_case(case, mesh)
    want = cuda_psrc.point_source_limbs_plain(ge, pts, r)
    got = cuda_psrc.point_source_limbs_grouped(ge, pts, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    Gy, Gx = ge.vg_shape
    g_img = torch.as_tensor(np.random.default_rng(83).standard_normal(
        (Gy * Gx, 2, 2)))
    _, inside = eval_p1_tensor_grid(ge, g_img, pts)
    assert bool(inside.any()) and not bool(inside.all())


def test_grouped_point_sources_on_left_diagonal():
    ge = left_rect(8)
    for case in ("random", "nodes_and_diagonal", "trajectories"):
        pts, r = kc.point_source_case(case, 8)
        pts = torch.cat([pts, torch.as_tensor(kc.anti_diagonal_points(8))])
        r = torch.cat([r, torch.full((len(pts) - len(r), 2), 0.5,
                                     dtype=torch.float64)])
        want = cuda_psrc.point_source_limbs_plain(ge, pts, r)
        got = cuda_psrc.point_source_limbs_grouped(ge, pts, r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
