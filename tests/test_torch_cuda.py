"""The six CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped where there is no CUDA device). Run them
on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

No tolerance: the kernels are compiled without FMA contraction and
evaluate every double operation in the plain version's order (the primal
ODE leaves out three terms that are ±0), so trajectories, velocities,
escape flags and steps, and μ are bit-identical (``torch.equal``) to the
plain version and between launches, on random inputs and on the ODE hard
inputs of ``tests/torch_kernel_cases.py`` (ragged buoy tiles and time
chunks, buoys leaving at the first, the last or no step, the slack of
every edge and corner, grid lines and the diagonal, every ``vlimit``
window, a spacing that is divided, an image too large for shared
memory). The point-source limbs and the Ozaki slice sums are integer
sums: identical across launches and to the plain version, on random
inputs and on the scatter hard inputs (one square or segment, one per
lane, points on nodes and the diagonal, ragged M, zero and negative
weights, dropped ids, ±scale). The ∇u evaluation is one patch sum per
point in the plain version's order: bit-identical, inside flags included.
The same holds on the "left" diagonal (rectangle and L-shape, points on
the anti-diagonals) and on the pipe meshes (graded lines, the obstacle's
fringe, buoys entering its removed squares at known steps, NaN starts:
there NaN equals NaN, ``torch_kernel_cases.same``), and the plain
location on the card is the CPU's there too. The table-path primal ODE
(``csrc/table_ode.cu``) is held to its plain mirror on the same ODE hard
inputs, read at the P2 dofs, and drives the L-shape's production job.
The chord Newton's CUDA graph (``solve/newton.py::ChordGraph``) gives the
eager chord's w, iterations and residual norms bit for bit, in float64
and float32, on the inverse and on LU factors, and the same J in a
three-iteration Armijo run; one capture serves a problem and its copies.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_kernel_cases as kernel_cases
from ocean_torch import kernels
from ocean_torch.mesh import structured
from ocean_torch.fem.spaces import make_space
from ocean_torch.ode.grideval import (make_grideval, velocity_to_grid,
                                      grad_to_grid)
from ocean_torch.ode.cuda_ode import primal_ode_steps, primal_ode_steps_plain
from ocean_torch.ode.cuda_adjoint import (adjoint_ode_steps,
                                          adjoint_ode_steps_plain)
from ocean_torch.adjoint.cuda_psrc import (point_source_limbs,
                                           point_source_limbs_plain)
from ocean_torch.ode.cuda_eval import eval_p1_tensor_cuda
from ocean_torch.ode.grideval import eval_p1_tensor_grid
from ocean_torch.ops.psum_cuda import ozaki_slice_sums, ozaki_slice_sums_plain
from ocean_torch.ops.scatter import pow2_scale

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def grid(dev):
    st = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 16,
                                              16), dev)
    return st, make_grideval(st)


def test_primal_kernel_matches_plain(dev, grid):
    st, ge = grid
    rng = np.random.default_rng(0)
    u = torch.as_tensor(0.9 * rng.standard_normal((st.n_p2, 2)), device=dev)
    x0 = torch.as_tensor(rng.uniform(0.0, 2.0, (3000, 2)), device=dev)
    u_img = velocity_to_grid(ge, u)
    n0 = kernels.LAUNCHES["primal_ode"]
    xk, uk, fk, kk = primal_ode_steps(ge, u_img, x0, 0.005, 200)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["primal_ode"] == n0 + 1
    xp, up, fp, kp = primal_ode_steps_plain(ge, u_img, x0, 0.005, 200)
    assert bool(fp.any())
    assert torch.equal(fk, fp) and torch.equal(kk, kp)
    assert torch.equal(xk, xp) and torch.equal(uk, up)


def _grid_on(dev, nx):
    return make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), nx, nx), dev))


@pytest.mark.parametrize("case", kernel_cases.PRIMAL_CASES)
def test_primal_kernel_hard_inputs(dev, case):
    ge = _grid_on(dev, kernel_cases.ode_case_nx(case, 16))
    u_img, x0, h, nt = kernel_cases.primal_ode_case(case, 16)
    u_img, x0 = u_img.to(dev), x0.to(dev)
    got = primal_ode_steps(ge, u_img, x0, h, nt)
    again = primal_ode_steps(ge, u_img, x0, h, nt)
    torch.cuda.synchronize()
    plain = primal_ode_steps_plain(ge, u_img, x0, h, nt)
    assert got[0].shape == (len(x0), nt, 2)
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_adjoint_kernel_matches_plain(dev, grid):
    st, ge = grid
    rng = np.random.default_rng(1)
    K, nt = 2000, 200
    g = torch.as_tensor(rng.standard_normal((st.n_p1, 2, 2)), device=dev)
    x = rng.uniform(0.0, 2.0, (K, nt, 2))
    x[..., 0] = np.where(rng.random((K, nt)) < 0.2, 2.5, x[..., 0])
    x = torch.as_tensor(x, device=dev)
    resid = torch.as_tensor(0.1 * rng.standard_normal((K, nt, 2)),
                            device=dev)
    vlimit = torch.as_tensor(rng.integers(0, nt + 1, K), dtype=torch.int32,
                             device=dev)
    g_img = grad_to_grid(ge, g)
    mk = adjoint_ode_steps(ge, g_img, x, resid, vlimit, 0.005)
    torch.cuda.synchronize()
    mp = adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit, 0.005)
    assert torch.equal(mk, mp)


@pytest.mark.parametrize("case", kernel_cases.ADJOINT_CASES)
def test_adjoint_kernel_hard_inputs(dev, case):
    ge = _grid_on(dev, kernel_cases.ode_case_nx(case, 16))
    g_img, x, resid, vlimit, h = kernel_cases.adjoint_ode_case(case, 16)
    g_img, x, resid, vlimit = (a.to(dev) for a in (g_img, x, resid, vlimit))
    n0 = kernels.LAUNCHES["adjoint_ode"]
    mk = adjoint_ode_steps(ge, g_img, x, resid, vlimit, h)
    mk2 = adjoint_ode_steps(ge, g_img, x, resid, vlimit, h)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adjoint_ode"] == n0 + 2
    mp = adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit, h)
    assert torch.equal(mk, mk2) and torch.equal(mk, mp)


def test_point_source_kernel_matches_plain(dev, grid):
    st, ge = grid
    rng = np.random.default_rng(2)
    M = 200_000
    pts = torch.as_tensor(rng.uniform(-0.1, 2.1, (M, 2)), device=dev)
    r = torch.as_tensor(rng.uniform(-1.0, 1.0, (M, 2)), device=dev)
    r[::7] = 0.0
    hk, lk = point_source_limbs(ge, pts, r)
    hk2, lk2 = point_source_limbs(ge, pts, r)
    torch.cuda.synchronize()
    hp, lp = point_source_limbs_plain(ge, pts, r)
    assert torch.equal(hk, hk2) and torch.equal(lk, lk2)
    assert torch.equal(hk, hp) and torch.equal(lk, lp)


@pytest.mark.parametrize("nx", [16, 64])
@pytest.mark.parametrize("case", kernel_cases.PSRC_CASES)
def test_point_source_kernel_hard_inputs(dev, case, nx):
    ge = make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), nx, nx), dev))
    pts, r = (a.to(dev) for a in kernel_cases.point_source_case(case, nx))
    hk, lk = point_source_limbs(ge, pts, r)
    hk2, lk2 = point_source_limbs(ge, pts, r)
    torch.cuda.synchronize()
    hp, lp = point_source_limbs_plain(ge, pts, r)
    assert torch.equal(hk, hk2) and torch.equal(lk, lk2)
    assert torch.equal(hk, hp) and torch.equal(lk, lp)


def test_p1_eval_kernel_matches_plain(dev, grid):
    st, ge = grid
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.standard_normal((st.n_p1, 2, 2)), device=dev)
    pts = rng.uniform(-0.3, 2.3, (100_000, 2))         # out-of-domain lanes
    pts[:4] = [[0.0, 2.0], [2.0 + 1e-13, 1.0], [1.0, -2e-12], [2.0, 2.0]]
    pts = torch.as_tensor(pts.reshape(1000, 100, 2), device=dev)
    g_img = grad_to_grid(ge, g)
    n0 = kernels.LAUNCHES["p1_eval"]
    vk, ik = eval_p1_tensor_cuda(ge, g_img, pts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["p1_eval"] == n0 + 1
    vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
    assert vk.shape == (1000, 100, 2, 2) and not bool(ik.all())
    assert torch.equal(ik, ip) and torch.equal(vk, vp)


def test_segment_sum_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    M, S = 300_000, 2048
    ids = rng.integers(0, S + 1, M)                     # S: padding bin
    ids[:5000] = 7                                      # a hot segment
    vals = rng.standard_normal((M, 12)) * 10.0 ** rng.integers(-6, 3, (M, 1))
    ids, vals = (torch.as_tensor(a, device=dev) for a in (ids, vals))
    scale = pow2_scale(vals)
    n0 = kernels.LAUNCHES["segment_sum"]
    ak = ozaki_slice_sums(ids, vals, scale, S)
    ak2 = ozaki_slice_sums(ids, vals, scale, S)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segment_sum"] == n0 + 2
    ap = ozaki_slice_sums_plain(ids, vals, scale, S)
    assert torch.equal(ak, ak2) and torch.equal(ak, ap)


@pytest.mark.parametrize("case", kernel_cases.SEG_CASES)
def test_segment_sum_kernel_hard_inputs(dev, case):
    ids, vals, scale, S = kernel_cases.segment_sum_case(case)
    ids, vals, scale = ids.to(dev), vals.to(dev), scale.to(dev)
    ak = ozaki_slice_sums(ids, vals, scale, S)
    ak2 = ozaki_slice_sums(ids, vals, scale, S)
    torch.cuda.synchronize()
    ap = ozaki_slice_sums_plain(ids, vals, scale, S)
    assert ak.shape == (S, 8, vals.shape[1])
    assert torch.equal(ak, ak2) and torch.equal(ak, ap)


def test_plain_location_is_the_cpus(dev):
    """On a grid whose spacing is no power of two (2/12) the plain
    location on the card gives the CPU's squares and local coordinates
    bit for bit: the spacing divides as a tensor, not as a Python scalar
    (which the CUDA division kernel turns into a rounded reciprocal)."""
    from ocean_torch.ode.grideval import grid_coords
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform(-0.1, 2.1, (20_000, 2)))
    on_cpu = grid_coords(_grid_on("cpu", 12).locator, pts)
    on_card = grid_coords(_grid_on(dev, 12).locator, pts.to(dev))
    for a, b in zip(on_cpu, on_card):
        assert torch.equal(a, b.cpu())


def test_wrappers_reject_mixed_devices(dev, grid):
    st, ge = grid
    u_img = torch.zeros(ge.hg_shape[0] * ge.hg_shape[1], 2,
                        dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        primal_ode_steps(ge, u_img, torch.zeros(4, 2, dtype=torch.float64),
                         0.005, 10)
    g_img = torch.zeros(ge.vg_shape[0] * ge.vg_shape[1], 2, 2,
                        dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        eval_p1_tensor_cuda(ge, g_img, torch.zeros(4, 2, dtype=torch.float64))
    vals = torch.zeros(4, 12, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        ozaki_slice_sums(torch.zeros(4, dtype=torch.int64), vals,
                         torch.ones(12, dtype=torch.float64, device=dev), 3)


# --- the L-shape: all five kernels on its hard inputs -----------------------

def _lgrid_on(dev, res):
    st = make_space(structured.l_shape_mesh(res), dev)
    return st, make_grideval(st)


@pytest.mark.parametrize("case", kernel_cases.LSHAPE_PRIMAL_CASES)
def test_primal_kernel_lshape_hard_inputs(dev, case):
    _, ge = _lgrid_on(dev, kernel_cases.lshape_case_res(case, 16))
    u_img, x0, h, nt = kernel_cases.lshape_primal_case(case, 16)
    u_img, x0 = u_img.to(dev), x0.to(dev)
    got = primal_ode_steps(ge, u_img, x0, h, nt)
    plain = primal_ode_steps_plain(ge, u_img, x0, h, nt)
    assert bool(plain[2].any())
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("case", kernel_cases.LSHAPE_ADJOINT_CASES)
def test_adjoint_kernel_lshape_hard_inputs(dev, case):
    _, ge = _lgrid_on(dev, kernel_cases.lshape_case_res(case, 16))
    g_img, x, resid, vlimit, h = (
        a.to(dev) if torch.is_tensor(a) else a
        for a in kernel_cases.lshape_adjoint_case(case, 16))
    assert torch.equal(adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
                       adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                               h))


@pytest.mark.parametrize("res", [16, 64])
@pytest.mark.parametrize("case", kernel_cases.LSHAPE_POINT_CASES)
def test_point_kernels_lshape_hard_inputs(dev, case, res):
    """Point sources, ∇u evaluation and (on the cells these points are
    located in) the segment sum."""
    from ocean_torch.mesh import locate_points
    st, ge = _lgrid_on(dev, res)
    pts, r = (a.to(dev) for a in kernel_cases.lshape_point_case(case, res))
    hk, lk = point_source_limbs(ge, pts, r)
    hp, lp = point_source_limbs_plain(ge, pts, r)
    assert torch.equal(hk, hp) and torch.equal(lk, lp)
    rng = np.random.default_rng(5)
    Gy, Gx = ge.vg_shape
    g_img = torch.as_tensor(rng.standard_normal((Gy * Gx, 2, 2)), device=dev)
    vk, ik = eval_p1_tensor_cuda(ge, g_img, pts)
    vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)
    assert bool(ik.any()) and not bool(ik.all())
    cell, _, _ = locate_points(st.locator, pts)
    vals = torch.as_tensor(rng.standard_normal((pts.shape[0], 12)),
                           device=dev)
    scale = pow2_scale(vals)
    assert torch.equal(ozaki_slice_sums(cell, vals, scale, st.num_cells),
                       ozaki_slice_sums_plain(cell, vals, scale,
                                              st.num_cells))


def test_plain_lshape_location_is_the_cpus(dev):
    """The plain location with the projection gives the same bits on the
    card as on the CPU."""
    from ocean_torch.ode.grideval import grid_coords
    _, ge = _lgrid_on(dev, 12)
    _, ge_cpu = _lgrid_on("cpu", 12)
    pts = torch.cat([kernel_cases.lshape_point_case(c, 12)[0]
                     for c in kernel_cases.LSHAPE_POINT_CASES])
    for a, b in zip(grid_coords(ge.locator, pts.to(dev)),
                    grid_coords(ge_cpu.locator, pts)):
        assert torch.equal(a.cpu(), b)


# --- the "left" diagonal and the pipes: the four grid kernels ---------------

def _pipe_on(dev, name):
    mesh, _ = structured.pipe_mesh(**kernel_cases.PIPE_MESHES[name])
    return mesh, make_grideval(make_space(mesh, dev))


def _left_on(dev, nx):
    return make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), nx, nx, diagonal="left"), dev))


def _primal_same(ge, u_img, x0, h, nt):
    got = primal_ode_steps(ge, u_img, x0, h, nt)
    again = primal_ode_steps(ge, u_img, x0, h, nt)
    torch.cuda.synchronize()
    plain = primal_ode_steps_plain(ge, u_img, x0, h, nt)
    for a, b, c in zip(got, again, plain):
        assert kernel_cases.same(a, b) and kernel_cases.same(a, c)
    return plain


@pytest.mark.parametrize("name,case", kernel_cases.pipe_primal_cases())
def test_primal_kernel_pipe_hard_inputs(dev, name, case):
    mesh, ge = _pipe_on(dev, name)
    u_img, x0, h, nt = kernel_cases.pipe_primal_case(case, mesh)
    _primal_same(ge, u_img.to(dev), x0.to(dev), h, nt)


@pytest.mark.parametrize("name", sorted(kernel_cases.PIPE_MESHES))
@pytest.mark.parametrize("case", kernel_cases.PIPE_ADJOINT_CASES)
def test_adjoint_kernel_pipe_hard_inputs(dev, name, case):
    mesh, ge = _pipe_on(dev, name)
    g_img, x, resid, vlimit, h = (
        a.to(dev) if torch.is_tensor(a) else a
        for a in kernel_cases.pipe_adjoint_case(case, mesh))
    assert torch.equal(adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
                       adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                               h))


@pytest.mark.parametrize("name", sorted(kernel_cases.PIPE_MESHES))
@pytest.mark.parametrize("case", kernel_cases.PIPE_POINT_CASES)
def test_point_kernels_pipe_hard_inputs(dev, name, case):
    """Point sources and ∇u evaluation (with the obstacle's inside flags);
    the ∇u evaluation also at NaN points."""
    mesh, ge = _pipe_on(dev, name)
    pts, r = (a.to(dev) for a in kernel_cases.pipe_point_case(case, mesh))
    hk, lk = point_source_limbs(ge, pts, r)
    hp, lp = point_source_limbs_plain(ge, pts, r)
    assert torch.equal(hk, hp) and torch.equal(lk, lp)
    Gy, Gx = ge.vg_shape
    g_img = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (Gy * Gx, 2, 2)), device=dev)
    pts = torch.cat([pts, torch.tensor([[np.nan, 1.0], [0.2, np.nan],
                                        [np.inf, 0.3]], device=dev,
                                       dtype=torch.float64)])
    vk, ik = eval_p1_tensor_cuda(ge, g_img, pts)
    vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
    assert kernel_cases.same(vk, vp) and torch.equal(ik, ip)


@pytest.mark.parametrize("case", kernel_cases.PRIMAL_CASES
                         + ("anti_diagonal",))
def test_primal_kernel_left_hard_inputs(dev, case):
    if case == "anti_diagonal":
        ge = _left_on(dev, 16)
        u_img, x0, h, nt = kernel_cases.left_primal_case(16)
    else:
        ge = _left_on(dev, kernel_cases.ode_case_nx(case, 16))
        u_img, x0, h, nt = kernel_cases.primal_ode_case(case, 16)
    _primal_same(ge, u_img.to(dev), x0.to(dev), h, nt)


@pytest.mark.parametrize("case", kernel_cases.ADJOINT_CASES)
def test_adjoint_kernel_left_hard_inputs(dev, case):
    ge = _left_on(dev, kernel_cases.ode_case_nx(case, 16))
    g_img, x, resid, vlimit, h = (
        a.to(dev) if torch.is_tensor(a) else a
        for a in kernel_cases.adjoint_ode_case(case, 16))
    assert torch.equal(adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
                       adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                               h))


@pytest.mark.parametrize("case", kernel_cases.PSRC_CASES)
def test_point_kernels_left_hard_inputs(dev, case):
    ge = _left_on(dev, 16)
    pts, r = (a.to(dev) for a in kernel_cases.point_source_case(case, 16))
    pts = torch.cat([pts, torch.as_tensor(
        kernel_cases.anti_diagonal_points(16), device=dev)])
    r = torch.cat([r, torch.full((len(pts) - len(r), 2), 0.5,
                                 dtype=torch.float64, device=dev)])
    hk, lk = point_source_limbs(ge, pts, r)
    hp, lp = point_source_limbs_plain(ge, pts, r)
    assert torch.equal(hk, hp) and torch.equal(lk, lp)
    Gy, Gx = ge.vg_shape
    g_img = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (Gy * Gx, 2, 2)), device=dev)
    vk, ik = eval_p1_tensor_cuda(ge, g_img, pts)
    vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.parametrize("case", kernel_cases.LSHAPE_PRIMAL_CASES)
def test_primal_kernel_left_lshape_hard_inputs(dev, case):
    ge = make_grideval(make_space(structured.l_shape_mesh(
        kernel_cases.lshape_case_res(case, 16), diagonal="left"), dev))
    u_img, x0, h, nt = kernel_cases.lshape_primal_case(case, 16)
    plain = _primal_same(ge, u_img.to(dev), x0.to(dev), h, nt)
    assert bool(plain[2].any())


def test_graded_pipe_primal_from_device_memory(dev):
    """The gmsh-default graded pipe (73 squares an axis): the image does
    not fit in shared memory, the kernel reads it from device memory."""
    from ocean_torch.ode.cuda_ode import shared_bytes
    mesh, _ = structured.pipe_mesh(obstacle=True, graded=True)
    ge = make_grideval(make_space(mesh, dev))
    Hy, Hx = ge.hg_shape
    assert shared_bytes(ge) < 16 * Hy * Hx
    u_img, x0, h, nt = kernel_cases.pipe_primal_case("random", mesh)
    x0 = torch.cat([x0, torch.as_tensor(kernel_cases.fringe_points(mesh,
                                                                   40))])
    plain = _primal_same(ge, u_img.to(dev), x0.to(dev), h, nt)
    assert bool(plain[2].any())


def test_plain_graded_location_and_obstacle_are_the_cpus(dev):
    """torch.searchsorted, the gathers and the obstacle's ``** 2`` give the
    CPU's squares, local coordinates and inside flags on the card."""
    from ocean_torch.ode.grideval import grid_coords
    from ocean_torch.mesh.locate import in_domain
    for name in ("hole", "hole_graded"):
        mesh, ge = _pipe_on(dev, name)
        _, ge_cpu = _pipe_on("cpu", name)
        pts = torch.cat([kernel_cases.pipe_point_case(c, mesh)[0]
                         for c in kernel_cases.PIPE_POINT_CASES])
        for a, b in zip(grid_coords(ge.locator, pts.to(dev)),
                        grid_coords(ge_cpu.locator, pts)):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(in_domain(ge.locator, pts.to(dev)).cpu(),
                           in_domain(ge_cpu.locator, pts))
    d = torch.as_tensor(np.random.default_rng(8).standard_normal(10 ** 5)
                        * 10.0 ** np.random.default_rng(9).integers(
                            -300, 300, 10 ** 5), device=dev)
    assert torch.equal(d ** 2, d * d)


@pytest.mark.parametrize("case", kernel_cases.LSHAPE_ADJOINT_CASES)
def test_adjoint_kernel_left_lshape_hard_inputs(dev, case):
    ge = make_grideval(make_space(structured.l_shape_mesh(
        kernel_cases.lshape_case_res(case, 16), diagonal="left"), dev))
    g_img, x, resid, vlimit, h = (
        a.to(dev) if torch.is_tensor(a) else a
        for a in kernel_cases.lshape_adjoint_case(case, 16))
    assert torch.equal(adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
                       adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                               h))


@pytest.mark.parametrize("case", kernel_cases.LSHAPE_POINT_CASES)
def test_point_kernels_left_lshape_hard_inputs(dev, case):
    ge = make_grideval(make_space(structured.l_shape_mesh(
        16, diagonal="left"), dev))
    pts, r = (a.to(dev) for a in kernel_cases.lshape_point_case(case, 16))
    hk, lk = point_source_limbs(ge, pts, r)
    hp, lp = point_source_limbs_plain(ge, pts, r)
    assert torch.equal(hk, hp) and torch.equal(lk, lp)
    Gy, Gx = ge.vg_shape
    g_img = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (Gy * Gx, 2, 2)), device=dev)
    vk, ik = eval_p1_tensor_cuda(ge, g_img, pts)
    vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


def _rel(a, b):
    a, b = a.cpu(), b.cpu()
    return float((a - b).abs().max() / b.abs().max())


def test_implicit_adjoint_and_boundary_load_on_card(dev):
    """The implicit adjoint ODE of the NS+ODE gradient check and the Γ₁
    load run in plain PyTorch: the card gives the CPU's values to 1e-12."""
    from ocean_torch.fem import assemble
    from ocean_torch.fem.spaces import make_boundary_quad
    from ocean_torch.ode import solve_adjoint_ode_implicit
    from ocean_torch.solve import GradProjector
    mesh = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    tags = structured.mark_boundary_facets(
        mesh, lambda x: np.abs(x[:, 0]) < 1e-12)
    rng = np.random.default_rng(31)
    K, nt = 64, 200
    u = 0.5 * rng.standard_normal((make_space(mesh, "cpu").n_p2, 2))
    fq = 0.2 * rng.standard_normal(
        tuple(make_boundary_quad(mesh, tags, device="cpu").points.shape))
    x = 0.3 + 1.4 * rng.random((K, 1, 2)) \
        + np.cumsum(0.005 * rng.standard_normal((K, nt, 2)), axis=1)
    x[0, :, 0] = np.linspace(1.8, 2.2, nt)          # leaves through x = 2
    u_d = 0.1 * rng.standard_normal((K, nt, 2))
    out = {}
    for where in ("cpu", "cuda"):
        space = make_space(mesh, where)
        bq = make_boundary_quad(mesh, tags, device=where)
        ut = torch.as_tensor(u, device=where)
        g = GradProjector.build(space).project(space, ut)
        xt, udt = (torch.as_tensor(a, device=where) for a in (x, u_d))
        out[where] = (
            solve_adjoint_ode_implicit(space, g, ut, xt, udt, 0.005),
            solve_adjoint_ode_implicit(space, g, ut, xt, udt, 0.005,
                                       ud_index="k+1"),
            assemble.boundary_load(space, bq,
                                   torch.as_tensor(fq, device=where)))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.device.type == "cuda"
        assert _rel(a, b) < 1e-12


def _small_problem(where, K=2, **kw):
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.ud_construction import seed_positions
    rng = np.random.default_rng(32)
    u_d = 0.05 * rng.standard_normal((K, 200, 2))
    x0 = (seed_positions(K) if K == 100
          else 0.5 + rng.random((K, 2)))
    cfg = OCPConfig(ud_experiment=f"{K}_buoys", unit_square_resolution=8,
                    **kw)
    return system.build_problem(cfg, u_d=u_d, x0=x0, device=where)


def test_differentiable_ns_vjp_on_card(dev):
    from ocean_torch import system
    w_bar = np.random.default_rng(33).standard_normal(
        _small_problem("cpu").space.ndof)
    grads = {}
    for where in ("cpu", "cuda"):
        prob = _small_problem(where)
        fq = system.initial_control(prob, 0).quad.clone().requires_grad_(
            True)
        w = system.make_differentiable_ns_solver(prob)(fq)
        (grads[where],) = torch.autograd.grad(
            w, fq, torch.as_tensor(w_bar, device=where))
    assert _rel(grads["cuda"], grads["cpu"]) < 1e-10


def test_run_ensemble_on_card(dev):
    """The four initial-control cases at Nx=8, K=100 through the kernels
    (fast paths, Armijo) on the card against the plain versions on the
    CPU."""
    from ocean_torch import kernels, system
    from ocean_torch.opt.ensemble import run_ensemble, stack_controls
    res, counts = {}, {}
    for where in ("cpu", "cuda"):
        prob = _small_problem(where, K=100, ode_backend="pallas",
                              psrc_method="fused", newton_reuse_lu=True)
        f0 = stack_controls([system.initial_control(prob, c)
                             for c in range(4)])
        kernels.reset_launch_counts()
        res[where] = run_ensemble(
            prob, f0, torch.tensor([5.0, 5.0, 2.0, 1.0]), num_steps=2,
            use_line_search=True, escape_threshold=50)
        counts[where] = kernels.launch_counts()
    assert counts["cpu"]["adjoint_ode"] == 0
    assert counts["cuda"]["adjoint_ode"] >= 4
    gpu, cpu = res["cuda"], res["cpu"]
    assert torch.equal(gpu.stopped_at, cpu.stopped_at)
    assert torch.equal(gpu.lr_history, cpu.lr_history)
    assert torch.equal(gpu.escaped_history, cpu.escaped_history)
    assert _rel(gpu.j_history, cpu.j_history) < 1e-12


def test_mg_gd_step_on_card(dev):
    """The multigrid path (FGMRES, V-cycle, stencil matvec, CG
    projection) on the card against the CPU at Nx=8: the same Newton
    iteration count, J within 1e-10 and f_new within 1e-8 relative."""
    from ocean_torch import system
    res = {}
    for where in ("cpu", "cuda"):
        prob = _small_problem(where, linear_solver="mg",
                              projector_solver="cg")
        assert prob.mg.matvec == "stencil" and prob.projector.mode == "cg"
        res[where] = system.gd_step(prob, system.initial_control(prob, 0),
                                    5.0, use_line_search=True)
    gpu, cpu = res["cuda"], res["cpu"]
    assert not gpu.diverged and gpu.lr == cpu.lr
    assert gpu.fwd.newton.iterations == cpu.fwd.newton.iterations
    assert abs(float(gpu.J) / float(cpu.J) - 1) < 1e-10
    assert _rel(gpu.f_new.quad, cpu.f_new.quad) < 1e-8


def test_hires_sizes_and_stencil_matvec_on_card(dev):
    """Path 9's sizes on the card: "auto" gives two levels at Nx=64 and
    three with the CG projection at Nx=192; the stencil matvec agrees with
    the element matvec in float64 (1e-12) and float32 (1e-4) there."""
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    from ocean_torch.fem import assemble
    from ocean_torch.ops import stencil
    for nx, depth, projector in ((64, 1, "lu"), (192, 2, "cg")):
        cfg = OCPConfig(ud_experiment="4_buoys", unit_square_resolution=nx,
                        T=0.05, dt=0.005)
        prob = system.build_problem(cfg, u_d=np.zeros((4, 10, 2)),
                                    x0=np.ones((4, 2)), device="cuda")
        ctx, levels = prob.mg, 1
        while ctx.sub is not None:
            ctx, levels = ctx.sub, levels + 1
        assert prob.linear_solver == "mg" and levels == depth
        assert prob.projector.mode == projector and ctx.ainv_c is not None
        op = assemble.ns_operator(
            prob.space, prob.bq, torch.zeros(prob.space.ndof,
                                             dtype=torch.float64,
                                             device="cuda"),
            prob.nu, prob.bc_dofs)
        x = torch.randn(prob.space.ndof, dtype=torch.float64, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(nx))
        ref = op.matvec64(x)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
            y = stencil.matvec_of(prob.mg.st_mixed, dtype)(op)(x)
            assert _rel(y.double(), ref) < tol


def test_continuation_ladder_on_card(dev):
    """The dense ν-ladder at the golden viscosity ν = 0.01 (Nx = 8, 10
    buoys, 6 rungs) on the card against the CPU: Newton iterations within
    one a rung (the last step of a rung may fall either side of the
    test), w within 1e-9·max|w|."""
    from ocean_torch import system
    runs = {}
    for where in ("cpu", "cuda"):
        prob = dataclasses.replace(_small_problem(
            where, K=10, viscosity=0.01, newton_continuation=6),
            solve_log=[])
        res = system.solve_ns(prob, system.initial_control(prob, 0).quad)
        assert res.converged
        runs[where] = (res.w, [r["iterations"] for r in prob.solve_log])
    assert len(runs["cuda"][1]) == len(runs["cpu"][1]) == 8
    assert all(abs(g - c) <= 1 for g, c in zip(runs["cuda"][1],
                                                runs["cpu"][1]))
    assert _rel(runs["cuda"][0], runs["cpu"][0]) < 1e-9


def test_float32_chord_on_card(dev):
    """The float32 chord sweeps and the explicit float32 inverse on the
    card against the CPU at Nx = 8: the same Newton iterations, J within
    1e-9 and f_new within 1e-8 relative."""
    from ocean_torch import system
    for kw in (dict(newton_chord_f32=True),
               dict(newton_chord_f32=True, dense_apply="inverse")):
        steps = {}
        for where in ("cpu", "cuda"):
            prob = _small_problem(where, newton_reuse_lu=True, **kw)
            steps[where] = system.gd_step(
                prob, system.initial_control(prob, 0), 1.0)
        gpu, cpu = steps["cuda"], steps["cpu"]
        assert not gpu.diverged and gpu.fwd.newton.converged
        assert gpu.fwd.newton.iterations == cpu.fwd.newton.iterations
        assert abs(float(gpu.J) / float(cpu.J) - 1) < 1e-9
        assert _rel(gpu.f_new.quad, cpu.f_new.quad) < 1e-8


def test_sync_waits_for_the_card(dev):
    from ocean_torch.utils import Timer, sync
    a = torch.ones(4096, 4096, device=dev)
    with Timer() as t:
        b = [a @ a for _ in range(4)]
        sync({"b": b, "host": torch.ones(2)})
    assert torch.cuda.current_stream(dev).query()
    assert t.elapsed > 0.0


def test_sharded_step_nccl_one_rank(dev):
    """The buoy-sharded step on one nccl rank at the CPU test's size
    (``tests/test_torch_parallel.py``) against ``gd_step`` on the card:
    J within 1e-12 relative, f_new within 1e-12, the same LR and escape
    count."""
    import torch_parallel_cases as cases
    from ocean_torch import system
    from ocean_torch.parallel import launch
    got, = launch.spawn(cases.rank_default_step, 1, "nccl", "cuda")
    prob, f, lr, _ = cases.cases("cuda")["default"]
    ref = system.gd_step(prob, f, lr)
    assert not got["diverged"] and not ref.diverged
    assert abs(got["J"] - float(ref.J)) <= 1e-12 * abs(float(ref.J))
    assert float((got["f_quad"] - ref.f_new.quad.cpu()).abs().max()) <= 1e-12
    assert got["lr"] == ref.lr
    assert got["mask_count"] == float(ref.fwd.mask.sum())


def test_checkpoint_and_space_default_to_the_card(dev, tmp_path):
    """``make_space``, ``make_boundary_quad`` and
    ``torch_ckpt.load_control`` without a device land on the card; a
    control saved from the card comes back equal."""
    from ocean_torch.control import Control
    from ocean_torch.fem.spaces import make_boundary_quad
    from ocean_torch.io import torch_ckpt
    mesh = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 4, 4)
    tags = structured.mark_boundary_facets(
        mesh, lambda x: np.abs(x[:, 0]) < 1e-12)
    space, bq = make_space(mesh), make_boundary_quad(mesh, tags)
    assert space.device.type == bq.points.device.type == "cuda"
    rng = np.random.default_rng(5)
    saved = Control(torch.as_tensor(rng.standard_normal(
        tuple(bq.points.shape)), device=dev),
        torch.as_tensor(rng.standard_normal((space.n_p2, 2)), device=dev))
    path = str(tmp_path / "q.pt")
    torch_ckpt.save_control(path, saved, 0.5, 3)
    for kw in ({}, dict(device=space.device)):
        got, lr, it = torch_ckpt.load_control(path, **kw)
        assert got.quad.device.type == got.p2.device.type == "cuda"
        assert torch.equal(got.quad, saved.quad)
        assert torch.equal(got.p2, saved.p2) and (lr, it) == (0.5, 3)


# --- the table-path primal ODE (csrc/table_ode.cu) --------------------------

def _table_same(space, u_img, x0, h, nt):
    """The kernel against its plain mirror and against a second launch,
    one launch each counted; the half-grid image read at the P2 dofs."""
    from ocean_torch.ode.cuda_table_ode import (table_ode_steps,
                                                table_ode_steps_plain)
    u = u_img.to(space.device)[make_grideval(space).dof_to_node]
    x0 = x0.to(space.device)
    n0 = kernels.LAUNCHES["table_ode"]
    got = table_ode_steps(space, u, x0, h, nt)
    again = table_ode_steps(space, u, x0, h, nt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["table_ode"] == n0 + 2
    plain = table_ode_steps_plain(space, u, x0, h, nt)
    assert got[0].shape == (len(x0), nt, 2)
    for a, b, c in zip(got, again, plain):
        assert kernel_cases.same(a, b) and kernel_cases.same(a, c)
    return plain


def test_table_kernel_matches_plain(dev):
    """The L-shape at resolution 50: its three buoys and 3,000 random
    starts over 200 steps in a random field, and 10⁴ on the rectangle."""
    rng = np.random.default_rng(43)
    for mesh, K in ((structured.l_shape_mesh(50), 3),
                    (structured.l_shape_mesh(50), 3000),
                    (structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 32,
                                               32), 10000)):
        space = make_space(mesh, dev)
        Hy, Hx = make_grideval(space).hg_shape
        u_img = torch.as_tensor(0.9 * rng.standard_normal((Hy * Hx, 2)))
        x0 = (torch.tensor([[0.5, 0.5], [1.0, 0.5], [1.5, 1.0]],
                           dtype=torch.float64) if K == 3 else
              torch.as_tensor(rng.uniform(0.0, 2.0, (K, 2))))
        plain = _table_same(space, u_img, x0, 0.005, 200)
        assert K == 3 or bool(plain[2].any())


@pytest.mark.parametrize("case", kernel_cases.PRIMAL_CASES)
def test_table_kernel_hard_inputs(dev, case):
    nx = kernel_cases.ode_case_nx(case, 16)
    space = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), nx,
                                                 nx), dev)
    _table_same(space, *kernel_cases.primal_ode_case(case, 16))


@pytest.mark.parametrize("diagonal", ["right", "left"])
@pytest.mark.parametrize("case", kernel_cases.LSHAPE_PRIMAL_CASES)
def test_table_kernel_lshape_hard_inputs(dev, case, diagonal):
    space = make_space(structured.l_shape_mesh(
        kernel_cases.lshape_case_res(case, 16), diagonal=diagonal), dev)
    plain = _table_same(space, *kernel_cases.lshape_primal_case(case, 16))
    assert bool(plain[2].any())


@pytest.mark.parametrize("name,case", kernel_cases.pipe_primal_cases())
def test_table_kernel_pipe_hard_inputs(dev, name, case):
    mesh, _ = structured.pipe_mesh(**kernel_cases.PIPE_MESHES[name])
    _table_same(make_space(mesh, dev),
                *kernel_cases.pipe_primal_case(case, mesh))


def test_table_kernel_launches_by_backend(dev):
    """``system._primal_ode`` launches the table kernel once a call on a
    "gather" problem on the card and never on a "pallas" one; the gather
    result is the CPU's to rounding, escapes alike."""
    from ocean_torch import system
    rng = np.random.default_rng(47)
    n_p2 = _small_problem("cpu", K=100).space.n_p2
    u = 0.3 * rng.standard_normal((n_p2, 2)) + np.array([-0.3, 0.1])
    out = {}
    for where in ("cpu", "cuda"):
        prob = _small_problem(where, K=100)
        kernels.reset_launch_counts()
        out[where] = system._primal_ode(prob, torch.as_tensor(u,
                                                              device=where))
        out[where] = system._primal_ode(prob, torch.as_tensor(u,
                                                              device=where))
        assert kernels.LAUNCHES["table_ode"] == (2 if where == "cuda" else 0)
    gpu, cpu = out["cuda"], out["cpu"]
    assert torch.equal(gpu.mask.cpu(), cpu.mask)
    assert torch.equal(gpu.kfail.cpu(), cpu.kfail)
    assert bool(cpu.mask.any()) and not bool(cpu.mask.all())
    assert _rel(gpu.x, cpu.x) < 1e-12
    assert _rel(gpu.u_values, cpu.u_values) < 1e-12
    prob = _small_problem("cuda", K=100, ode_backend="pallas")
    kernels.reset_launch_counts()
    system._primal_ode(prob, torch.as_tensor(u, device=dev))
    assert kernels.LAUNCHES["table_ode"] == 0
    assert kernels.LAUNCHES["primal_ode"] == 1


def test_lshape_job_through_the_table_kernel(dev, tmp_path, monkeypatch):
    """The L-shape production job (``ocp.run``, resolution 50, 3 buoys,
    Armijo from LR 5) on the card: J₀ of the benchmark's seed-0 job
    within 1e-12, one accepted probe an iteration, and the convergence
    exit after 28 iterations; every forward solve through the kernel."""
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines import ocp
    cfg = OCPConfig(L_shape=True, L_shape_resolution=50,
                    ud_experiment="3_buoys", num_steps=30,
                    use_line_search=True, LR=5.0,
                    out_dir=str(tmp_path) + "/")
    from ocean_torch import system
    calls = []
    primal = system._primal_ode
    monkeypatch.setattr(system, "_primal_ode",
                        lambda *a: calls.append(1) or primal(*a))
    kernels.reset_launch_counts()
    res, _ = ocp.run(cfg, verbose=False, device=dev)
    j0 = 0.32335969506496326
    assert abs(res.j_array[0] - j0) <= 1e-12 * j0
    assert res.iterations_run == 28 and res.exit_reason == "converged"
    assert list(res.inner_iterations) == [1] * 28
    assert kernels.LAUNCHES["table_ode"] == len(calls) > 28
    assert kernels.LAUNCHES["primal_ode"] == 0


# --- the chord Newton's CUDA graph (solve/newton.py::ChordGraph) -------------------

def _chord_problem(dev, **kw):
    """The square cell's program (chord Newton on the explicit float32
    inverse, kernels 1-3) at Nx=16, K=400 on a 20 × 20 grid, nt=200."""
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    gx, gy = np.meshgrid(np.linspace(0.1, 0.4, 20), np.linspace(0.25, 1.75, 20))
    x0 = np.stack([gx.ravel(), gy.ravel()], axis=1)
    u_d = 0.05 * np.random.default_rng(22).standard_normal((400, 200, 2))
    kw = dict(dict(newton_reuse_lu=True, dense_apply="inverse",
                   psrc_method="fused", ode_backend="pallas"), **kw)
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=16,
                    num_steps=3, use_line_search=True, LR=5.0, LR_MAX=5.0,
                    **kw)
    return cfg, system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)


def _eager_chord(space, bq, f_quad, nu, w0, bc_dofs, bc_vals, fac0,
                 correction_iters=1, float32=False):
    """``chord_solve``'s numbers by the eager ``newton_solve``, as
    ``system.solve_ns`` calls it off the card."""
    from ocean_torch.fem import assemble
    from ocean_torch.solve import newton
    residual32 = None
    if float32:
        space32 = newton.float32_tables(space)
        bq32 = newton.float32_tables(bq)
        f_quad32 = f_quad.to(torch.float32)

        def residual32(w32):
            return assemble.ns_residual(space32, bq32, w32, f_quad32, nu)
    return newton.newton_solve(
        lambda w: assemble.ns_residual(space, bq, w, f_quad, nu), None, w0,
        bc_dofs, bc_vals, reuse_factorization=True,
        correction_iters=correction_iters, fac0=fac0,
        residual_fn32=residual32)


@pytest.mark.parametrize("float32", [False, True], ids=["f64", "f32"])
def test_the_chord_graph_is_the_eager_chord(dev, float32):
    """Three loads from w = 0 and a warm start: the replayed solve equals
    the eager one bit for bit (w, iterations, residual norm), every step a
    replay, all of them, and ``solve_ns`` on a ``dataclasses.replace``
    copy of the problem, served by one capture; another factor gets a
    capture of its own and the same numbers."""
    from ocean_torch import system
    from ocean_torch.ops import linalg
    from ocean_torch.solve import newton
    from ocean_torch.utils import graphs
    _, prob = _chord_problem(dev, newton_chord_f32=float32)
    assert isinstance(prob.fac0, linalg.InvSolver)
    loads = [system.initial_control(prob, c).quad for c in (0, 4)]
    loads.append(20.0 * system.initial_control(prob, 2).quad)
    zero = torch.zeros(prob.space.ndof, dtype=torch.float64, device=dev)
    args = (prob.bc_dofs, prob.bc_vals, prob.fac0,
            prob.newton_correction_iters)
    starts = [(f, zero) for f in loads]
    served, results = [], []
    for k in range(4):
        f_quad, w0 = (starts[k] if k < 3
                      else (0.9 * loads[2], results[2].w))
        eager = _eager_chord(prob.space, prob.bq, f_quad, prob.nu, w0, *args,
                             float32=float32)
        got = newton.chord_solve(prob.space, prob.bq, f_quad, prob.nu, w0,
                                 *args, float32=float32)
        served.append(graphs.newest("chord", zero.device))
        assert served[-1].graphed
        assert torch.equal(got.w, eager.w)
        assert (got.iterations, got.residual_norm, got.converged) == \
            (eager.iterations, eager.residual_norm, eager.converged)
        assert got.graph_steps == got.iterations >= 1
        results.append(eager)
    assert results[2].iterations >= 3
    copy = dataclasses.replace(prob, solve_log=[])
    res = system.solve_ns(copy, loads[0])
    assert torch.equal(res.w, results[0].w)
    assert copy.solve_log[-1]["graph_steps"] == res.iterations
    assert all(g is served[0] for g in served)
    assert graphs.newest("chord", zero.device) is served[0]
    other = dataclasses.replace(copy, fac0=linalg.InvSolver(
        prob.fac0.ainv.clone(), prob.fac0.ainv_t))
    res = system.solve_ns(other, loads[2])
    assert graphs.newest("chord", zero.device) is not served[0]
    assert torch.equal(res.w, results[2].w)
    assert res.graph_steps == res.iterations == results[2].iterations


@pytest.mark.parametrize("float32", [False, True], ids=["lu64", "lu32"])
def test_the_chord_graph_on_lu_factors(dev, float32):
    """The chord on LU factors (``torch.linalg.lu_solve`` inside the
    graph), float64 and float32: the replayed solve is the eager one."""
    from ocean_torch import system
    from ocean_torch.solve import newton
    _, prob = _chord_problem(dev, newton_chord_f32=float32,
                             dense_apply="lu")
    assert prob.fac0.lu.dtype == (torch.float32 if float32
                                  else torch.float64)
    zero = torch.zeros(prob.space.ndof, dtype=torch.float64, device=dev)
    f_quad = 20.0 * system.initial_control(prob, 2).quad
    args = (prob.space, prob.bq, f_quad, prob.nu, zero, prob.bc_dofs,
            prob.bc_vals, prob.fac0, 1)
    eager = _eager_chord(*args, float32=float32)
    got = newton.chord_solve(*args, float32=float32)
    assert torch.equal(got.w, eager.w)
    assert (got.iterations, got.residual_norm) == (eager.iterations,
                                                   eager.residual_norm)
    assert got.graph_steps == got.iterations >= 3


def test_the_chord_graph_leaves_a_gd_run_bit_for_bit(dev, monkeypatch):
    """Three Armijo iterations with the graph and with the eager chord: J
    of every iteration, the probes and the control equal bit for bit;
    every Newton step of the graphed run a replay."""
    from ocean_torch import system
    from ocean_torch.opt.driver import run_gradient_descent
    cfg, prob = _chord_problem(dev)
    f0 = system.initial_control(prob, 4)
    runs = {}
    for mode in ("graph", "eager"):
        if mode == "eager":
            monkeypatch.setattr(system, "chord_solve", _eager_chord)
        p = dataclasses.replace(prob, solve_log=[])
        runs[mode] = (run_gradient_descent(cfg, p, f0, escape_threshold=10,
                                           verbose=False), p.solve_log)
    (g, g_log), (e, e_log) = runs["graph"], runs["eager"]
    assert g.iterations_run == e.iterations_run == 3
    assert g.j_array == e.j_array
    assert g.inner_iterations == e.inner_iterations
    assert torch.equal(g.f.quad, e.f.quad)
    newton_g = [r for r in g_log if r["solve"] == "ns_newton"]
    assert len(newton_g) >= 4
    assert all(r["graph_steps"] == r["iterations"] for r in newton_g)
    assert all(r["graph_steps"] == 0 for r in e_log
               if r["solve"] == "ns_newton")
    assert [r["iterations"] for r in newton_g] == \
        [r["iterations"] for r in e_log if r["solve"] == "ns_newton"]
