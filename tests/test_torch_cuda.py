"""The five CUDA kernels against their plain PyTorch versions, on the
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
"""

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
