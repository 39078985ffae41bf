"""The three CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped where there is no CUDA device). Run them
on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: the kernels are compiled without FMA contraction and
evaluate every double operation in the plain version's order, so
trajectories, escape flags and μ are expected bit-identical; the bound
asserted is 1e-12 absolute (failed/kfail exactly equal). The point-source
limbs are integer sums: identical across launches and to the plain
version.
"""

import numpy as np
import pytest
import torch

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
    assert float((xk - xp).abs().max()) < 1e-12
    assert float((uk - up).abs().max()) < 1e-12


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
    assert float((mk - mp).abs().max()) < 1e-12


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


def test_wrappers_reject_mixed_devices(dev, grid):
    st, ge = grid
    u_img = torch.zeros(ge.hg_shape[0] * ge.hg_shape[1], 2,
                        dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        primal_ode_steps(ge, u_img, torch.zeros(4, 2, dtype=torch.float64),
                         0.005, 10)
