"""ocean_torch parity: kernel 4's plain version (P1 ∇u evaluation on the
vertex grid) and the parallel-prefix / consistent adjoint ODE, against
ocean_jax.

Tolerances:
* ∇u evaluation vs ``ocean_jax.fem.interpolate.eval_p1_tensor``: 1e-12,
  the same P1 interpolation through the cell tables instead of the
  half-grid stencil (rounding only);
* vs ``eval_p1_tensor_pallas`` in interpret mode (eager, as
  tests/test_pallas_eval.py runs it): 2e-6, the JAX package's own CPU
  bar (XLA:CPU can drop the kernel's double-single error words);
* μ, port "parallel" vs JAX "parallel" and port consistent vs JAX
  consistent: 1e-12, the same linear recursion in float64 with scans of
  another tree shape;
* port "parallel" vs port "scan": 1e-14, the bar of
  tests/test_ode.py::test_parallel_adjoint_matches_sequential, on its
  case (out-of-domain points and a masked buoy).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem.spaces import make_space as jax_make_space
from ocean_jax.fem.interpolate import eval_p1_tensor as jax_eval_p1
from ocean_jax.ode import (solve_adjoint_ode as jax_adjoint,
                           solve_adjoint_ode_consistent as jax_consistent)
from ocean_jax.ode.grideval import (make_grideval as jax_make_grideval,
                                    grad_to_grid as jax_grad_to_grid)
from ocean_jax.ode.pallas_eval import eval_p1_tensor_pallas

from ocean_torch import kernels
from ocean_torch.mesh import structured
from ocean_torch.fem.spaces import make_space
from ocean_torch.ode import (solve_adjoint_ode, solve_adjoint_ode_consistent,
                             eval_p1_tensor_cuda)
from ocean_torch.ode.grideval import (make_grideval, grad_to_grid,
                                      eval_p1_tensor_grid)

H = 0.005


@pytest.fixture(scope="module")
def spaces():
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    return jax_make_space(mj), make_space(mt, "cpu")


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.3, 2.3, (256, 2))    # some lanes out of domain
    pts[:4] = [[0.0, 2.0], [2.0 + 1e-13, 1.0], [1.0, -2e-12], [2.0, 2.0]]
    return pts


def _d(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_eval_matches_jax_tables(spaces, points):
    sj, st = spaces
    g = np.random.default_rng(2).standard_normal((st.n_p1, 2, 2))
    ref, ins_ref = jax_eval_p1(sj, jnp.asarray(g), jnp.asarray(points))
    before = kernels.launch_counts()
    val, ins = eval_p1_tensor_cuda(make_grideval(st),
                                   grad_to_grid(make_grideval(st),
                                                torch.as_tensor(g)),
                                   torch.as_tensor(points))
    assert kernels.launch_counts() == before     # CPU: the plain version
    assert np.array_equal(ins.numpy(), np.asarray(ins_ref))
    assert not bool(ins.all())
    assert _d(val, ref) < 1e-12


def test_eval_matches_jax_pallas_interpret(spaces, points):
    sj, st = spaces
    g = np.random.default_rng(3).standard_normal((st.n_p1, 2, 2))
    gej = jax_make_grideval(sj)
    val_j, ins_j = eval_p1_tensor_pallas(
        gej, jax_grad_to_grid(gej, jnp.asarray(g)),
        jnp.asarray(points.reshape(16, 16, 2)), interpret=True)
    ge = make_grideval(st)
    val, ins = eval_p1_tensor_cuda(ge, grad_to_grid(ge, torch.as_tensor(g)),
                                   torch.as_tensor(points.reshape(16, 16, 2)))
    assert val.shape == (16, 16, 2, 2) and ins.shape == (16, 16)
    assert np.array_equal(ins.numpy(), np.asarray(ins_j))
    assert _d(val, val_j) < 2e-6
    ref, _ = eval_p1_tensor_grid(ge, grad_to_grid(ge, torch.as_tensor(g)),
                                 torch.as_tensor(points.reshape(16, 16, 2)))
    assert torch.equal(val, ref)


@pytest.fixture(scope="module")
def traj(spaces):
    """K=16 trajectories at nt=60 with out-of-domain points (the
    reuse-previous ∇u carry, also at the last step), one buoy on the
    slack, a masked buoy, and escape steps for the consistent window."""
    _, st = spaces
    rng = np.random.default_rng(3)
    K, nt = 16, 60
    x = rng.uniform(0.0, 2.0, (K, nt, 2))
    out = rng.random((K, nt)) < 0.3
    x[..., 0] = np.where(out, 2.5 + rng.random((K, nt)), x[..., 0])
    x[1] = 2.0 + 1e-13
    x[2, 5:, 1] = -2e-12
    x[3, -1] = [5.0, 5.0]
    uv = 0.1 * rng.standard_normal((K, nt, 2))
    ud = 0.1 * rng.standard_normal((K, nt, 2))
    mask = np.zeros(K, bool)
    mask[[0, 4, 7]] = True
    kfail = np.full(K, nt, np.int32)
    kfail[[0, 4, 7]] = [1, 30, nt - 1]
    g = rng.standard_normal((st.n_p1, 2, 2))
    return g, x, uv, ud, mask, kfail


def test_parallel_matches_jax_parallel(spaces, traj):
    sj, st = spaces
    g, x, uv, ud, mask, _ = traj
    mu_j = jax.jit(lambda *a: jax_adjoint(sj, *a, H, method="parallel"))(
        *(jnp.asarray(a) for a in (g, x, uv, ud, mask)))
    args = tuple(torch.as_tensor(a) for a in (g, x, uv, ud, mask))
    mu_t = solve_adjoint_ode(st, *args, H)
    mu_g = solve_adjoint_ode(st, *args, H, grid=make_grideval(st))
    assert _d(mu_t, mu_j) < 1e-12 and _d(mu_g, mu_j) < 1e-12
    assert float(mu_t[0].abs().max()) == 0.0


def test_parallel_matches_scan():
    """tests/test_ode.py::test_parallel_adjoint_matches_sequential's case."""
    st = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 4, 4),
                    "cpu")
    rng = np.random.default_rng(3)
    K, nt, h = 5, 30, 0.01
    g = torch.as_tensor(rng.standard_normal((st.n_p1, 2, 2)) * 0.3)
    x = 0.3 + 1.4 * rng.random((K, nt, 2))
    x[2, 10] = x[2, 11] = [5.0, 5.0]
    x = torch.as_tensor(x)
    uv = torch.as_tensor(rng.standard_normal((K, nt, 2)))
    ud = torch.as_tensor(rng.standard_normal((K, nt, 2)))
    mask = torch.tensor([False, True, False, False, False])
    mu_seq = solve_adjoint_ode(st, g, x, uv, ud, mask, h, method="scan")
    mu_par = solve_adjoint_ode(st, g, x, uv, ud, mask, h, method="parallel")
    assert float((mu_seq - mu_par).abs().max()) < 1e-14
    with pytest.raises(ValueError):
        solve_adjoint_ode(st, g, x, uv, ud, mask, h, method="bogus")


@pytest.mark.parametrize("with_grid", [False, True])
def test_consistent_matches_jax(spaces, traj, with_grid):
    sj, st = spaces
    g, x, uv, ud, mask, kfail = traj
    mu_j = jax.jit(lambda *a: jax_consistent(sj, *a, H))(
        *(jnp.asarray(a) for a in (g, x, uv, ud, mask, kfail)))
    mu_t = solve_adjoint_ode_consistent(
        st, *(torch.as_tensor(a) for a in (g, x, uv, ud, mask, kfail)), H,
        grid=make_grideval(st) if with_grid else None)
    assert _d(mu_t, mu_j) < 1e-12
    # zero past each escaped buoy's window t <= kfail-1
    assert float(mu_t[0].abs().max()) == 0.0
    assert float(mu_t[4, 29:].abs().max()) == 0.0
    assert float(mu_t[4, :29].abs().max()) > 0.0
