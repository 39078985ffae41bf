"""ocean_torch parity: the primal buoy ODE (kernel 1's plain version and
the table path) against ocean_jax, with escaping buoys, nt=200.

Tolerances:
* 1e-12 absolute on x and u_values against ``ocean_jax`` float64
  ``solve_primal_ode``: both integrate the same float64 recursion; the
  port's kernel twin evaluates through the half-grid stencil instead of
  the cell tables, which differs by reassociation only (~1e-16 per step,
  ~1e-14 after 199 steps). failed/kfail must be equal.
* against ``solve_primal_ode_pallas`` in interpret mode: 1e-9, the bound
  the JAX package itself holds its interpreted double-single kernel to on
  the CPU (tests/test_ode_backends.py); the compiled TPU kernel is
  ~1e-12, but XLA:CPU may degrade the error-free transforms.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem.spaces import make_space as jax_make_space
from ocean_jax.ode.primal import solve_primal_ode as jax_primal
from ocean_jax.ode.grideval import make_grideval as jax_make_grideval
from ocean_jax.ode.pallas_ode import solve_primal_ode_pallas

from ocean_torch import kernels
from ocean_torch.mesh import structured
from ocean_torch.fem.spaces import make_space
from ocean_torch.ode import solve_primal_ode, solve_primal_ode_cuda
from ocean_torch.ode.grideval import (make_grideval, velocity_to_grid,
                                      eval_velocity_grid)
from ocean_torch.fem.interpolate import eval_velocity
from ocean_torch.ode.cuda_ode import primal_ode_steps

K, NT, H = 48, 200, 0.005


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    sj, st = jax_make_space(mj), make_space(mt, "cpu")
    u = 0.9 * rng.standard_normal((st.n_p2, 2))
    x0 = rng.uniform(0.05, 1.95, (K, 2))
    center = np.array([1.0, 1.0])
    ref = jax_primal(sj, jnp.asarray(u), jnp.asarray(x0), H, NT,
                     jnp.asarray(center))
    assert 0 < int(ref.mask.sum()) < K       # escapes exercised
    return dict(sj=sj, st=st, u=u, x0=x0, center=center, ref=ref)


def _check(res, ref, tol):
    assert np.array_equal(res.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(res.kfail.numpy(), np.asarray(ref.kfail))
    for name in ("x", "u_values", "x_raw"):
        d = np.abs(getattr(res, name).numpy()
                   - np.asarray(getattr(ref, name))).max()
        assert d < tol, (name, d)


def test_table_path_matches_jax(case):
    res = solve_primal_ode(case["st"], torch.as_tensor(case["u"]),
                           torch.as_tensor(case["x0"]), H, NT,
                           torch.as_tensor(case["center"]))
    _check(res, case["ref"], 1e-12)


def test_kernel_twin_matches_jax(case):
    before = kernels.launch_counts()
    ge = make_grideval(case["st"])
    res = solve_primal_ode_cuda(ge, torch.as_tensor(case["u"]),
                                torch.as_tensor(case["x0"]), H, NT,
                                torch.as_tensor(case["center"]))
    _check(res, case["ref"], 1e-12)
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launch_counts() == before


def test_kernel_twin_matches_jax_pallas_interpret(case):
    sj = case["sj"]
    pal = solve_primal_ode_pallas(sj, jax_make_grideval(sj),
                                  jnp.asarray(case["u"]),
                                  jnp.asarray(case["x0"]), H, NT,
                                  jnp.asarray(case["center"]),
                                  interpret=True)
    ge = make_grideval(case["st"])
    res = solve_primal_ode_cuda(ge, torch.as_tensor(case["u"]),
                                torch.as_tensor(case["x0"]), H, NT,
                                torch.as_tensor(case["center"]))
    _check(res, pal, 1e-9)


def test_grid_eval_matches_tables(case):
    """The half-grid stencil the kernels read equals the table evaluation
    (inside points), and agrees on the inside flag everywhere."""
    st = case["st"]
    ge = make_grideval(st)
    u = torch.as_tensor(case["u"])
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-0.2, 2.2,
                                                           (2000, 2)))
    v1, in1 = eval_velocity(st, u, pts)
    v2, in2 = eval_velocity_grid(ge, velocity_to_grid(ge, u), pts)
    assert torch.equal(in1, in2)
    assert float((v1 - v2)[in1].abs().max()) < 1e-12


def test_last_step_escape_not_masked(case):
    """A buoy whose only failing evaluation is the final one is recentred
    in its last slot with u = 0 and is NOT masked."""
    st = case["st"]
    ge = make_grideval(st)
    u = torch.zeros(st.n_p2, 2, dtype=torch.float64)
    u[:, 0] = 1.0                              # uniform flow to +x
    nt = 20
    x_start = 2.0 - (nt - 1) * H + 1e-9        # only x[nt-1] is outside
    x0 = torch.tensor([[x_start, 0.7], [0.5, 0.5]], dtype=torch.float64)
    center = torch.tensor([1.0, 1.0], dtype=torch.float64)
    for res in (solve_primal_ode_cuda(ge, u, x0, H, nt, center),
                solve_primal_ode(st, u, x0, H, nt, center)):
        assert not bool(res.mask.any())
        assert torch.equal(res.x[0, -1], center)
        assert float(res.u_values[0, -1].abs().max()) == 0.0
        assert int(res.kfail[0]) == nt


def test_wrapper_shapes(case):
    st = case["st"]
    ge = make_grideval(st)
    u_img = velocity_to_grid(ge, torch.as_tensor(case["u"]))
    x, us, failed, kfail = primal_ode_steps(
        ge, u_img, torch.as_tensor(case["x0"]), H, NT)
    assert x.shape == (K, NT, 2) and us.shape == (K, NT, 2)
    assert failed.dtype == torch.bool and kfail.dtype == torch.int32
    assert float(us[:, -1].abs().max()) == 0.0
