"""ocean_torch parity: the adjoint buoy ODE (kernel 2's plain version and
the table path) against ocean_jax at nt=200, with out-of-domain points
(the reuse-previous-∇u carry), a masked buoy and consistent-mode windows.

Tolerances:
* 1e-12 absolute against ``ocean_jax`` float64 ``solve_adjoint_ode``:
  the same linear recursion in float64; JAX runs it as an associative
  scan and through the cell tables, the port sequentially through the
  half-grid stencil, which differ by reassociation only.
* against ``solve_adjoint_ode_pallas`` in interpret mode: 2e-6, the bound
  the JAX package holds its interpreted double-single kernel to on the
  CPU (tests/test_pallas_adjoint.py: XLA:CPU can drop the error words).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem.spaces import make_space as jax_make_space
from ocean_jax.ode import solve_adjoint_ode as jax_adjoint
from ocean_jax.ode.adjoint import _adjoint_ode_parallel
from ocean_jax.ode.grideval import make_grideval as jax_make_grideval
from ocean_jax.ode.pallas_adjoint import solve_adjoint_ode_pallas

from ocean_torch import kernels
from ocean_torch.mesh import structured
from ocean_torch.fem.spaces import make_space
from ocean_torch.ode import solve_adjoint_ode, solve_adjoint_ode_cuda
from ocean_torch.ode.grideval import make_grideval

K, NT, H = 32, 200, 0.005


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    sj, st = jax_make_space(mj), make_space(mt, "cpu")
    x = rng.uniform(0.0, 2.0, (K, NT, 2))
    out = rng.random((K, NT)) < 0.3
    x[..., 0] = np.where(out, 2.5 + rng.random((K, NT)), x[..., 0])
    x[1, :, :] = 2.0 + 1e-13          # on the slack: inside everywhere
    x[2, 5:, 1] = -2e-12              # just outside from step 5 on
    u_values = 0.1 * rng.standard_normal((K, NT, 2))
    u_d = 0.1 * rng.standard_normal((K, NT, 2))
    mask = np.zeros(K, bool)
    mask[0] = True
    grad_u = rng.standard_normal((st.n_p1, 2, 2))
    arrays = (grad_u, x, u_values, u_d, mask)
    return dict(sj=sj, st=st, np=arrays,
                jx=tuple(jnp.asarray(a) for a in arrays),
                tt=tuple(torch.as_tensor(a) for a in arrays))


def _d(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_table_path_matches_jax(case):
    mu_j = jax_adjoint(case["sj"], *case["jx"], H)
    mu_t = solve_adjoint_ode(case["st"], *case["tt"], H)
    assert _d(mu_t, mu_j) < 1e-12
    assert float(mu_t[0].abs().max()) == 0.0


def test_kernel_twin_matches_jax(case):
    before = kernels.launch_counts()
    mu_j = jax_adjoint(case["sj"], *case["jx"], H)
    mu_t = solve_adjoint_ode_cuda(make_grideval(case["st"]), *case["tt"], H)
    assert _d(mu_t, mu_j) < 1e-12
    assert float(mu_t[0].abs().max()) == 0.0
    assert kernels.launch_counts() == before


def test_kernel_twin_matches_jax_pallas_interpret(case):
    sj = case["sj"]
    mu_p = solve_adjoint_ode_pallas(jax_make_grideval(sj), *case["jx"], H,
                                    interpret=True)
    mu_t = solve_adjoint_ode_cuda(make_grideval(case["st"]), *case["tt"], H)
    assert _d(mu_t, mu_p) < 2e-6


def test_window_matches_jax_consistent_form(case):
    """vlimit gating equals the JAX valid-window form (nt = no limit)."""
    grad_u, x, uv, ud, _ = case["np"]
    vlimit = np.array([3, 7, NT, 0, 120] + [NT] * (K - 5), np.int32)
    valid = np.arange(NT)[None, :] <= vlimit[:, None]
    zeros = np.zeros(K, bool)
    mu_j = _adjoint_ode_parallel(case["sj"], jnp.asarray(grad_u),
                                 jnp.asarray(x), jnp.asarray(uv),
                                 jnp.asarray(ud), jnp.asarray(zeros), H,
                                 valid=jnp.asarray(valid))
    mu_t = solve_adjoint_ode_cuda(make_grideval(case["st"]),
                                  *(torch.as_tensor(a)
                                    for a in (grad_u, x, uv, ud, zeros)),
                                  H, vlimit=torch.as_tensor(vlimit))
    assert _d(mu_t, mu_j) < 1e-12
