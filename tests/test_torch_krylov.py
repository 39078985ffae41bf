"""The port's matrix-free Krylov pieces (``ocean_torch/solve/krylov.py``)
against ``ocean_jax/solve/krylov.py`` and the dense solves, on the same
numpy inputs (mirrors ``tests/test_krylov.py``).

Tolerances: FGMRES against the dense Stokes solve at Nx=8, 1e-8 (the
JAX test's bound); float64 FGMRES on an SPD system, the same cycle count
as JAX's and the solution within 1e-10 of it; the operator diagonal and
the lumped pressure mass, 1e-13 relative (one reduction order apart).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.fem import assemble as jax_assemble
from ocean_jax.pipelines import stokes_gradcheck as jax_sg
from ocean_jax.solve import krylov as jax_krylov

from ocean_torch.fem import assemble
from ocean_torch.pipelines import stokes_gradcheck as sg
from ocean_torch.solve import krylov

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def stokes8():
    return sg.build(nx=8, device="cpu"), jax_sg.build(nx=8)


def test_fgmres_matches_dense_on_stokes(stokes8):
    prob, pj = stokes8
    f = sg.default_control(prob)
    w_direct = sg.solve_state(prob, f.quad)
    b = assemble.boundary_load(prob.space, prob.bq, f.quad)
    res = krylov.solve_operator_krylov(
        prob.op, b, prob.bc_vals, space=prob.space, nu=1.0,
        tol=1e-12, restart=150, max_restarts=20)
    assert res.converged, res.residual_norm
    err = float((res.x - w_direct).abs().max())
    assert err < 1e-8, err
    fj = jax_sg.default_control(pj)
    rj = jax_krylov.solve_operator_krylov(
        pj.op, jax_assemble.boundary_load(pj.space, pj.bq, fj.quad),
        pj.bc_vals, space=pj.space, nu=1.0, tol=1e-12, restart=150,
        max_restarts=20)
    assert bool(rj.converged)
    assert float(np.abs(res.x.numpy() - np.asarray(rj.x)).max()) < 1e-8


def test_fgmres_on_spd_system_matches_jax():
    rng = np.random.default_rng(0)
    n = 120
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    b = rng.standard_normal(n)
    at = torch.as_tensor(a)
    res = krylov.fgmres(lambda x: at @ x, torch.as_tensor(b), restart=40,
                        max_restarts=10, tol=1e-12)
    assert res.converged
    assert np.allclose(res.x.numpy(), np.linalg.solve(a, b), atol=1e-8)
    rj = jax_krylov.fgmres(lambda x: jnp.asarray(a) @ x, jnp.asarray(b),
                           restart=40, max_restarts=10, tol=1e-12)
    assert res.iterations == int(rj.iterations)
    assert float(np.abs(res.x.numpy() - np.asarray(rj.x)).max()) < 1e-10


def test_fgmres_keeps_the_better_iterate_and_counts_cycles():
    """A cycle whose update does not lower the residual is dropped, and
    the cycle count stops at ``max_restarts`` (as in JAX)."""
    rng = np.random.default_rng(3)
    n = 50
    a = rng.standard_normal((n, n)) + 3 * np.eye(n)
    b = rng.standard_normal(n)
    at = torch.as_tensor(a)
    res = krylov.fgmres(lambda x: at @ x, torch.as_tensor(b), restart=3,
                        max_restarts=2, tol=1e-14)
    rj = jax_krylov.fgmres(lambda x: jnp.asarray(a) @ x, jnp.asarray(b),
                           restart=3, max_restarts=2, tol=1e-14)
    assert res.iterations == int(rj.iterations) == 2
    assert not res.converged and not bool(rj.converged)
    assert abs(res.residual_norm - float(rj.residual_norm)) < 1e-10
    assert res.residual_norm == pytest.approx(
        float(np.linalg.norm(b - a @ res.x.numpy())), rel=1e-12)


def test_diagonal_and_lumped_mass_match_jax(stokes8):
    prob, pj = stokes8
    rng = np.random.default_rng(4)
    w = 0.3 * rng.standard_normal(prob.space.ndof)
    op = assemble.ns_operator(prob.space, prob.bq, torch.as_tensor(w), 1.0,
                              prob.bc_dofs)
    oj = jax_assemble.ns_operator(pj.space, pj.bq, jnp.asarray(w), 1.0,
                                  pj.bc_dofs)
    assert _rel(krylov.operator_diagonal(op),
                jax_krylov.operator_diagonal(oj)) < 1e-13
    assert _rel(krylov.pressure_mass_lumped(prob.space, 0.1),
                jax_krylov.pressure_mass_lumped(pj.space, 0.1)) < 1e-13
    x = rng.standard_normal(prob.space.ndof)
    pm = krylov.pressure_mass_lumped(prob.space)
    got = krylov.jacobi_preconditioner(op, pm)(torch.as_tensor(x))
    want = jax_krylov.jacobi_preconditioner(
        oj, jax_krylov.pressure_mass_lumped(pj.space))(jnp.asarray(x))
    assert _rel(got, want) < 1e-13
