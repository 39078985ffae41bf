"""ocean_torch parity: the consistent adjoint mode (``adjoint_mode=
"consistent"``) with the point-source methods of the second slice, and
one GD step of that slice's configuration, against ocean_jax.

Tolerances:
* consistent adjoint RHS b vs JAX's consistent "scatter" on the same
  forward state: 1e-12·max|b| (float64 sums of the same terms in other
  orders; the fused and Ozaki paths sum exactly);
* without escapes the consistent RHS equals the reference RHS bit for
  bit, as in tests/test_consistent_adjoint.py;
* the GD step: J within 1e-10 relative, f_new and z within 1e-8 relative,
  for the reason stated in tests/test_torch_system.py (float64 LU in the
  port against JAX's float32 explicit inverse with refinement). The JAX
  side runs its float64 XLA paths (``ode_backend="gather"``,
  ``psrc_method="ozaki"``): in interpret mode its Pallas kernels are
  compile-variant and can drop to float32 level
  (tests/test_pallas_eval.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import control as jax_control
from ocean_jax import system as jax_system
from ocean_jax.pipelines.ud_construction import seed_positions

from ocean_torch import convert, system
from ocean_torch.config import OCPConfig

ESCAPE = dict(unit_square_resolution=8, ud_experiment="8_buoys", T=0.25,
              dt=0.005, adjoint_mode="consistent")


@pytest.fixture(scope="module")
def escape():
    """tests/test_consistent_adjoint.py's escape setup: K=8 seeds biased
    to the right boundary; the outflow control [3, 0] ejects one."""
    rng = np.random.default_rng(3)
    u_d = 0.05 * rng.standard_normal((8, 50, 2))
    x0 = np.column_stack([1.2 + 0.7 * rng.random(8),
                          0.3 + 1.4 * rng.random(8)])
    pj = jax_system.build_problem(JaxConfig(**ESCAPE), u_d=u_d, x0=x0)
    fj = jax_control.constant(pj.space, pj.bq, [3.0, 0.0])
    fwd_j = jax_system.forward(pj, fj.quad)

    def rhs(w, x, uv, m, xr, kf):
        return jax_system.adjoint_rhs(
            pj, jax_system.ForwardState(w, x, uv, m, None, xr, kf))

    # jitted: run eagerly, the consistent RHS (parallel adjoint) takes ~17 s
    b_j = np.asarray(jax.jit(rhs)(fwd_j.w, fwd_j.x, fwd_j.u_values,
                                  fwd_j.mask, fwd_j.x_raw, fwd_j.kfail))
    pt = system.build_problem(OCPConfig(ode_backend="pallas", **ESCAPE),
                              u_d=u_d, x0=x0, device="cpu")
    t = convert.to_tensor
    fwd_t = system.ForwardState(
        t(fwd_j.w), t(fwd_j.x), t(fwd_j.u_values),
        t(fwd_j.mask, dtype=torch.bool), None, t(fwd_j.x_raw),
        t(fwd_j.kfail, dtype=torch.int32))
    return pt, fwd_t, fwd_j, b_j, convert.control(fj.quad, fj.p2)


def test_forward_escapes_match_jax(escape):
    pt, _, fwd_j, _, f = escape
    for backend in ("gather", "pallas"):
        fwd = system.forward(dataclasses.replace(pt, ode_backend=backend),
                              f.quad)
        assert fwd.mask.numpy().tolist() == np.asarray(fwd_j.mask).tolist()
        assert fwd.kfail.numpy().tolist() == np.asarray(fwd_j.kfail).tolist()
        assert float((fwd.x_raw - torch.as_tensor(np.asarray(fwd_j.x_raw)))
                     .abs().max()) < 1e-12
    assert bool(fwd.mask.any())


@pytest.mark.parametrize("backend,method", [
    ("gather", "scatter"), ("gather", "ozaki"), ("pallas", "ozaki_pallas"),
    ("pallas", "fused")])
def test_consistent_rhs_matches_jax(escape, backend, method):
    pt, fwd_t, _, b_j, _ = escape
    p = dataclasses.replace(pt, ode_backend=backend, psrc_method=method)
    b_t = system.adjoint_rhs(p, fwd_t).numpy()
    assert np.abs(b_t - b_j).max() <= 1e-12 * np.abs(b_j).max()


@pytest.mark.parametrize("backend,method", [
    ("gather", "scatter"), ("pallas", "ozaki_pallas"), ("pallas", "fused")])
def test_consistent_equals_reference_without_escapes(backend, method):
    rng = np.random.default_rng(0)
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment="4_buoys",
                    T=0.05, dt=0.005, ode_backend=backend,
                    psrc_method=method)
    u_d = 0.05 * rng.standard_normal((4, cfg.num_time_steps, 2))
    x0 = 0.3 + 1.4 * rng.random((4, 2))
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    fwd = system.forward(prob, system.initial_control(prob, 0).quad)
    assert not bool(fwd.mask.any())
    b_ref = system.adjoint_rhs(prob, fwd)
    b_con = system.adjoint_rhs(
        dataclasses.replace(prob, adjoint_mode="consistent"), fwd)
    assert torch.equal(b_ref, b_con)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_gd_step_consistent_ozaki_matches_jax():
    """The second slice's configuration cut to Nx=8, K=100 (port on the
    CPU, so kernels 1, 2 and 5 run as their plain versions). At K=100 the
    outflow control [3, 0] ejects no buoy; [4, 0] ejects 41 of 100, so
    the consistent windows are exercised."""
    rng = np.random.default_rng(7)
    x0 = seed_positions(100)
    u_d = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    u_d[..., 1] -= 0.1
    common = dict(ud_experiment="100_buoys", unit_square_resolution=8,
                  use_line_search=False, num_steps=1,
                  adjoint_mode="consistent", newton_reuse_lu=True)
    pj = jax_system.build_problem(
        JaxConfig(dense_apply="inverse", ode_backend="gather",
                  psrc_method="ozaki", **common), u_d=u_d, x0=x0)
    fj = jax_control.constant(pj.space, pj.bq, [4.0, 0.0])
    rj = jax_system.gd_step(pj, fj, jnp.asarray(5.0), use_line_search=False)
    pt = system.build_problem(
        OCPConfig(ode_backend="pallas", psrc_method="ozaki_pallas",
                  **common), u_d=u_d, x0=x0, device="cpu")
    rt = system.gd_step(pt, convert.control(fj.quad, fj.p2), 5.0)
    assert np.array_equal(rt.fwd.mask.numpy(), np.asarray(rj.fwd.mask))
    assert 0 < int(rt.fwd.mask.sum()) < 100
    assert not rt.diverged and not bool(rj.diverged)
    assert rt.fwd.newton.converged
    assert abs(float(rt.J) - float(rj.J)) / abs(float(rj.J)) < 1e-10
    assert _rel(rt.f_new.quad, rj.f_new.quad) < 1e-8
    assert _rel(rt.f_new.p2, rj.f_new.p2) < 1e-8
    assert _rel(rt.z, rj.z) < 1e-8
