"""The port's float32 dense knobs against its float64 paths and against
ocean_jax (mirrors ``tests/test_chord_f32.py``, whose inputs come from the
absent reference data; here both packages get the same arrays, the
2-buoy measurements synthesized by the port's ``ud_construction`` at
Nx = 12, ν = 1).

* ``newton_chord_f32`` (the chord's correction sweeps in float32 through
  float32 Stokes factors): against the port's float64 chord, w within
  1e-8 and the residual below 1e-8; after one GD step J within 1e-9
  relative and f_new within 1e-8·max(max|f_new|, 1) (the JAX test's
  bounds); against JAX's float32 chord, the same Newton iterations and w
  within 1e-8.
* ``invert32`` against JAX's ``invert32`` on the Stokes operator: both
  are float32 inverses of one matrix, each within cond(A)·u32·max|A⁻¹|
  of the float64 inverse (u32 = 2⁻²⁴, the float32 unit round-off), so
  within twice that of each other.
* ``dense_apply="inverse"`` against "lu": the ∇u projection within
  1e-12·max|∇u| (8 float64 refinement sweeps), one GD step within 1e-12
  relative on J; and that step against JAX's with ``dense_apply=
  "inverse"``, J within 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
from ocean_jax.ops import linalg as jax_linalg

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.fem import assemble
from ocean_torch.ops import linalg
from ocean_torch.pipelines import ud_construction

torch.set_num_threads(2)

BASE = dict(unit_square_resolution=12, ud_experiment="2_buoys",
            viscosity=1.0, newton_reuse_lu=True)


@pytest.fixture(scope="module")
def data():
    r = ud_construction.run(nx=12, K=2, viscosity=1.0, device="cpu")
    return r["u_values"], r["x"][:, 0, :]


def _torch(data, **kw):
    return system.build_problem(OCPConfig(**{**BASE, **kw}), u_d=data[0],
                                x0=data[1], device="cpu")


def _jax(data, **kw):
    return jax_system.build_problem(JaxConfig(**{**BASE, **kw}),
                                    u_d=data[0], x0=data[1])


@pytest.fixture(scope="module")
def problems(data):
    out = {name: _torch(data, **kw) for name, kw in (
        ("f64", {}), ("f32", dict(newton_chord_f32=True)),
        ("inverse", dict(dense_apply="inverse")),
        ("both", dict(dense_apply="inverse", newton_chord_f32=True)))}
    return out, system.initial_control(out["f64"], case=0)


@pytest.fixture(scope="module")
def steps(problems):
    probs, f = problems
    return {name: system.gd_step(p, f, 1.0) for name, p in probs.items()}


def test_factors_follow_the_knobs(problems):
    probs, _ = problems
    assert probs["f64"].fac0.lu.dtype == torch.float64
    assert probs["f32"].fac0.lu.dtype == torch.float32
    for name in ("inverse", "both"):
        inv = probs[name].fac0
        assert isinstance(inv, linalg.InvSolver)
        assert torch.equal(inv.ainv_t, inv.ainv.T)
        assert probs[name].projector.mode == "inverse"
    assert probs["f32"].projector.mode == "lu"


@pytest.mark.parametrize("name", ["f32", "both"])
def test_f32_chord_newton_against_f64(problems, name):
    probs, f = problems
    r64 = system.solve_ns(probs["f64"], f.quad)
    r32 = system.solve_ns(probs[name], f.quad)
    assert r32.converged and r64.converged
    assert r32.residual_norm < 1e-8
    assert float((r32.w - r64.w).abs().max()) < 1e-8


@pytest.mark.parametrize("name", ["f32", "both"])
def test_f32_chord_gd_step_against_f64(steps, name):
    s64, s32 = steps["f64"], steps[name]
    assert not s32.diverged
    dj = abs(float(s32.J) - float(s64.J)) / abs(float(s64.J))
    scale = float(s64.f_new.quad.abs().max())
    dfq = float((s32.f_new.quad - s64.f_new.quad).abs().max())
    assert dj < 1e-9, dj
    assert dfq < 1e-8 * max(scale, 1.0), (dfq, scale)


def test_f32_chord_against_jax(data, problems):
    probs, f = problems
    pj = _jax(data, newton_chord_f32=True)
    rj = jax_system.solve_ns(pj, jax_system.initial_control(pj, 0).quad)
    rt = system.solve_ns(probs["f32"], f.quad)
    assert bool(rj.converged) and rt.converged
    assert rt.iterations == int(rj.iterations)
    assert np.abs(rt.w.numpy() - np.asarray(rj.w)).max() < 1e-8


def test_invert32_against_jax(problems):
    p = problems[0]["f64"]
    a = assemble.ns_operator(p.space, p.bq,
                             torch.zeros(p.space.ndof, dtype=torch.float64),
                             p.nu, p.bc_dofs).dense()
    exact = torch.linalg.inv(a)
    bound = float(torch.linalg.cond(a)) * 2.0 ** -24 * float(
        exact.abs().max())
    inv_t = linalg.invert32(a, chunk=500).ainv
    inv_j = np.asarray(jax_linalg.invert32(jnp.asarray(a.numpy())).ainv)
    assert inv_t.dtype == torch.float32 and inv_j.dtype == np.float32
    assert float((inv_t.double() - exact).abs().max()) < bound
    assert np.abs(inv_j - exact.numpy()).max() < bound
    assert np.abs(inv_t.numpy().astype(np.float64) - inv_j).max() \
        < 2 * bound


def test_inverse_projection_against_lu(problems, steps):
    probs, _ = problems
    u, _ = probs["f64"].space.split(steps["f64"].fwd.w)
    g_lu = probs["f64"].projector.project(probs["f64"].space, u)
    g_inv = probs["inverse"].projector.project(probs["inverse"].space, u)
    assert float((g_inv - g_lu).abs().max()) \
        < 1e-12 * float(g_lu.abs().max())


def test_inverse_gd_step_against_lu_and_jax(data, problems, steps):
    s_lu, s_inv = steps["f64"], steps["inverse"]
    assert not s_inv.diverged
    assert abs(float(s_inv.J) - float(s_lu.J)) < 1e-12 * abs(float(s_lu.J))
    pj = _jax(data, dense_apply="inverse")
    sj = jax_system.gd_step(pj, jax_system.initial_control(pj, 0),
                            jnp.asarray(1.0))
    assert abs(float(s_inv.J) - float(sj.J)) < 1e-12 * abs(float(sj.J))
    assert s_inv.fwd.newton.iterations == int(sj.fwd.newton.iterations)


@pytest.mark.parametrize("fill", [0.0, float("nan")])
def test_singular_factorization_is_non_finite_like_jax(fill):
    """A singular or non-finite operator (the adjoint operator at a
    diverged Newton state) factorizes without raising, as in the JAX
    package, and its solves are non-finite where JAX's are: the caller's
    ``diverged`` flag reports it."""
    a = np.full((4, 4), fill)
    b = np.ones(4)
    fac = linalg.factorize(torch.as_tensor(a), torch.float32)
    fac_j = jax_linalg.factorize(jnp.asarray(a))
    for got, want in ((fac.solve(torch.as_tensor(b)), fac_j.solve32(b)),
                      (fac.solve_t(torch.as_tensor(b)), fac_j.solve32_t(b))):
        got, want = got.numpy(), np.asarray(want)
        assert not np.isfinite(got).any()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(got, want, equal_nan=True)
