"""The port's viscosity continuation (``newton_continuation``,
``ocean_torch/system.py::_solve_ns``) against ocean_jax at the reference's
golden viscosity ν = 0.01 (mirrors ``tests/test_continuation.py``, whose
inputs come from the absent reference data; here both packages get the
same arrays: the 10-buoy layout at x = 0.1 and its u_d, synthesized by the
port's ``ud_construction`` at ν = 1, Nx = 8).

Bars:
* the dense ladder at Nx = 8, 6 rungs: each rung's Newton iterations
  within one of JAX's (JAX's full-Newton steps are float32 LU solves, the
  port's float64, so a rung's last step may differ), the final w within
  1e-9·max|w| of ``ocean_jax.system._solve_ns``'s (inside JAX's
  ``gd_step``, so one JAX program serves this check and the next), J at
  the forward state within 1e-10 relative;
* vanilla Newton (no rungs) reports the same ``converged`` flag, False,
  in both packages, with a residual above 1 (JAX's is its
  ``newton_solve`` from w = 0 at ν, what ``system.solve_ns`` runs
  without rungs, through the rung program already compiled);
* one Armijo ``gd_step`` from ``initial_control(case=0)`` at LR 0.15625,
  whose first probe converges and is accepted (from a larger
  LR the rejected probes' Newton solves stall, 50 steps each, and JAX's
  CPU loops take seconds a step under the suite's load): LR and probes
  equal, J within 1e-10 relative;
* (the multigrid ladder: ``test_torch_continuation_mg.py``)
* ν ≥ 1, or 0 rungs, is the solve without a ladder.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
from ocean_jax.fem import assemble as jax_assemble
from ocean_jax.solve.newton import newton_solve as jax_newton_solve

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.pipelines import ud_construction

torch.set_num_threads(2)

GOLDEN = dict(ud_experiment="10_buoys", viscosity=0.01, use_line_search=True)
LR = 0.15625


@pytest.fixture(scope="module")
def data():
    r = ud_construction.run(nx=8, K=10, viscosity=1.0, device="cpu")
    return r["u_values"], r["x"][:, 0, :]


def _torch_problem(data, nx=8, **kw):
    cfg = OCPConfig(unit_square_resolution=nx, **{**GOLDEN, **kw})
    prob = system.build_problem(cfg, u_d=data[0], x0=data[1], device="cpu")
    return dataclasses.replace(prob, solve_log=[])


def _jax_problem(data, nx=8, **kw):
    cfg = JaxConfig(unit_square_resolution=nx, **{**GOLDEN, **kw})
    return jax_system.build_problem(cfg, u_d=data[0], x0=data[1])


@jax.jit
def _jax_rung(prob, f_quad, w0, nu):
    """One rung of JAX's dense ladder (``_solve_ns``: full Newton from the
    previous rung's state at ν_k), ν_k traced so one program serves all."""
    return jax_newton_solve(
        lambda w: jax_assemble.ns_residual(prob.space, prob.bq, w, f_quad,
                                           nu),
        lambda w: jax_assemble.ns_operator(prob.space, prob.bq, w, nu,
                                           prob.bc_dofs),
        w0, prob.bc_dofs, prob.bc_vals)


@pytest.fixture(scope="module")
def ladder(data):
    """Both packages' dense ladders at Nx = 8 from case 0, JAX's rungs one
    by one, and one Armijo GD step of each."""
    pt = _torch_problem(data, newton_continuation=6)
    pj = _jax_problem(data, newton_continuation=6)
    ft = system.initial_control(pt, case=0)
    fj = jax_system.initial_control(pj, case=0)
    rt = system.solve_ns(pt, ft.quad)
    w = jnp.zeros(pj.space.ndof)
    rung_iters = []
    for nu_k in system.continuation_viscosities(0.01, 6):
        r = _jax_rung(pj, fj.quad, w, nu_k)
        rung_iters.append(int(r.iterations))
        w = r.w
    step_j = jax_system.gd_step(pj, fj, jnp.asarray(LR),
                                use_line_search=True)
    return SimpleNamespace(
        pt=pt, pj=pj, ft=ft, fj=fj, rt=rt, rj=step_j.fwd.newton,
        rung_iters=rung_iters, log=list(pt.solve_log),
        step_t=system.gd_step(pt, ft, LR, use_line_search=True),
        step_j=step_j)


def test_ladder_viscosities_follow_jax():
    nus = system.continuation_viscosities(0.01, 6)
    ratio = 0.01 ** (1 / 7)
    assert nus == [ratio ** k for k in range(7)]
    assert nus[0] == 1.0 and abs(nus[-1] * ratio - 0.01) < 1e-15


def test_dense_ladder_matches_jax(ladder):
    rungs = [r for r in ladder.log if r["solve"] == "ns_rung"]
    assert [r["nu"] for r in rungs] == system.continuation_viscosities(
        0.01, 6)
    assert all(r["converged"] for r in rungs)
    assert all(abs(r["iterations"] - j) <= 1
               for r, j in zip(rungs, ladder.rung_iters)), \
        ([r["iterations"] for r in rungs], ladder.rung_iters)
    assert ladder.log[-1]["solve"] == "ns_newton"
    assert ladder.rt.converged and bool(ladder.rj.converged)
    wj = np.asarray(ladder.rj.w)
    scale = np.abs(wj).max()
    assert scale > 3.0                       # the strong flow
    assert np.abs(ladder.rt.w.numpy() - wj).max() < 1e-9 * scale


def test_forward_cost_matches_jax(ladder):
    jt = float(system.cost(ladder.pt, ladder.step_t.fwd.u_values,
                           ladder.ft.quad))
    jj = float(jax_system.cost(ladder.pj, ladder.step_j.fwd.u_values,
                               ladder.fj.quad))
    assert abs(jt - jj) <= 1e-10 * abs(jj)


def test_armijo_step_matches_jax(ladder):
    st, sj = ladder.step_t, ladder.step_j
    assert st.lr == float(sj.lr) and st.inner_iterations == \
        int(sj.inner_iterations) == 1
    assert not st.diverged and not bool(sj.diverged)
    assert abs(float(st.J) - float(sj.J)) <= 1e-10 * abs(float(sj.J))
    # escapes at the golden viscosity reach the kernels' plain versions
    assert int(st.fwd.mask.sum()) == int(jnp.sum(sj.fwd.mask))


def test_vanilla_newton_flag_matches_jax(data, ladder):
    """The failure the ladder exists for, in both packages."""
    pt = _torch_problem(data)
    rt = system.solve_ns(pt, system.initial_control(pt, case=0).quad)
    rj = _jax_rung(ladder.pj, ladder.fj.quad, jnp.zeros(ladder.pj.space.ndof),
                   0.01)
    assert rt.converged is bool(rj.converged) is False
    assert rt.residual_norm > 1.0 and float(rj.residual_norm) > 1.0
    assert [r["solve"] for r in pt.solve_log] == ["ns_newton"]


@pytest.mark.parametrize("kw", [dict(viscosity=1.0, newton_continuation=6),
                                dict(viscosity=0.5, newton_continuation=0)],
                         ids=["nu=1", "no rungs"])
def test_no_ladder_is_the_plain_solve(data, kw):
    p = _torch_problem(data, **kw)
    plain = _torch_problem(data, **{**kw, "newton_continuation": 0})
    f = system.initial_control(p, case=0)
    r, r0 = system.solve_ns(p, f.quad), system.solve_ns(plain, f.quad)
    assert torch.equal(r.w, r0.w) and r.iterations == r0.iterations
    assert [x["solve"] for x in p.solve_log] == ["ns_newton"]
