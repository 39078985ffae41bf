"""The port's host-stepped solver layer (``ocean_torch/system.py``: warm
starts, ``make_newton_stager`` / ``run_newton_staged``,
``make_adjoint_stager`` / ``run_adjoint_staged``, ``make_staged_pair``;
``opt/driver.py::_run_gd_staged``) against ``ocean_jax`` on the same
numpy inputs (mirrors ``tests/test_staged_ladder.py``,
``tests/test_staged_pair.py`` and ``tests/test_driver_staged.py``).

Bars: the stepped Newton within 1e-12·max|w| of JAX's and equal to the
port's ``newton_solve_mg`` (the same operations), with the same
iteration count, flag and re-freeze events; the staged adjoint equal to
the port's ``_solve_adjoint_flagged``, with JAX's rounds and flag, and
within 1e-12·max|z| of JAX's where both refine to 1e-14 (at the default
1e-11 the two packages' float32 Krylov noise leaves the solutions 1e-11
apart, inside the solver's tolerance); warm starts within 1e-12 of JAX's
states; the staged pair against ``gd_step`` at 1e-12 (JAX's bar); the
host ladder within 1e-8·max|w| of ``solve_ns``'s; the two driver loops
bit-identical; and at the line search's safety bound the staged loop's
LR and control those of JAX's staged loop. Multigrid at Nx=8, 6 buoys,
nt=10; the JAX side is kept to a few short programs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_jax import system as jax_system
from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax.opt.driver import run_gradient_descent as jax_run_gd

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.control import Control, boundary_inner
from ocean_torch.opt.driver import run_gradient_descent

torch.set_num_threads(2)

MG = dict(unit_square_resolution=8, ud_experiment="6_buoys", T=0.05,
          dt=0.005, linear_solver="mg", viscosity=0.2,
          newton_continuation=1)


def _data(cfg, K, seed):
    rng = np.random.default_rng(seed)
    u_d = 0.05 * rng.standard_normal((K, cfg.num_time_steps, 2))
    x0 = 0.3 + 1.4 * rng.random((K, 2))
    return u_d, x0


def _pair(seed=0, **kw):
    """The port's and JAX's problem on the same numpy inputs."""
    cfg = OCPConfig(**kw)
    u_d, x0 = _data(cfg, 6, seed)
    pt = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    pj = jax_system.build_problem(JaxConfig(**kw), u_d=u_d, x0=x0)
    return pt, pj


def _max(a) -> float:
    return float(np.abs(np.asarray(a)).max())


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def mg():
    """ν = 0.2 with a 1-rung ladder (solves at ν = 1, 0.447, 0.2): the port's and JAX's problem, the
    control, the port's Newton solve at ν = 1 (``w1``, one rung of the
    port's ``newton_solve_mg``), and each package's forward state at the
    control warm-started from w1."""
    pt, pj = _pair(**MG)
    pt = dataclasses.replace(pt, solve_log=[])
    f = system.initial_control(pt, case=4)
    fj = jax_system.initial_control(pj, case=4)
    w1 = system._newton_at(pt, f.quad, 1.0,
                           torch.zeros(pt.space.ndof, dtype=torch.float64))
    fwd = system.forward(pt, f.quad, w_start=w1.w)
    fwd_j = jax_system.forward(pj, fj.quad, w_start=jnp.asarray(w1.w.numpy()))
    return pt, pj, f, fj, w1, fwd, fwd_j


def test_forward_w_start_mg_matches_jax(mg):
    pt, _, _, _, _, fwd, fwd_j = mg
    assert fwd.newton.converged and bool(fwd_j.newton.converged)
    assert _gap(fwd.w, fwd_j.w) < 1e-12 * _max(fwd.w)
    assert _gap(fwd.u_values, fwd_j.u_values) < 1e-12
    assert fwd.newton.iterations == int(fwd_j.newton.iterations)
    assert [(r["solve"], r["warm_start"]) for r in pt.solve_log] == \
        [("ns_newton", True)]


def test_forward_w_start_dense_matches_jax():
    """The dense path below ν = 1: no rungs, a fresh factorization of
    J(w_start) each step, JAX's state."""
    kw = dict(MG, linear_solver="dense", viscosity=0.1)
    pt, pj = _pair(**kw)
    f = system.initial_control(pt, case=4)
    w_start = system.forward(pt, 0.5 * f.quad).w
    pt = dataclasses.replace(pt, solve_log=[])
    fwd = system.forward(pt, f.quad, w_start=w_start)
    fwd_j = jax_system.forward(pj, jax_system.initial_control(pj, 4).quad,
                               w_start=jnp.asarray(w_start.numpy()))
    assert fwd.newton.converged and bool(fwd_j.newton.converged)
    assert _gap(fwd.w, fwd_j.w) < 1e-12 * _max(fwd.w)
    assert fwd.newton.iterations == int(fwd_j.newton.iterations)
    assert [(r["solve"], r["warm_start"]) for r in pt.solve_log] == \
        [("ns_newton", True)]


@pytest.fixture(scope="module")
def stagers(mg):
    """Each package's Newton stager (JAX's compiled once)."""
    pt, pj = mg[:2]
    return system.make_newton_stager(pt), jax_system.make_newton_stager(pj)


@pytest.mark.parametrize("knobs", [{}, dict(max_refreeze=2,
                                            stall_ratio=0.0)],
                         ids=["plain", "refreeze"])
def test_stepped_newton_matches_jax(mg, stagers, knobs):
    """The stepped Newton at ν = 1 on the hierarchy frozen at ν = 0.2
    (``nu_scale`` = 5), plain and re-frozen after every step twice."""
    pt, pj, f, fj, w1, _, _ = mg
    w0 = torch.zeros(pt.space.ndof, dtype=torch.float64)
    ev, ev_j = [], []
    w, it, rn, conv = system.run_newton_staged(
        stagers[0], f.quad, w0, 1.0, nu_scale=1.0 / pt.nu,
        on_step=lambda i, r, e: ev.append((i, e)), **knobs)
    wj, it_j, _, conv_j = jax_system.run_newton_staged(
        stagers[1], fj.quad, jnp.zeros(pj.space.ndof), 1.0,
        nu_scale=1.0 / pj.nu, on_step=lambda i, r, e: ev_j.append((i, e)),
        **knobs)
    assert conv and (it, conv) == (it_j, conv_j) and ev == ev_j
    assert _gap(w, wj) < 1e-12 * _max(w)
    if knobs:
        assert sum(e == "refreeze" for _, e in ev) == 2
    else:
        # the same operations as the port's newton_solve_mg
        assert torch.equal(w, w1.w) and it == w1.iterations


class _FakeStager:
    """A Newton stager that replays residual norms: ``init`` gives
    ``r0``, each ``step`` the next value."""

    def __init__(self, r0, steps, tensor):
        self.r0, self.steps, self.tensor = r0, iter(steps), tensor

    def init(self, f_quad, w0, nu):
        return None, None, w0, self.tensor(self.r0)

    def step(self, f_quad, w, r, rn, op0, op0_c, nu, sc, tol):
        return w, r, self.tensor(next(self.steps))


@pytest.mark.parametrize("r0, steps, kw, want", [
    # the polish step meets the tolerance: converged
    (1.0, [0.5, 5e-11], dict(max_iter=1), (2, 5e-11, True)),
    # three flat steps (each above 0.97 of the last): given up
    (1.0, [0.99, 0.985, 0.98], dict(stagnation_break=3), (3, 0.98, False)),
    # the tolerance met on the N-th flat step is not a failure
    (1.0, [0.52, 0.51, 0.499, 0.1], dict(stagnation_break=2, rtol=0.5),
     (4, 0.1, True)),
], ids=["polish_credit", "stagnation_break", "tolerance_on_flat_step"])
def test_stepped_newton_host_rules_match_jax(r0, steps, kw, want):
    out = []
    for pkg, zeros, tensor in (
            (system, torch.zeros(3),
             lambda v: torch.tensor(v, dtype=torch.float64)),
            (jax_system, jnp.zeros(3), jnp.asarray)):
        fake = _FakeStager(r0, steps, tensor)
        stager = pkg.NewtonStager(fake.init, fake.step, None, None)
        _, it, rn, conv = pkg.run_newton_staged(stager, None, zeros, 1.0,
                                                polish=1, **kw)
        out.append((it, float(rn), bool(conv)))
    assert out[0] == out[1] == want


def test_staged_adjoint_matches_jax(mg):
    pt, pj, f, fj, _, fwd, fwd_j = mg
    st, st_j = system.make_adjoint_stager(pt), \
        jax_system.make_adjoint_stager(pj)
    rounds, rounds_j = [], []
    z, g, gradj, div_u, ok = system.run_adjoint_staged(
        st, f, fwd, on_round=lambda r, rel: rounds.append(r))
    _, _, _, _, ok_j = jax_system.run_adjoint_staged(
        st_j, fj, fwd_j, on_round=lambda r, rel: rounds_j.append(r))
    assert ok and bool(ok_j) and rounds == rounds_j

    # the port's fused adjoint solve: the same operations
    log = dataclasses.replace(pt, solve_log=[])
    z_ref, _ = system._solve_adjoint_flagged(log, fwd)
    assert torch.equal(z, z_ref)
    assert log.solve_log[0]["rounds"] == rounds[-1]
    g_ref = system.reduced_gradient(pt, f, z_ref)
    assert torch.equal(g.quad, g_ref.quad)
    assert float(gradj) == float(boundary_inner(
        pt.bq, g_ref, Control(-g_ref.quad, -g_ref.p2)))

    # refined to 1e-14, the two packages' states agree to 1e-12
    rounds, rounds_j = [], []
    z, _, _, _, ok = system.run_adjoint_staged(
        st, f, fwd, tol=1e-14, max_rounds=6,
        on_round=lambda r, rel: rounds.append(r))
    zj, _, gradj_j, div_j, ok_j = jax_system.run_adjoint_staged(
        st_j, fj, fwd_j, tol=1e-14, max_rounds=6,
        on_round=lambda r, rel: rounds_j.append(r))
    assert ok and bool(ok_j) and rounds == rounds_j
    assert _gap(z, zj) < 1e-12 * _max(z)
    assert abs(float(div_u) - float(div_j)) < 1e-12 * float(div_u)


@pytest.mark.parametrize("rels, accept_rel, want", [
    ([1e-6, 3e-11, 2.9e-11], 1e-9, (3, True)),    # a plateau at the floor
    ([1e-6, 3e-11, 2.9e-11], 1e-11, (3, False)),  # above accept_rel
    ([1e-2, 3.6e-2], 1e-9, (2, False)),           # a stall
    ([1e-6, 1e-12], 1e-9, (2, True)),             # tol met
])
def test_staged_adjoint_plateau_matches_jax(rels, accept_rel, want):
    """The plateau rule with a stager that replays relative residuals
    (‖b‖ = 1): a round that contracts by less than 3× ends the loop."""
    out = []
    for pkg, b in ((system, torch.zeros(3)), (jax_system, jnp.zeros(3))):
        seq = iter(rels)
        stager = pkg.AdjointStager(
            lambda f, fwd: (b, None, None, 0.0, 1.0),
            lambda op, op_c, b_, x: (x, next(seq)),
            lambda f, z: (None, None))
        seen = []
        *_, ok = pkg.run_adjoint_staged(stager, None, None,
                                        accept_rel=accept_rel,
                                        on_round=lambda r, rel: seen.append(r))
        out.append((len(seen), bool(ok)))
    assert out[0] == out[1] == want


def test_host_ladder_and_warm_begin(mg):
    """The ladder rung by rung through ``rung``, then ``begin_warm``: the
    state and J of ``begin``, whose forward runs ``solve_ns``'s ladder."""
    pt, _, f, _, w1, _, _ = mg
    progs = system.make_staged_pair(pt)
    w = torch.zeros(pt.space.ndof, dtype=torch.float64)
    for nu_k in system.continuation_viscosities(pt.nu,
                                                pt.newton_continuation):
        w = progs.rung(f.quad, w, nu_k)
        if nu_k == 1.0:
            assert torch.equal(w, w1.w)
    fwd_w, j_warm = progs.begin_warm(f.quad, w)
    fwd_c, j_cold = progs.begin(f.quad)
    assert fwd_w.newton.converged and fwd_c.newton.converged
    scale = float(fwd_c.w.abs().max())
    assert scale > 0.0
    assert float((fwd_w.w - fwd_c.w).abs().max()) < 1e-8 * scale
    assert abs(float(j_warm) - float(j_cold)) < 1e-9 * (abs(float(j_cold))
                                                        + 1.0)
    assert system.make_staged_pair(
        dataclasses.replace(pt, linear_solver="dense")).rung is None


def test_staged_pair_matches_gd_step():
    """A host Armijo loop over begin, grad, probe and record against
    ``gd_step`` with the line search (test_staged_pair.py's run)."""
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment="4_buoys",
                    T=0.05, dt=0.005, use_line_search=True)
    u_d, x0 = _data(cfg, 4, 0)
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    f0 = system.initial_control(prob, case=4)
    progs = system.make_staged_pair(prob)
    f, lr = f0, float(cfg.LR)
    fwd, j_dev = progs.begin(f.quad)
    j_old = float(j_dev)
    js, lrs = [], []
    for _ in range(3):
        _, g, gradj, _, ok = progs.grad(f, fwd)
        assert ok
        cond = -cfg.c_armijo * float(gradj)
        for _ in range(30):
            f_c, fwd_c, j_dev = progs.probe(f, g, lr)
            j_new = float(j_dev)
            if j_old - j_new >= lr * cond:
                break
            lr = max(cfg.tau * lr, cfg.LR_MIN)
        js.append(float(progs.record(fwd.u_values, f_c.quad)))
        lrs.append(lr)
        f, fwd, j_old = f_c, fwd_c, j_new

    f_s, f, lr = f, f0, float(cfg.LR)
    for i in range(3):
        res = system.gd_step(prob, f, lr, use_line_search=True,
                             tau=cfg.tau, c_armijo=cfg.c_armijo,
                             lr_min=cfg.LR_MIN, max_ls_iters=30)
        assert res.lr == lrs[i]
        assert abs(float(res.J) - js[i]) <= 1e-12 * abs(js[i])
        f, lr = res.f_new, res.lr
    assert float((f_s.quad - f.quad).abs().max()) < 1e-12


def _driver_problem():
    """test_driver_staged.py's problem."""
    cfg = OCPConfig(ud_experiment="2_buoys", unit_square_resolution=8,
                    use_line_search=True, num_steps=3, T=0.1, dt=0.01)
    rng = np.random.default_rng(4)
    u_d = 0.05 * rng.standard_normal((2, cfg.num_time_steps, 2))
    x0 = 0.4 + 1.2 * rng.random((2, 2))
    return cfg, u_d, x0


@pytest.mark.parametrize("use_line_search", [True, False])
def test_staged_driver_matches_per_stage_loop(use_line_search):
    cfg, u_d, x0 = _driver_problem()
    cfg = dataclasses.replace(cfg, use_line_search=use_line_search)
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    f0 = system.initial_control(prob, case=0)
    r_leg = run_gradient_descent(cfg, prob, f0, staged=False, verbose=False)
    r_stg = run_gradient_descent(cfg, prob, f0, verbose=False)
    assert r_stg.j_array == r_leg.j_array and r_stg.lr == r_leg.lr
    assert r_stg.divs_u == r_leg.divs_u
    assert r_stg.inner_iterations == r_leg.inner_iterations
    assert r_stg.exit_reason == r_leg.exit_reason
    assert all(np.array_equal(a, b)
               for a, b in zip(r_stg.x_array, r_leg.x_array))
    assert torch.equal(r_stg.f.quad, r_leg.f.quad)
    assert torch.equal(r_stg.f.p2, r_leg.f.p2)


def test_staged_driver_safety_bound_matches_jax():
    """``max_line_search_iters=2`` from LR 2000: both probes of each
    iteration are rejected, and the staged loop takes the probe at the
    LR before the last decrement (JAX's staged loop), where the
    per-stage loop updates with the decremented LR."""
    cfg, u_d, x0 = _driver_problem()
    over = dict(LR=2000.0, max_line_search_iters=2, num_steps=2)
    cfg = dataclasses.replace(cfg, **over)
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    f0 = system.initial_control(prob, case=0)
    r_stg = run_gradient_descent(cfg, prob, f0, verbose=False)
    r_leg = run_gradient_descent(cfg, prob, f0, staged=False, verbose=False)

    cfg_j = JaxConfig(ud_experiment="2_buoys", unit_square_resolution=8,
                      use_line_search=True, T=0.1, dt=0.01, **over)
    pj = jax_system.build_problem(cfg_j, u_d=u_d, x0=x0)
    r_j = jax_run_gd(cfg_j, pj, jax_system.initial_control(pj, case=0),
                     staged=True, verbose=False)
    assert r_stg.inner_iterations == r_j.inner_iterations == [2, 2]
    assert r_stg.lr == float(r_j.lr) == 125.0
    # LR 1000 multiplies the packages' ~1e-14 gap in g (J after the
    # step: 2e-11 apart)
    scale = _max(r_j.f.quad)
    assert _gap(r_stg.f.quad, r_j.f.quad) < 1e-10 * scale
    np.testing.assert_allclose(r_stg.j_array, r_j.j_array, rtol=1e-9)
    # the per-stage loop's control is another one
    assert _gap(r_leg.f.quad, r_j.f.quad) > 1e-3 * scale
