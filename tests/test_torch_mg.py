"""The port's multigrid Krylov path (``ocean_torch/solve/mg.py`` and the
mg branches of ``ocean_torch/system.py``) against its dense path and
against ``ocean_jax``'s multigrid path, on the same numpy inputs (mirrors
``tests/test_mg.py``).

Bars (the JAX tests'): Newton w and adjoint z within 1e-9 of the dense
solves and of JAX's multigrid solves at Nx=16; a GD step with the Armijo
search: J within 1e-9 relative, f_new within 1e-10, the same LR and, on
the multigrid path of both packages, the same Newton iteration count
(inner Krylov counts are not compared: they move with the float32
round-off of the preconditioner). The three-level hierarchy at Nx=24:
f_new within 1e-9; the L-shape staircase at resolution 13: w within 3e-8
of the dense solve (float32 Krylov noise amplified on pressure dofs).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system

from ocean_torch.config import OCPConfig
from ocean_torch import system
from ocean_torch.fem import assemble
from ocean_torch.pipelines import limits
from ocean_torch.solve import krylov, mg as mg_mod

torch.set_num_threads(2)


def _data(cfg, K, seed):
    rng = np.random.default_rng(seed)
    u_d = 0.05 * rng.standard_normal((K, cfg.num_time_steps, 2))
    x0 = 0.3 + 1.4 * rng.random((K, 2))
    return u_d, x0


def _problem(nx, solver, K=4, seed=0, **kw):
    cfg = OCPConfig(unit_square_resolution=nx, ud_experiment=f"{K}_buoys",
                    T=0.05, dt=0.005, linear_solver=solver, **kw)
    u_d, x0 = _data(cfg, K, seed)
    return system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")


def _step(prob, f):
    return system.gd_step(prob, f, 5.0, use_line_search=True,
                          max_ls_iters=10)


@pytest.fixture(scope="module")
def pair16():
    pd, pm = _problem(16, "dense"), _problem(16, "mg")
    f = system.initial_control(pd, case=0)
    return pd, pm, f, _step(pd, f)


@pytest.fixture(scope="module")
def jax16():
    """JAX's multigrid GD step at Nx=16 (test_mg.py's pair16 problem):
    its forward state, adjoint state and update in one call."""
    cfg = JaxConfig(unit_square_resolution=16, ud_experiment="4_buoys",
                    T=0.05, dt=0.005, linear_solver="mg")
    u_d, x0 = _data(cfg, 4, 0)
    pj = jax_system.build_problem(cfg, u_d=u_d, x0=x0)
    fj = jax_system.initial_control(pj, case=0)
    return jax_system.gd_step(pj, fj, jnp.asarray(5.0),
                              use_line_search=True, max_ls_iters=10)


@pytest.fixture(scope="module")
def mg16(pair16):
    _, pm, f, _ = pair16
    pm = dataclasses.replace(pm, solve_log=[])
    return pm, _step(pm, f)


def test_mg_newton_and_adjoint_match_dense_and_jax(pair16, mg16, jax16):
    _, _, _, a = pair16
    pm, b = mg16
    assert pm.linear_solver == "mg" and pm.mg.matvec == "stencil"
    assert b.fwd.newton.converged
    assert float((a.fwd.w - b.fwd.w).abs().max()) < 1e-9
    assert float((a.z - b.z).abs().max()) < 1e-9
    assert float(np.abs(b.fwd.w.numpy() - np.asarray(jax16.fwd.w)).max()) \
        < 1e-9
    assert float(np.abs(b.z.numpy() - np.asarray(jax16.z)).max()) < 1e-9
    assert b.fwd.newton.iterations == int(jax16.fwd.newton.iterations)
    # the solve log: one record per NS solve (the step's and each
    # probe's) and one for the adjoint, whose flag is the converged one
    kinds = [r["solve"] for r in pm.solve_log]
    assert kinds.count("adjoint") == 1
    assert kinds.count("ns_newton") == 1 + b.inner_iterations
    adj = next(r for r in pm.solve_log if r["solve"] == "adjoint")
    assert adj["converged"] and adj["relative_residual"] <= 1e-11
    assert 1 <= adj["rounds"] <= 4
    ns = pm.solve_log[0]
    assert len(ns["krylov_cycles"]) == ns["iterations"]


def test_mg_gd_step_parity(pair16, mg16, jax16):
    """The GD iteration with the Armijo search agrees between the port's
    dense and multigrid paths and JAX's multigrid path."""
    _, _, _, a = pair16
    _, b = mg16
    assert not b.diverged
    assert a.lr == b.lr == float(jax16.lr)
    assert b.inner_iterations == int(jax16.inner_iterations)
    for ref in (float(a.J), float(jax16.J)):
        assert abs(float(b.J) - ref) <= 1e-9 * abs(ref)
    assert float((a.f_new.quad - b.f_new.quad).abs().max()) < 1e-10
    assert float(np.abs(b.f_new.quad.numpy()
                        - np.asarray(jax16.f_new.quad)).max()) < 1e-10


@pytest.mark.parametrize("kw", [dict(mg_pre=1, mg_post=1),
                                dict(mg_coarse_krylov=8)],
                         ids=["light_smoothing", "coarse_krylov"])
def test_mg_preconditioner_variants_parity(pair16, kw):
    """Lighter smoothing and the convection-aware coarse Krylov change the
    preconditioner only: the GD step still matches the dense one."""
    pd, pm, f, a = pair16
    b = _step(dataclasses.replace(pm, **kw), f)
    assert not b.diverged and a.lr == b.lr
    assert abs(float(a.J) - float(b.J)) <= 1e-9 * abs(float(a.J))
    assert float((a.f_new.quad - b.f_new.quad).abs().max()) < 1e-10


def test_multilevel_vcycle_parity():
    """Three grids (Nx=24 → 12 → 6, forced by a leaf budget of 800
    velocity dofs): the recursive V-cycle's GD step equals the dense
    one."""
    prob = _problem(24, "mg", K=2, seed=3)
    ctx = system.build_mg_hierarchy(
        OCPConfig(unit_square_resolution=24, ud_experiment="2_buoys",
                  T=0.05, dt=0.005),
        prob.space, prob.bq, prob.bc_dofs, 24, budget=800)
    assert ctx.ainv_c is None and ctx.sub is not None
    assert ctx.op_vel_c is not None and ctx.sub.ainv_c is not None
    assert ctx.sub.sub is None and ctx.sub.st_vel is not None
    assert ctx.sub.ainv_c.dtype == torch.float32
    pm = dataclasses.replace(prob, mg=ctx)
    pd = _problem(24, "dense", K=2, seed=3)
    f = system.initial_control(pd, case=0)
    a, b = _step(pd, f), _step(pm, f)
    assert not b.diverged and a.lr == b.lr
    assert abs(float(a.J) - float(b.J)) <= 1e-9 * abs(float(a.J))
    assert float((a.f_new.quad - b.f_new.quad).abs().max()) < 1e-9


def test_mg_lshape_staircase():
    """Odd L-shape resolutions put staircase dofs outside the coarse
    grid's analytic domain; the transfers snap them."""
    cfg = OCPConfig(L_shape=True, L_shape_resolution=13,
                    ud_experiment="3_buoys", linear_solver="mg",
                    T=0.05, dt=0.005)
    u_d, x0 = system.lshape_ud(cfg)
    pm = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    pd = system.build_problem(dataclasses.replace(cfg, linear_solver="dense"),
                              u_d=u_d, x0=x0, device="cpu")
    f = system.initial_control(pm, case=0)
    rm = system.solve_ns(pm, f.quad)
    rd = system.solve_ns(pd, f.quad)
    assert rm.converged and rm.residual_norm < 1e-11
    assert float((rm.w - rd.w).abs().max()) < 3e-8


def test_mg_mesh_independent_cycles():
    """With the float64 preconditioner, FGMRES restart cycles stay flat
    as the mesh refines."""
    cycles = {}
    rng = np.random.default_rng(1)
    for nx in (8, 16, 24):
        prob = _problem(nx, "mg")
        f = system.initial_control(prob, case=0)
        w = system.solve_ns(prob, f.quad).w
        op = assemble.ns_operator(prob.space, prob.bq, w, prob.nu,
                                  prob.bc_dofs)
        b = assemble.apply_bc_vector(
            torch.as_tensor(rng.standard_normal(prob.space.ndof)),
            prob.bc_dofs, prob.bc_vals)
        M = mg_mod.make_block_preconditioner(prob.mg, prob.space, op)
        res = krylov.fgmres(op.matvec64, b, M=M, restart=30,
                            max_restarts=40, tol=1e-11)
        assert res.converged
        cycles[nx] = res.iterations
    assert max(cycles.values()) <= 4, cycles
    assert cycles[24] <= cycles[8] + 1, cycles


def test_auto_solver_selection():
    """"auto" picks dense below AUTO_MG_DOF_THRESHOLD mixed dofs and mg
    above: Nx=56 has 28,787 dofs, two levels (leaf Nx=28, 6,498 velocity
    dofs), the stencil matvec and the dense ∇u projection."""
    small = _problem(8, "auto")
    assert small.linear_solver == "dense" and small.mg is None
    assert small.fac0 is not None
    big = _problem(56, "auto", K=2)
    assert big.space.ndof == 28787 > system.AUTO_MG_DOF_THRESHOLD
    assert big.linear_solver == "mg" and big.fac0 is None
    assert big.mg.space_c.ndof == 7339 and big.mg.sub is None
    assert tuple(big.mg.ainv_c.shape) == (6498, 6498)
    assert big.mg.matvec == "stencil" and big.projector.mode == "lu"
    assert not big.adjoint_reuse_lu
    assert {"mg_levels", "mg_leaf_inverse",
            "mg_transfers_and_stencil_tables"} <= set(big.setup_seconds)


def test_forced_dense_is_honoured_past_the_threshold(monkeypatch):
    """A forced "dense" builds at any size (the port refused past 25,000
    dofs before); "auto" goes to mg there and "mg" is honoured below."""
    monkeypatch.setattr(system, "AUTO_MG_DOF_THRESHOLD", 100)
    dense = _problem(8, "dense")
    assert dense.space.ndof > 100
    assert dense.linear_solver == "dense" and dense.fac0 is not None
    assert _problem(8, "auto").linear_solver == "mg"
    monkeypatch.undo()
    assert _problem(8, "mg").linear_solver == "mg"


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_resolve_adjoint_reuse_follows_jax(mode):
    for nu in (1.0, 0.1):
        for solver in ("dense", "mg"):
            assert system.resolve_adjoint_reuse(mode, nu, solver) == \
                jax_system.resolve_adjoint_reuse(mode, nu, solver)
    assert system.resolve_adjoint_reuse("auto", 1.0, "mg") is False


def test_refusals_name_what_is_missing():
    """Continuation, once refused, runs on both solver paths to the same
    state, and a legacy context without a leaf inverse or a sub-level
    raises."""
    states = []
    for solver in ("mg", "dense"):
        p = dataclasses.replace(_problem(8, solver, newton_continuation=2,
                                         viscosity=0.2), solve_log=[])
        res = system.solve_ns(p, system.initial_control(p, 0).quad)
        assert res.converged and [r["solve"] for r in p.solve_log] == \
            ["ns_rung"] * 3 + ["ns_newton"]
        states.append(res.w)
    assert (states[0] - states[1]).abs().max() < 1e-9 * states[1].abs().max()
    pm = _problem(8, "mg")
    legacy = dataclasses.replace(pm.mg, ainv_c=None)
    op = assemble.ns_operator(pm.space, pm.bq,
                              torch.zeros(pm.space.ndof, dtype=torch.float64),
                              pm.nu, pm.bc_dofs)
    with pytest.raises(NotImplementedError, match="legacy"):
        mg_mod.make_block_preconditioner(legacy, pm.space, op)


def test_adjoint_flag_reports_unconverged_refinement():
    """The multigrid solve's ``converged`` means something: one round
    held to 1e-16 does not converge, the default rounds do."""
    pm = _problem(8, "mg")
    f = system.initial_control(pm, case=0)
    fwd = system.forward(pm, f.quad)
    b = system.adjoint_rhs(pm, fwd)
    op, op_c = system.adjoint_operators(pm, fwd.w)
    assert op_c is None
    bad = mg_mod.solve_operator_mg(op, None, pm.mg, pm.space, b, pm.bc_vals,
                                   tol=1e-16, max_rounds=1)
    assert not bad.converged and bad.rounds == 1
    z, ok = system._solve_adjoint_flagged(pm, fwd)
    assert ok and bool(torch.isfinite(z).all())


def test_limits_command_line_runs_mg(tmp_path, monkeypatch):
    """``python -m ocean_torch.pipelines.limits --linear-solver mg
    --projector-solver cg`` runs the scalability pipeline to its
    artifacts."""
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "run") + "/"
    res, prob, _ = limits.ocp_pipeline.main(
        ["--device", "cpu", "--linear-solver", "mg", "--projector-solver",
         "cg", "--ud-experiment", "100_buoys", "--unit-square-resolution",
         "8", "--num-steps", "2", "--out-dir", d],
        defaults=OCPConfig(ud_experiment="10_buoys", use_line_search=False),
        prog="ocean_torch.pipelines.limits", runner=limits.run)
    assert prob.linear_solver == "mg" and prob.mg is not None
    assert prob.projector.mode == "cg"
    assert res.iterations_run == 2 and np.isfinite(res.j_array).all()
    for name in ("variables.txt", "timings.txt", "J_array.npy",
                 "q_backup/q.npz", "paraview/velocity.xdmf"):
        assert os.path.isfile(d + name), name
