"""ocean_torch parity: ``gd_step`` with the Armijo backtracking line
search and ``gd_multi_step`` against ocean_jax, on the inputs of
``tests/test_multi_step.py`` (unit square, Nx=8, 2 buoys, nt=10).

Tolerances: LR, probe counts (``inner_iterations``) and ``diverged``
equal; J 1e-10 relative; f_new, the gradient and ``gradj`` 1e-8 relative
(the bounds of tests/test_torch_system.py: both Newton solves stop at
rtol 1e-9). Equal LR and probe counts need every Armijo decision to fall
the same way in both packages: ``test_armijo_decisions_are_not_marginal``
checks that no decision on these inputs sits within 1e-9 of its
threshold (J agrees to 1e-10), so no other seed had to be taken.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system

from ocean_torch import control as ctrl_mod, convert, system
from ocean_torch.adjoint.point_sources import recentred_slots
from ocean_torch.config import OCPConfig
from ocean_torch.control import Control
from ocean_torch.fem.spaces import make_space
from ocean_torch.mesh import structured
from ocean_torch.ode.cuda_ode import primal_ode_steps_plain
from ocean_torch.ode.grideval import eval_velocity_grid, make_grideval
from ocean_torch.ode.primal import finish_trajectories
import torch_kernel_cases as kernel_cases

# The suite runs in several worker processes on one machine; PyTorch's
# default of one thread a core in each of them oversubscribes it.
torch.set_num_threads(2)

BASE = dict(ud_experiment="2_buoys", unit_square_resolution=8, num_steps=3,
            T=0.1, dt=0.01)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(2)
    nt = JaxConfig(**BASE).num_time_steps
    u_d = 0.05 * rng.standard_normal((2, nt, 2))
    x0 = 0.4 + 1.2 * rng.random((2, 2))
    pj = jax_system.build_problem(JaxConfig(**BASE), u_d=u_d, x0=x0)
    pt = system.build_problem(OCPConfig(**BASE), u_d=u_d, x0=x0,
                              device="cpu")
    fj = jax_system.initial_control(pj, case=0)
    return pj, pt, fj, convert.control(fj)


def _compare_step(rj, rt):
    assert rt.lr == float(rj.lr)
    assert rt.inner_iterations == int(rj.inner_iterations)
    assert rt.diverged == bool(rj.diverged)
    assert abs(float(rt.J) - float(rj.J)) / abs(float(rj.J)) < 1e-10
    assert _rel(rt.f_new.quad, rj.f_new.quad) < 1e-8
    assert _rel(rt.f_new.p2, rj.f_new.p2) < 1e-8
    assert _rel(rt.grad.quad, rj.grad.quad) < 1e-8
    assert abs(rt.gradj - float(rj.gradj)) <= 1e-8 * abs(float(rj.gradj))


# At the reference's LR of 5 the first probe accepts on these inputs; from
# 1000 the search backtracks (1000, 500 fail, 250 accepts).
@pytest.mark.parametrize("lr0,kw,want", [
    (5.0, dict(), (5.0, 1)),                 # accepts at once
    (1000.0, dict(), (250.0, 3)),            # accepts after backtracking
    (1000.0, dict(lr_min=500.0), (500.0, 2)),   # floored: one failed probe
                                                # at the floor, then stop
    # the safety bound, with another τ and c: 1000 fails, 300 is probed
    # and the search stops whatever it says
    (1000.0, dict(max_ls_iters=1, tau=0.3, c_armijo=0.5), (300.0, 2)),
], ids=["accept_first", "backtrack", "floored", "safety_bound_tau_c"])
def test_gd_step_armijo_matches_jax(problems, lr0, kw, want):
    pj, pt, fj, ft = problems
    rj = jax_system.gd_step(pj, fj, jnp.asarray(lr0), use_line_search=True,
                            **kw)
    rt = system.gd_step(pt, ft, lr0, use_line_search=True, **kw)
    _compare_step(rj, rt)
    assert rt.gradj < 0.0 and rt.inner_iterations >= 1
    assert (rt.lr, rt.inner_iterations) == want
    # without line search: LR is the caller's, no probe is counted
    r0 = system.gd_step(pt, ft, lr0)
    assert (r0.lr, r0.inner_iterations, r0.gradj) == (lr0, 0, 0.0)


def _armijo_margins(pt, f, lr, tau=0.5, c=1e-4, lr_min=1e-6):
    """The line search of ``system.line_search``, probe by probe:
    (lr, (j_old − j_new) − lr·(−c·gradj)) of every probe."""
    fwd = system.forward(pt, f.quad)
    z, _ = system._solve_adjoint_flagged(pt, fwd)
    g = system.reduced_gradient(pt, f, z)
    df = Control(-g.quad, -g.p2)
    gradj = float(ctrl_mod.boundary_inner(pt.bq, g, df))
    j_old = float(system.cost(pt, fwd.u_values, f.quad))
    out = []
    while True:
        f_ls = f.quad + lr * df.quad
        j_new = float(system.cost(pt, system.forward(pt, f_ls).u_values,
                                  f_ls))
        margin = (j_old - j_new) - lr * (-c * gradj)
        out.append((lr, margin, j_old))
        if margin >= 0 or lr <= lr_min:
            return out
        lr = max(tau * lr, lr_min)


def test_armijo_decisions_are_not_marginal(problems):
    _, pt, _, ft = problems
    for lr0 in (5.0, 1000.0):
        probes = _armijo_margins(pt, ft, lr0)
        res = system.gd_step(pt, ft, lr0, use_line_search=True)
        assert len(probes) == res.inner_iterations
        assert probes[-1][0] == res.lr
        assert all(m < 0 for _, m, _ in probes[:-1]) and probes[-1][1] >= 0
        for lr, margin, j_old in probes:
            # relative to J, which both packages agree on to 1e-10
            assert abs(margin) > 1e-9 * abs(j_old), (lr, margin, j_old)


@pytest.mark.parametrize("use_line_search", [False, True])
def test_gd_multi_step_matches_jax(problems, use_line_search):
    pj, pt, fj, ft = problems
    n = 3
    lr0 = 1000.0 if use_line_search else 5.0      # 1000: backtracks
    fj_n, lrj, tj = jax_system.gd_multi_step(
        pj, fj, jnp.asarray(lr0), n, use_line_search=use_line_search)
    ft_n, lrt, tt = system.gd_multi_step(pt, ft, lr0, n,
                                         use_line_search=use_line_search)
    assert lrt == float(lrj)
    assert tt.lr.tolist() == np.asarray(tj.lr).tolist()
    assert (tt.inner_iterations.tolist()
            == np.asarray(tj.inner_iterations).tolist())
    assert tt.mask_count.tolist() == np.asarray(tj.mask_count).tolist()
    assert not bool(tt.diverged.any()) and tt.J.shape == (n,)
    assert _rel(tt.J, tj.J) < 1e-10 and _rel(tt.div_u, tj.div_u) < 1e-8
    assert _rel(ft_n.quad, fj_n.quad) < 1e-8
    # the LR is carried, never reset: non-increasing along the run
    assert all(b <= a for a, b in zip(tt.lr.tolist(), tt.lr.tolist()[1:]))
    # and gd_multi_step is the host loop over gd_step
    assert not use_line_search or int(tt.inner_iterations[0]) == 3
    f_h, lr_h = ft, lr0
    for k in range(n):
        r = system.gd_step(pt, f_h, lr_h, use_line_search=use_line_search)
        assert float(r.J) == float(tt.J[k]) and r.lr == float(tt.lr[k])
        f_h, lr_h = r.f_new, r.lr
    assert torch.equal(f_h.quad, ft_n.quad)


def test_line_search_satisfies_armijo_at_the_accepted_lr(problems):
    _, pt, _, ft = problems
    fwd = system.forward(pt, ft.quad)
    z, _ = system._solve_adjoint_flagged(pt, fwd)
    g = system.reduced_gradient(pt, ft, z)
    lr, probes, gradj = system.line_search(pt, ft, g, fwd, 1000.0)
    assert (lr, probes) == (250.0, 3) and gradj < 0
    f_new = ft.axpy(-lr, g)
    j_old = float(system.cost(pt, fwd.u_values, ft.quad))
    state = system.forward(pt, f_new.quad)
    j_new = float(system.cost(pt, state.u_values, f_new.quad))
    assert j_old - j_new >= lr * (-1e-4 * gradj)
    # and not at the LR before it
    f_big = ft.axpy(-2 * lr, g)
    j_big = float(system.cost(pt, system.forward(pt, f_big.quad).u_values,
                              f_big.quad))
    assert j_old - j_big < 2 * lr * (-1e-4 * gradj)
    # the forward solve is deterministic: what the driver's reuse of the
    # accepted probe's state rests on
    again = system.forward(pt, f_new.quad)
    assert torch.equal(again.w, state.w) and torch.equal(again.x, state.x)
    # a search that stops on its floor
    lr, probes, _ = system.line_search(pt, ft, g, fwd, 1000.0, lr_min=500.0)
    assert (lr, probes) == (500.0, 2)


# --- the recentred slots, from kfail/mask instead of x == center ----------

def _escape_runs():
    """Forward ODE runs on the escape inputs of torch_kernel_cases: the
    square's and the L-shape's."""
    sq = make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), 8, 8), "cpu"))
    ls = make_grideval(make_space(structured.l_shape_mesh(8), "cpu"))
    for case in ("leave_step_0", "leave_step_nt-2", "leave_last_eval",
                 "leave_never", "edge_slack", "K=77"):
        yield case, sq, kernel_cases.primal_ode_case(case, 8), (1.0, 1.0)
    for case in kernel_cases.LSHAPE_PRIMAL_CASES[:5]:
        yield (case, ls, kernel_cases.lshape_primal_case(case, 8),
               (1.0, 0.5))


@pytest.mark.parametrize("run", list(_escape_runs()),
                         ids=lambda r: f"{r[1].locator.domain}-{r[0]}")
def test_recentred_slots_from_flags_equal_position_compare(run):
    case, ge, (u_img, x0, h, nt), center = run
    center = torch.tensor(center, dtype=torch.float64)
    x, us, failed, kfail = primal_ode_steps_plain(ge, u_img, x0, h, nt)
    ode = finish_trajectories(
        ge.locator, lambda p: eval_velocity_grid(ge, u_img, p), x, us,
        failed, kfail, center)
    by_position = (ode.x == center).all(dim=-1)
    by_flags = recentred_slots(ge.locator, ode.x_raw, ode.mask, ode.kfail)
    assert torch.equal(by_flags, by_position)
    if case == "leave_last_eval":        # unmasked, last slot only
        assert not bool(ode.mask.any())
        assert bool(by_flags[:, -1].all()) and not bool(by_flags[:, :-1].any())
    if case.startswith("leave_step") or case.startswith("leave_reentrant"):
        assert bool(by_flags.all())
    if case == "leave_never":
        assert not bool(by_flags.any())
