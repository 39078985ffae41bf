"""The gen-1 class API (``ocean_torch/gen1``) against ``ocean_jax.gen1``.

Tolerances: the four element residuals within 1e-13 of the largest entry
(same float64 forms). The solver steps run at nx=4 with
``ODESolver(dt=0.05)``; the two ODE steps take the same velocity in both
packages (JAX's state) and agree within 1e-10 of the largest entry, as
does the Stokes solve. The Newton state is held to the solve's own
accuracy: both packages stop after 2 iterations at rtol 1e-10 (residual
~2e-11), and JAX's iterate, whose linear solves use float32 factors with
float64 refinement, lies 2.3e-9 of max|w| from the converged state (the
port's 2.1e-10); so the states agree within 1e-8, and JAX's state
satisfies the port's equations to Newton's stopping test (residual norm
below its atol 1e-10). The driver's J list agrees within 1e-10
relative. The FD helpers are imported as a module: their gen-1 names
start with ``test_``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ocean_jax import control as jax_ctrl
from ocean_jax.fem import (make_space as jax_make_space,
                           make_boundary_quad as jax_make_bq,
                           dirichlet_velocity_bc as jax_dirichlet)
from ocean_jax.mesh import (unit_square_mesh as jax_unit_square,
                            mark_boundary_facets as jax_mark)
from ocean_jax.gen1 import NavierStokesSolver as JaxNS, ODESolver as JaxODE
from ocean_jax.gen1 import (forms as jax_forms, helpers as jax_helpers,
                            main as jax_main)

from ocean_torch import control as ctrl_mod
from ocean_torch.fem import (make_space, make_boundary_quad,
                             dirichlet_velocity_bc, assemble)
from ocean_torch.mesh import (unit_square_mesh, mark_boundary_facets,
                              structured)
from ocean_torch.gen1 import NavierStokesSolver, ODESolver, forms, helpers
from ocean_torch.gen1 import main as gen1_main

torch.set_num_threads(2)

EPS = 1e-12
NX = 4


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inlet(x):
    return np.abs(x[:, 0]) < EPS


def _walls(x):
    return x[:, 0] > EPS


def _q0(x):
    return np.stack([x[:, 1] * (1 - x[:, 1]), np.zeros(len(x))], axis=1)


@pytest.fixture(scope="module")
def pair():
    """(JAX, port) space, boundary quadrature, BCs, NS and ODE solvers and
    initial control at nx=4, dt=0.05."""
    out = []
    for mk_mesh, mk_space, mk_bq, mark, bc, ctrl, NS, ODE, kw in (
            (jax_unit_square, jax_make_space, jax_make_bq, jax_mark,
             jax_dirichlet, jax_ctrl, JaxNS, JaxODE, {}),
            (unit_square_mesh, make_space, make_boundary_quad,
             mark_boundary_facets, dirichlet_velocity_bc, ctrl_mod,
             NavierStokesSolver, ODESolver, {"device": "cpu"})):
        mesh = mk_mesh(NX)
        space = mk_space(mesh, **kw)
        bq = mk_bq(mesh, mark(mesh, _inlet), tag=1, **kw)
        bcs = bc(mesh, space, _walls)
        ns = NS(space, bq, *bcs, **kw)
        ode = ODE(space, 2, dt=0.05, **kw)
        out.append((space, bq, ns, ode, ctrl.from_expression(space, bq, _q0)))
    return out


@pytest.fixture(scope="module")
def steps(pair):
    """Both packages through one gen-1 iteration's solver steps; the ODE
    steps of both take JAX's velocity."""
    res = []
    u_ref = None
    for space, bq, ns, ode, q in pair:
        w_r = ns.solve_stokes_step(q)
        w = ns.state_solving_step(q)
        if u_ref is None:
            u_ref = np.array(space.split(w)[0])
            u = u_ref
        else:
            u = torch.as_tensor(u_ref)
        x = ode.ode_solving_step(u)
        lam = ode.adjoint_ode_solving_step(u)
        res.append({"stokes": w_r, "state": w, "ode": x, "adjoint_ode": lam,
                    "u": u})
    return res


def _local_inputs(seed, space_t):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(15), rng.standard_normal(15),
            rng.standard_normal((3, 6)), np.array([0.6, -0.8]),
            rng.random(3), rng.standard_normal((3, 2)))


@pytest.mark.parametrize("name", ["ns_cell", "ns_facet", "adjoint_cell",
                                  "adjoint_facet"])
def test_residuals_match_jax(pair, name):
    (sj, *_), (st, *_) = pair
    zl, wl, phi2f, nrm, wts, qv = _local_inputs(1, st)
    ji, dj = st.cell_jinv[3], st.cell_detj[3]
    t = lambda a: torch.as_tensor(a)
    j = jnp.asarray
    nu, delta = 0.7, 0.1
    if name == "ns_cell":
        got = forms.gen1_ns_cell_residual(st, t(wl), ji, dj, nu)
        ref = jax_forms.gen1_ns_cell_residual(sj, j(wl), sj.cell_jinv[3],
                                              sj.cell_detj[3], nu)
    elif name == "ns_facet":
        got = forms.gen1_ns_facet_residual(t(wl), t(phi2f), t(nrm), t(wts),
                                           t(qv), delta)
        ref = jax_forms.gen1_ns_facet_residual(j(wl), j(phi2f), j(nrm),
                                               j(wts), j(qv), delta)
    elif name == "adjoint_cell":
        got = forms.gen1_adjoint_cell_residual(st, t(zl), t(wl), ji, dj, nu)
        ref = jax_forms.gen1_adjoint_cell_residual(
            sj, j(zl), j(wl), sj.cell_jinv[3], sj.cell_detj[3], nu)
    else:
        got = forms.gen1_adjoint_facet_residual(t(zl), t(wl), t(phi2f),
                                                t(nrm), t(wts), delta)
        ref = jax_forms.gen1_adjoint_facet_residual(
            j(zl), j(wl), j(phi2f), j(nrm), j(wts), delta)
    assert _rel(got.numpy(), ref) <= 1e-13


@pytest.mark.parametrize("name", ["stokes", "state", "ode", "adjoint_ode"])
def test_solver_steps_match_jax(pair, steps, name):
    ref, got = steps[0][name], steps[1][name]
    assert got.shape == tuple(np.shape(ref))
    if name != "state":
        assert _rel(got.numpy(), ref) <= 1e-10
        return
    assert _rel(got.numpy(), ref) <= 1e-8
    _, _, ns, _, q = pair[1]
    w_jax = torch.as_tensor(np.array(ref))

    def residual(w):
        return ns._residual(w, q.quad).index_fill(0, ns.bc_dofs, 0.0)

    assert float(residual(w_jax).norm()) <= 1e-10      # Newton's atol


def test_driver_matches_jax(monkeypatch):
    """Two steps with the centred FD check: J, the final control, gradj
    and the FD rows. JAX's driver prints its rows; its helper is wrapped
    to record them. The quotients divide J's differences by 2h, so a
    row agrees within 1e-10·|J|/h (J's tolerance carried through) and
    its h exactly; gradj, an adjoint solve that JAX makes with float32
    factors and float64 refinement, within 1e-9 relative (2.4e-10 seen),
    and the rows' errors |quotient − gradj| within the sum."""
    rec = {}
    fd = jax_helpers.test_gradient_centered_finite_differences_NS

    def recording(*args, **kw):
        rec["gradj"], rec["rows"] = args[4], fd(*args, **kw)
        return rec["rows"]

    monkeypatch.setattr(jax_helpers,
                        "test_gradient_centered_finite_differences_NS",
                        recording)
    ref = jax_main.run(nx=NX, K=2, num_steps=2, verbose=False,
                       grad_check=True)
    got = gen1_main.run(nx=NX, K=2, num_steps=2, verbose=False,
                        grad_check=True, device="cpu")
    assert len(got["J"]) == 2
    for a, b in zip(got["J"], ref["J"]):
        assert abs(a - b) <= 1e-10 * abs(b)
    assert _rel(got["q"].quad.numpy(), ref["q"].quad) <= 1e-10
    assert abs(got["gradj"] - rec["gradj"]) <= 1e-9 * abs(rec["gradj"])
    assert len(got["grad_check"]) == len(rec["rows"]) == 6
    for (gc, err, h), (gc_j, err_j, h_j) in zip(got["grad_check"],
                                                rec["rows"]):
        assert h == h_j
        assert abs(gc - gc_j) <= 1e-10 * abs(ref["J"][0]) / h
        assert abs(err - err_j) <= 1e-10 * abs(ref["J"][0]) / h + \
            1e-9 * abs(rec["gradj"])


def test_eval_vector_field_samples_the_field(pair, steps):
    """The quiver sampling against JAX's helper on the same field: the
    grid of points exactly, the values within 1e-13 of the largest, 0 at
    the points outside the domain (x < 0)."""
    (sj, *_), (st, *_) = pair
    kw = dict(nx=7, extent=(-0.5, 0.0, 1.0, 1.0))
    got = helpers.eval_vector_field(st, steps[1]["u"], **kw)
    ref = jax_helpers.eval_vector_field(sj, steps[0]["u"], **kw)
    for k in ("x", "y"):
        assert np.array_equal(got[k], ref[k])
    for k in ("u", "v"):
        assert _rel(got[k], ref[k]) <= 1e-13
    assert np.all(got["u"][got["x"] < 0] == 0.0)
    assert np.abs(got["u"][got["x"] > 0]).max() > 0


def test_rhs_control_matches_jax(pair):
    """The volume-force FD helper against JAX's at the same f, df and h
    (1e-1, 1e-2). A row's quotient is a difference of two J's (~0.119
    here) divided by h, and the packages' J's agree to ~2e-14 (JAX's
    Newton solves through float32 factors with float64 refinement), so
    the quotients agree within 1e-12/h, about 1e-11 of J over h. Then
    the port's one-sided quotients settle as h falls (h = 1e-3..1e-5:
    the forward map is smooth in the control)."""
    rows = []
    for (space, bq, ns, ode, _), mod, arr in zip(
            pair, (jax_helpers, helpers), (jnp.asarray, torch.as_tensor)):
        f = arr(np.full((space.n_p2, 2), 0.05))
        df = arr(np.full((space.n_p2, 2), 0.1))
        rows.append(mod.test_gradient_on_rhs_control(
            space, bq, (ns.bc_dofs, ns.bc_vals), ode, f, df, 0.0,
            ks=(1, 2)))
    for (q, err, h), (q_j, err_j, h_j) in zip(rows[1], rows[0]):
        assert h == h_j
        assert abs(q - q_j) <= 1e-12 / h and abs(err - err_j) <= 1e-12 / h
    space, bq, ns, ode, _ = pair[1]
    f = torch.full((space.n_p2, 2), 0.05, dtype=torch.float64)
    df = torch.full((space.n_p2, 2), 0.1, dtype=torch.float64)
    rows = helpers.test_gradient_on_rhs_control(
        space, bq, (ns.bc_dofs, ns.bc_vals), ode, f, df, 0.0, ks=(3, 4, 5))
    q = [r[0] for r in rows]
    assert abs(q[2] - q[1]) < 0.2 * abs(q[1] - q[0]) + 1e-12


def test_ode_escape_raises(pair):
    space, *_ = pair[1]
    ode = ODESolver(space, 2, dt=0.05, device="cpu")
    u = torch.zeros(space.n_p2, 2, dtype=torch.float64)
    u[:, 0] = -10.0                     # sweeps every buoy out through x=0
    with pytest.raises(RuntimeError, match="left the domain"):
        ode.ode_solving_step(u)


def test_solvers_need_the_device_of_the_space(pair, monkeypatch):
    space, bq, ns, *_ = pair[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NavierStokesSolver(space, bq, ns.bc_dofs, ns.bc_vals)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen1_main.run(nx=NX, K=2, num_steps=1, verbose=False)


def test_graded_pipe_stokes_solve():
    """The gen-1 Stokes solve on a graded pipe mesh (the counterpart of
    ``tests/test_graded_mesh.py::test_graded_mesh_stokes_solve``)."""
    mesh, _ = structured.pipe_mesh(obstacle=False, graded=True,
                                   lc_min=0.08, lc_max=0.3)
    assert not mesh.uniform
    space = make_space(mesh, "cpu")
    bq = make_boundary_quad(mesh, mark_boundary_facets(mesh, _inlet), tag=1,
                            device="cpu")
    bc = dirichlet_velocity_bc(mesh, space, _walls)
    ns = NavierStokesSolver(space, bq, *bc, alpha=1e-2, device="cpu")
    q = ctrl_mod.from_expression(
        space, bq, lambda x: np.stack([x[:, 1] * (2 - x[:, 1]) / 4,
                                       np.zeros(len(x))], axis=1))
    w = ns.solve_stokes_step(q)
    u, p = space.split(w)
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(p).all())
    assert float(u.abs().max()) > 1e-6
    assert float(assemble.divergence_l2(space, u)) < 0.05
