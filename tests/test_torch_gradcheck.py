"""ocean_torch parity: the two gradient-check harnesses and their parts
against ocean_jax, on the CPU.

* Parts at Nx=6: the Γ₁ load, the volume tracking cost and its adjoint
  load, the velocity difference norms, and the NS residual and Jacobian
  with ``boundary_stab=False`` and the "off" and "tanh" backflow modes
  (dense matrices), 1e-13 relative; ``from_p2``, ``scale`` and
  ``boundary_l2_sq`` 1e-14; the configuration's round trip.
* The implicit adjoint ODE with both ``ud_index`` values on trajectories
  of which one buoy leaves the domain: 1e-12.
* The Stokes check at nx=8: w, J0 and ‖div u‖ 1e-12 relative, gradj
  1e-10, the finite-difference rows for h ≥ 1e-5 1e-7 relative between
  the packages, the closure the JAX package asserts, and autograd through
  ``solve_state`` against gradj, 1e-9.
* The NS+ODE check at nx=6, K=3: J0 1e-10, gradj 1e-9, and the two table
  files row by row. The JAX Newton stops at rtol 1e-9 on float32 factors,
  so its J carries ~1e-13 of noise and its quotients ~1e-13/h; each row
  is held to 2e-12/h absolute (the port's float64 Newton lands at
  round-off).
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_jax import config as jax_config, control as jax_ctrl
from ocean_jax.fem import (assemble as jax_assemble, spaces as jax_spaces,
                           interpolate as jax_interp)
from ocean_jax.mesh import structured as jax_structured
from ocean_jax.ode import adjoint as jax_adjoint
from ocean_jax.pipelines import (ns_gradcheck as jax_ns,
                                 stokes_gradcheck as jax_stokes)
from ocean_jax.solve import projection as jax_projection

from ocean_torch import config, control as ctrl_mod
from ocean_torch.fem import assemble, spaces
from ocean_torch.mesh import structured
from ocean_torch.ode import solve_adjoint_ode_implicit
from ocean_torch.pipelines import ns_gradcheck, stokes_gradcheck
from ocean_torch.solve import projection

torch.set_num_threads(2)

N = 6
_G1 = lambda x: np.abs(x[:, 0]) < 1e-12
_G2 = lambda x: x[:, 0] > 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def both():
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), N, N)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), N, N)
    sj, st = jax_spaces.make_space(mj), spaces.make_space(mt, "cpu")
    tags = jax_structured.mark_boundary_facets(mj, _G1)
    bj = jax_spaces.make_boundary_quad(mj, tags)
    bt = spaces.make_boundary_quad(mt, tags, device="cpu")
    dj, _ = jax_spaces.dirichlet_velocity_bc(mj, sj, _G2)
    dt_, _ = spaces.dirichlet_velocity_bc(mt, st, _G2)
    rng = np.random.default_rng(11)
    return dict(sj=sj, st=st, bj=bj, bt=bt, dj=dj, dt=dt_, rng=rng,
                w=0.3 * rng.standard_normal(st.ndof),
                fq=0.2 * rng.standard_normal(tuple(bt.points.shape)))


def test_boundary_load_and_tracking_parts(both):
    b = both
    rng = b["rng"]
    assert _rel(assemble.boundary_load(b["st"], b["bt"],
                                       torch.as_tensor(b["fq"])),
                jax_assemble.boundary_load(b["sj"], b["bj"],
                                           jnp.asarray(b["fq"]))) < 1e-13
    u = rng.standard_normal((b["st"].n_p2, 2))
    u_ref = rng.standard_normal((b["st"].n_p2, 2))
    ud = np.array([1.0, -0.5])
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    assert _rel(assemble.l2_tracking_volume(b["st"], ut,
                                            torch.as_tensor(ud)),
                jax_assemble.l2_tracking_volume(b["sj"], uj,
                                                jnp.asarray(ud))) < 1e-13
    assert _rel(assemble.volume_tracking_rhs(b["st"], ut,
                                             torch.as_tensor(ud)),
                jax_assemble.volume_tracking_rhs(b["sj"], uj,
                                                 jnp.asarray(ud))) < 1e-13
    nt = assemble.velocity_diff_norms(b["st"], ut, torch.as_tensor(u_ref))
    nj = jax_assemble.velocity_diff_norms(b["sj"], uj, jnp.asarray(u_ref))
    for a, c in zip(nt, nj):
        assert _rel(a, c) < 1e-13


@pytest.mark.parametrize("backflow,stab", [("none", False), ("off", True),
                                           ("tanh", True)])
def test_ns_residual_and_operator_backflow(both, backflow, stab):
    b = both
    kw = dict(backflow=backflow, boundary_stab=stab)
    wt, wj = torch.as_tensor(b["w"]), jnp.asarray(b["w"])
    for fq in (None, b["fq"]):
        rt = assemble.ns_residual(b["st"], b["bt"], wt,
                                  None if fq is None else torch.as_tensor(fq),
                                  1.0, **kw)
        rj = jax_assemble.ns_residual(b["sj"], b["bj"], wj,
                                      None if fq is None else jnp.asarray(fq),
                                      1.0, **kw)
        assert _rel(rt, rj) < 1e-13
    ot = assemble.ns_operator(b["st"], b["bt"], wt, 1.0, b["dt"], **kw)
    oj = jax_assemble.ns_operator(b["sj"], b["bj"], wj, 1.0, b["dj"], **kw)
    assert (ot.facet_mats is None) == (oj.facet_mats is None) == (not stab)
    assert _rel(ot.dense(), oj.dense(jnp.float64)) < 1e-13
    if backflow == "off":
        # the load stays, the Γ₁ term goes: the residual is the one
        # without boundary_stab
        r_off = assemble.ns_residual(b["st"], b["bt"], wt,
                                     torch.as_tensor(b["fq"]), 1.0,
                                     boundary_stab=False)
        r_kw = assemble.ns_residual(b["st"], b["bt"], wt,
                                    torch.as_tensor(b["fq"]), 1.0, **kw)
        assert torch.equal(r_off, r_kw)


def test_control_parts(both):
    b = both
    rng = b["rng"]
    u = rng.standard_normal((b["st"].n_p2, 2))
    cj = jax_ctrl.from_p2(b["sj"], b["bj"], jnp.asarray(u))
    ct = ctrl_mod.from_p2(b["st"], b["bt"], torch.as_tensor(u))
    assert _rel(ct.quad, cj.quad) < 1e-14
    assert np.array_equal(ct.p2.numpy(), u)
    sj, st = cj.scale(-0.37), ct.scale(-0.37)
    assert _rel(st.quad, sj.quad) < 1e-14 and _rel(st.p2, sj.p2) < 1e-14
    assert abs(float(ctrl_mod.boundary_l2_sq(b["bt"], ct))
               / float(jax_ctrl.boundary_l2_sq(b["bj"], cj)) - 1) < 1e-14


def test_config_round_trip(tmp_path):
    params = {"viscosity": 0.5, "t0": 0.1, "T": 2.0, "dt": 0.01,
              "alpha": 3e-6}
    path = tmp_path / "parameters.json"
    path.write_text(json.dumps(params))
    assert config.load_parameters(str(path)) == \
        jax_config.load_parameters(str(path)) == params
    ct = config.OCPConfig(ud_experiment="6_buoys").with_parameters(
        config.load_parameters(str(path)))
    cj = jax_config.OCPConfig(ud_experiment="6_buoys").with_parameters(
        params)
    dt_, dj = ct.to_dict(), cj.to_dict()
    dt_.pop("reference_runs_dir"), dj.pop("reference_runs_dir")
    assert dt_ == dj
    assert ct.viscosity == 0.5 and ct.num_time_steps == 200
    # a partial dict leaves the other fields alone
    assert config.OCPConfig().with_parameters({"T": 3.0}) == \
        dataclasses.replace(config.OCPConfig(), T=3.0)


@pytest.mark.parametrize("ud_index", ["k", "k+1"])
def test_implicit_adjoint_ode_matches_jax(both, ud_index):
    b = both
    rng = np.random.default_rng(12)
    K, nt, h = 5, 40, 0.005
    u = 0.5 * rng.standard_normal((b["st"].n_p2, 2))
    x = 0.3 + 1.4 * rng.random((K, 1, 2)) \
        + np.cumsum(0.01 * rng.standard_normal((K, nt, 2)), axis=1)
    # one buoy leaves through x = 2 half way (the inside flag is ignored:
    # clamped evaluation beyond the boundary, in both packages)
    x[1, :, 0] = np.linspace(1.9, 2.3, nt)
    u_d = 0.1 * rng.standard_normal((K, nt, 2))
    gt = projection.GradProjector.build(b["st"]).project(
        b["st"], torch.as_tensor(u))
    gj = jax_projection.GradProjector.build(b["sj"]).project(
        b["sj"], jnp.asarray(u))
    mt = solve_adjoint_ode_implicit(b["st"], gt, torch.as_tensor(u),
                                    torch.as_tensor(x), torch.as_tensor(u_d),
                                    h, ud_index=ud_index)
    mj = jax_adjoint.solve_adjoint_ode_implicit(
        b["sj"], gj, jnp.asarray(u), jnp.asarray(x), jnp.asarray(u_d), h,
        ud_index=ud_index)
    assert not bool(jax_interp.eval_velocity(b["sj"], jnp.asarray(u),
                                             jnp.asarray(x[1, -1]))[1])
    assert float(mt.abs().max()) > 1e-3 and bool((mt[:, -1] == 0).all())
    assert _rel(mt, mj) < 1e-12


@pytest.fixture(scope="module")
def stokes():
    pj, pt = jax_stokes.build(nx=8), stokes_gradcheck.build(nx=8,
                                                             device="cpu")
    ks = range(3, 8)
    return pt, jax_stokes.gradient_tables(pj, ks=ks), \
        stokes_gradcheck.gradient_tables(pt, ks=ks)


def test_stokes_gradcheck_matches_jax(stokes):
    pt, rj, rt = stokes
    assert _rel(rt["w"], rj["w"]) < 1e-12
    assert abs(rt["J0"] / rj["J0"] - 1) < 1e-12
    assert abs(rt["div_l2"] / rj["div_l2"] - 1) < 1e-12
    assert abs(rt["gradj"] / rj["gradj"] - 1) < 1e-10
    for key in ("one_sided", "centered"):
        for (at, _, ht), (aj, _, hj) in zip(rt[key], rj[key]):
            assert ht == hj
            if ht >= 1e-5:
                assert abs(at / aj - 1) < 1e-7, (key, ht, at, aj)
    # the JAX package's closure (tests/test_stokes_gradcheck.py)
    errs = {h: err for _, err, h in rt["centered"]}
    assert errs[1e-5] / abs(rt["gradj"]) < 1e-8
    assert 0 < rt["div_l2"] < 1.0
    # the printed run: the reference script's lines
    lines = []
    stokes_gradcheck.run(nx=4, out=lines.append, device="cpu")
    assert lines[0] == "Gradient, one sided Approximation, Error, h"
    assert lines[-1].startswith("||div u||_L2 =  ")


def test_stokes_autograd_equals_adjoint_gradient(stokes):
    pt, _, rt = stokes
    f = stokes_gradcheck.default_control(pt)
    fq = f.quad.clone().requires_grad_(True)
    j = stokes_gradcheck.cost(pt, stokes_gradcheck.solve_state(pt, fq), fq)
    (g,) = torch.autograd.grad(j, fq)
    directional = float(torch.sum(g * f.quad))
    assert abs(directional / rt["gradj"] - 1) < 1e-9


def _table(path):
    rows = [line.split() for line in Path(path).read_text().splitlines()[1:]]
    return np.array(rows, dtype=np.float64)


def test_ns_gradcheck_matches_jax(tmp_path):
    ks = range(3, 6)
    rj = jax_ns.run(nx=6, K=3, ks=ks, out_dir=str(tmp_path / "jax"),
                    verbose=lambda s: None)
    rt = ns_gradcheck.run(nx=6, K=3, ks=ks, out_dir=str(tmp_path / "torch"),
                          verbose=lambda s: None, device="cpu")
    assert abs(rt["J0"] / rj["J0"] - 1) < 1e-10
    assert abs(rt["gradj"] / rj["gradj"] - 1) < 1e-9
    for name in ("grad_J_error_0.txt", "grad_J_error_centered_0.txt"):
        tt, tj = _table(tmp_path / "torch" / name), _table(tmp_path / "jax"
                                                           / name)
        assert tt.shape == tj.shape == (3, 4)
        assert np.array_equal(tt[:, 3], tj[:, 3])                # h
        assert np.allclose(tt[:, 0], tj[:, 0], rtol=1e-9, atol=0)  # gradj
        assert np.all(np.abs(tt[:, 1] - tj[:, 1]) < 2e-12 / tt[:, 3])
        assert np.all(np.abs(tt[:, 2] - tj[:, 2]) < 2e-12 / tt[:, 3])
    # the harness's quotient has settled; its gap to gradj is the
    # implicit, P1-projected adjoint's consistency floor (1e-2 at nx=6,
    # as in the JAX package)
    cen = [a for a, _, _ in rt["centered"]]
    assert abs(cen[1] / cen[0] - 1) < 1e-6
    assert abs(cen[0] / rt["gradj"] - 1) < 5e-2
