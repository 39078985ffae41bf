"""ocean_torch end to end: one gradient-descent step of the scalability
configuration (``bench.py::_build``'s fast paths, cut to Nx=8, K=100,
nt=200) against ocean_jax; the entry points' device rule; the package's
import isolation from JAX.

Tolerances for the GD step: J within 1e-10 relative, f_new and z within
1e-8 relative. The port factors in float64 where JAX applies a float32
explicit inverse with float64 refinement; both Newton solves stop at
rtol 1e-9, and ``bench.py`` records 4e-9 relative gradient drift between
JAX backends of this very configuration.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
from ocean_jax.pipelines.ud_construction import seed_positions

from ocean_torch import convert
from ocean_torch.config import OCPConfig
from ocean_torch import system

FAST = dict(ud_experiment="100_buoys", unit_square_resolution=8,
            use_line_search=False, num_steps=1, psrc_method="fused",
            ode_backend="pallas")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def steps():
    rng = np.random.default_rng(7)
    x0 = seed_positions(100)
    u_d = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    u_d[..., 1] -= 0.1
    cfg_j = JaxConfig(dense_apply="inverse", **FAST)
    pj = jax_system.build_problem(cfg_j, u_d=u_d, x0=x0)
    pj = jax_system.dataclasses.replace(pj, newton_reuse_lu=True)
    fj = jax_system.initial_control(pj, case=4)
    rj = jax_system.gd_step(pj, fj, jnp.asarray(5.0), use_line_search=False)

    cfg_t = OCPConfig(newton_reuse_lu=True, **FAST)
    ud_t, x0_t = convert.problem_data(u_d, x0)
    pt = system.build_problem(cfg_t, u_d=ud_t, x0=x0_t, device="cpu")
    ft = convert.control(fj.quad, fj.p2)
    rt = system.gd_step(pt, ft, 5.0)
    return rj, rt


def test_gd_step_matches_jax(steps):
    rj, rt = steps
    assert not rt.diverged and not bool(rj.diverged)
    assert rt.fwd.newton.converged
    assert abs(float(rt.J) - float(rj.J)) / abs(float(rj.J)) < 1e-10
    assert _rel(rt.f_new.quad, rj.f_new.quad) < 1e-8
    assert _rel(rt.f_new.p2, rj.f_new.p2) < 1e-8
    assert _rel(rt.z, rj.z) < 1e-8
    assert np.array_equal(rt.fwd.mask.numpy(), np.asarray(rj.fwd.mask))
    assert abs(float(rt.div_u) - float(rj.div_u)) < 1e-10


def test_initial_control_matches_jax(steps):
    cfg = OCPConfig(**FAST)
    pj = jax_system.build_problem(JaxConfig(**FAST),
                                  u_d=np.zeros((100, 200, 2)),
                                  x0=seed_positions(100))
    pt = system.build_problem(cfg, u_d=np.zeros((100, 200, 2)),
                              x0=seed_positions(100), device="cpu")
    for case in range(5):
        fj = jax_system.initial_control(pj, case=case)
        ft = system.initial_control(pt, case=case)
        assert np.array_equal(ft.quad.numpy(), np.asarray(fj.quad))
        assert np.array_equal(ft.p2.numpy(), np.asarray(fj.p2))


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    from ocean_torch import resolve_device
    from ocean_torch.parallel import launch
    from ocean_torch.pipelines import (initial_control, limits,
                                       ns_gradcheck, stokes_gradcheck,
                                       ud_construction)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = OCPConfig(**FAST)
    small = OCPConfig(ud_experiment="2_buoys", unit_square_resolution=4,
                      reference_runs_dir=str(tmp_path))
    calls = [lambda: system.build_problem(cfg, u_d=np.zeros((100, 200, 2)),
                                          x0=seed_positions(100)),
             lambda: ud_construction.run(nx=2, K=2, T=0.01),
             lambda: ud_construction.build(2),
             lambda: limits.ensure_ud(cfg, cache_dir="/nonexistent-cache"),
             lambda: stokes_gradcheck.build(nx=2),
             lambda: ns_gradcheck.build(nx=2, K=2),
             lambda: initial_control.run(small, write_artifacts=False),
             lambda: initial_control.run_all_cases_fused(small),
             lambda: launch.spawn(print, 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_unported_branches_raise():
    """The knobs this test once found refused (the float32 chord, the
    continuation on either solver) now build problems that solve; the
    L-shape, the "left" diagonal, the "grid" backend and Armijo too."""
    base = dict(u_d=np.zeros((100, 200, 2)), x0=seed_positions(100),
                device="cpu")
    for kw in (dict(newton_chord_f32=True),
               dict(linear_solver="mg", newton_continuation=2,
                    viscosity=0.2),
               dict(newton_continuation=3, viscosity=0.2)):
        p = dataclasses.replace(
            system.build_problem(OCPConfig(**{**FAST, **kw}), **base),
            solve_log=[])
        res = system.solve_ns(p, system.initial_control(p, 4).quad)
        assert res.converged and all(r["converged"] for r in p.solve_log)
        rungs = [r for r in p.solve_log if r["solve"] == "ns_rung"]
        assert len(rungs) == kw.get("newton_continuation", -1) + 1
    assert p.linear_solver == "dense" and p.fac0.lu.dtype == torch.float64
    # the L-shape, the "left" diagonal, the "grid" ODE backend and the
    # Armijo line search are ported: none raises
    p = system.build_problem(
        OCPConfig(**{**FAST, "L_shape": True, "L_shape_resolution": 4}),
        **base)
    assert p.space.locator.domain == "lshape"
    for kw in (dict(ode_backend="grid"), dict(mesh_diagonal="left"),
               dict(L_shape=True, L_shape_resolution=4,
                    mesh_diagonal="left")):
        q = system.build_problem(OCPConfig(**{**FAST, **kw}), **base)
        assert q.space.locator.diagonal == kw.get("mesh_diagonal", "right")
        assert q.ode_backend == kw.get("ode_backend", "pallas")
    p = system.build_problem(OCPConfig(**FAST), **base)
    res = system.gd_step(p, system.initial_control(p, 4), 5.0,
                         use_line_search=True)
    assert res.inner_iterations >= 1


def test_gd_step_at_viscosity_0_1_matches_jax(monkeypatch):
    """At ν = 0.1 ``adjoint_reuse_lu="auto"`` resolves to off and the
    adjoint runs through ``solve_operator`` (a fresh factorization), with
    the chord Newton taking many more iterations: one GD step of the
    kernels' plain versions against JAX's float64 table paths."""
    rng = np.random.default_rng(7)
    x0 = seed_positions(100)
    u_d = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    u_d[..., 1] -= 0.1
    kw = dict(FAST, viscosity=0.1, newton_reuse_lu=True)
    pj = jax_system.build_problem(
        JaxConfig(**{**kw, "ode_backend": "gather",
                     "psrc_method": "scatter"}), u_d=u_d, x0=x0)
    fj = jax_system.initial_control(pj, case=4)
    rj = jax_system.gd_step(pj, fj, jnp.asarray(5.0), use_line_search=False)
    ud_t, x0_t = convert.problem_data(u_d, x0)
    pt = system.build_problem(OCPConfig(**kw), u_d=ud_t, x0=x0_t,
                              device="cpu")
    assert pt.nu == 0.1 and not pt.adjoint_reuse_lu
    calls = []
    real = system.solve_operator
    monkeypatch.setattr(system, "solve_operator",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rt = system.gd_step(pt, convert.control(fj.quad, fj.p2), 5.0)
    assert calls == [1]
    assert not rt.diverged and rt.fwd.newton.converged
    assert rt.fwd.newton.iterations > 3
    assert abs(float(rt.J) - float(rj.J)) / abs(float(rj.J)) < 1e-10
    assert _rel(rt.f_new.quad, rj.f_new.quad) < 1e-8
    assert _rel(rt.z, rj.z) < 1e-8
    assert np.array_equal(rt.fwd.mask.numpy(), np.asarray(rj.fwd.mask))


def test_import_leaves_jax_out():
    code = ("import sys, ocean_torch, ocean_torch.system, "
            "ocean_torch.pipelines.limits, ocean_torch.convert, "
            "ocean_torch.kernels, ocean_torch.ops.scatter, "
            "ocean_torch.ops.psum_cuda, ocean_torch.ode.cuda_eval, "
            "ocean_torch.ode.adjoint, ocean_torch.adjoint.point_sources, "
            "ocean_torch.opt.driver, ocean_torch.opt.grad_check, "
            "ocean_torch.io, ocean_torch.cli, ocean_torch.pipelines.ocp, "
            "ocean_torch.pipelines.stokes_gradcheck, "
            "ocean_torch.pipelines.ns_gradcheck, "
            "ocean_torch.pipelines.initial_control, "
            "ocean_torch.opt.ensemble, ocean_torch.parallel, "
            "ocean_torch.parallel.launch, ocean_torch.gen1, "
            "ocean_torch.gen1.main, ocean_torch.io.torch_ckpt, "
            "ocean_torch.utils, torch; "
            "from ocean_torch import OCPConfig, load_parameters; "
            "from ocean_torch.io import RunDirectory; "
            "from ocean_torch.ops import (LUSolver, factorize, "
            "solve_refined, StencilTables, build_stencil_tables, "
            "stencil_matvec); "
            "from ocean_torch.opt import grad_check; "
            "assert ocean_torch.OCPConfig is OCPConfig; "
            "assert not torch.cuda.is_initialized(); "
            "bad = [m for m in sys.modules if m in ('jax', 'matplotlib', "
            "'h5py') or m.startswith(('jax.', 'ocean_jax', 'matplotlib.', "
            "'h5py.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert out.returncode == 0, out.stdout + out.stderr
