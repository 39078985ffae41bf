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


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from ocean_torch import resolve_device
    from ocean_torch.pipelines import limits, ud_construction
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = OCPConfig(**FAST)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        system.build_problem(cfg, u_d=np.zeros((100, 200, 2)),
                             x0=seed_positions(100))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ud_construction.run(nx=2, K=2, T=0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        limits.ensure_ud(cfg, cache_dir="/nonexistent-cache")
    assert resolve_device("cpu").type == "cpu"


def test_unported_branches_raise():
    base = dict(u_d=np.zeros((100, 200, 2)), x0=seed_positions(100),
                device="cpu")
    for kw in (dict(L_shape=True), dict(adjoint_mode="consistent"),
               dict(linear_solver="mg"), dict(newton_continuation=3),
               dict(ode_backend="grid"), dict(psrc_method="ozaki")):
        with pytest.raises(NotImplementedError):
            system.build_problem(OCPConfig(**{**FAST, **kw}), **base)
    p = system.build_problem(OCPConfig(**FAST), **base)
    with pytest.raises(NotImplementedError):
        system.gd_step(p, system.initial_control(p, 4), 5.0,
                       use_line_search=True)


def test_import_leaves_jax_out():
    code = ("import sys, ocean_torch, ocean_torch.system, "
            "ocean_torch.pipelines.limits, ocean_torch.convert, "
            "ocean_torch.kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('ocean_jax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert out.returncode == 0, out.stdout + out.stderr
