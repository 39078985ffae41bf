"""ocean_torch end to end on the other domains: one gradient-descent
step of the scalability configuration cut to Nx=8, K=100, nt=200 (as
tests/test_torch_system.py) on the "left" diagonal and through the
"grid" ODE backend, against ocean_jax's float64 gather path; and the
primal ODE of the JAX package's TPU record on the three pipe meshes
(``scripts/pallas_domains_hw.py``, K=512, nt=200) against its float64
gather path on the CPU.

Tolerances (``PERF.md`` §2): J within 1e-10 relative, f_new and z within
1e-8 relative, the escaped buoys equal; the record's trajectories to
1e-10 with escape flags and steps equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
from ocean_jax.pipelines.ud_construction import seed_positions

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem import spaces as jax_spaces
from ocean_jax.ode.primal import solve_primal_ode as jax_primal

from ocean_torch import convert, system
from ocean_torch.config import OCPConfig
from ocean_torch.fem import spaces
from ocean_torch.mesh import structured
from ocean_torch.ode import solve_primal_ode_cuda
from ocean_torch.ode.grideval import make_grideval
import torch_kernel_cases as kc

torch.set_num_threads(2)

BASE = dict(ud_experiment="100_buoys", unit_square_resolution=8,
            use_line_search=False, num_steps=1, newton_reuse_lu=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _data():
    rng = np.random.default_rng(7)
    u_d = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    u_d[..., 1] -= 0.1
    return u_d, seed_positions(100)


_JAX = {}


def _jax_step(**kw):
    """One JAX gd_step on its float64 table paths (built once a config)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        u_d, x0 = _data()
        pj = jax_system.build_problem(JaxConfig(**BASE, **kw), u_d=u_d,
                                      x0=x0)
        fj = jax_system.initial_control(pj, case=4)
        _JAX[key] = (fj, jax_system.gd_step(pj, fj, jnp.asarray(5.0),
                                            use_line_search=False))
    return _JAX[key]


def _port_step(fj, **kw):
    u_d, x0 = _data()
    ud_t, x0_t = convert.problem_data(u_d, x0)
    pt = system.build_problem(OCPConfig(**BASE, **kw), u_d=ud_t, x0=x0_t,
                              device="cpu")
    return pt, system.gd_step(pt, convert.control(fj.quad, fj.p2), 5.0)


def _check(rt, rj):
    assert not rt.diverged and not bool(rj.diverged)
    assert rt.fwd.newton.converged
    assert abs(float(rt.J) - float(rj.J)) / abs(float(rj.J)) < 1e-10
    assert _rel(rt.f_new.quad, rj.f_new.quad) < 1e-8
    assert _rel(rt.f_new.p2, rj.f_new.p2) < 1e-8
    assert _rel(rt.z, rj.z) < 1e-8
    assert np.array_equal(rt.fwd.mask.numpy(), np.asarray(rj.fwd.mask))


@pytest.mark.parametrize("backend,psrc", [("gather", "scatter"),
                                          ("pallas", "fused")])
def test_left_diagonal_gd_step_matches_jax(backend, psrc):
    """mesh_diagonal="left" through system.gd_step: the table paths and
    the four kernels' plain versions against JAX's table paths."""
    fj, rj = _jax_step(mesh_diagonal="left", ode_backend="gather",
                       psrc_method="scatter")
    pt, rt = _port_step(fj, mesh_diagonal="left", ode_backend=backend,
                        psrc_method=psrc)
    assert pt.space.locator.diagonal == "left"
    assert pt.grid is None if backend == "gather" else pt.grid is not None
    _check(rt, rj)
    assert rt.fwd.x.shape == (100, 200, 2)


def test_grid_backend_gd_step_matches_jax():
    """ode_backend="grid": the primal ODE through the half-grid stencil
    (the primal kernel's plain version), the adjoint on the table path,
    as in JAX (system.py::_primal_ode)."""
    fj, rj = _jax_step(ode_backend="grid", psrc_method="scatter")
    pt, rt = _port_step(fj, ode_backend="grid", psrc_method="scatter")
    assert pt.grid is not None and pt.ode_backend == "grid"
    _check(rt, rj)
    _, rg = _port_step(fj, ode_backend="gather", psrc_method="scatter")
    assert float((rt.fwd.x - rg.fwd.x).abs().max()) < 1e-12


# --- the TPU record's three pipe cases (scripts/pallas_domains_hw.py) ---

@pytest.mark.parametrize("case", sorted(kc.PIPE_RECORD))
def test_record_escapes_match_jax(case):
    """Inputs made as scripts/pallas_domains_hw.py makes them (K=512,
    nt=200): the kernel's plain version escapes the buoys JAX's float64
    gather path escapes on the CPU, at the same steps, as many as the TPU
    record holds. Trajectories to 1e-10: 200 steps through a random field
    amplify one-ulp differences of evaluation order past 1e-12 (the
    record's own bar against the TPU kernel is 1e-9)."""
    kw, escapes = kc.PIPE_RECORD[case]
    mj, mt = jax_structured.pipe_mesh(**kw)[0], structured.pipe_mesh(**kw)[0]
    sj, st = jax_spaces.make_space(mj), spaces.make_space(mt, "cpu")
    rng = np.random.default_rng(7)
    u = 0.6 * rng.standard_normal((st.n_p2, 2))
    K, nt, h = 512, 200, 0.005
    x0 = rng.uniform(0.05, 1.95, (K, 2))
    center = np.array([1.0, 1.0])
    ref = jax_primal(sj, jnp.asarray(u), jnp.asarray(x0), h, nt,
                     jnp.asarray(center))
    res = solve_primal_ode_cuda(make_grideval(st), torch.as_tensor(u),
                                torch.as_tensor(x0), h, nt,
                                torch.as_tensor(center))
    assert np.array_equal(res.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(res.kfail.numpy(), np.asarray(ref.kfail))
    for f in ("x", "u_values", "x_raw"):
        assert float(np.abs(getattr(res, f).numpy()
                            - np.asarray(getattr(ref, f))).max()) < 1e-10
    assert int(res.mask.sum()) == int(ref.mask.sum()) == escapes
