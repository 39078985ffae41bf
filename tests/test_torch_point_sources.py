"""ocean_torch parity: point-source RHS (kernel 3's plain version, method
"fused", and the plain method "scatter") against ocean_jax at nt=200.

Inputs are system-consistent (an unmasked buoy's points all lie inside;
masked buoys sit at the center; u_values are u evaluated along the
trajectory), as the fused method assumes and ``system._forward``
produces.

Tolerances: 1e-12 absolute against the JAX float64 "scatter" path. The
fused twin sums fixed-point limbs exactly (error ≤ n·2⁻⁸¹·scale per
entry, see ``csrc/point_sources.cu``), so what remains is the float64
rounding of each basis-weighted term in either package. Against the JAX
fused kernel in interpret mode: 5e-6 relative to the RHS scale, the bound
the JAX package holds its interpreted kernel to (tests/test_psrc_fused.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem import make_space as jax_make_space
from ocean_jax.fem.interpolate import eval_velocity as jax_eval_velocity
from ocean_jax.adjoint import point_source_rhs as jax_psrc
from ocean_jax.ode.grideval import make_grideval as jax_make_grideval

from ocean_torch.mesh import structured
from ocean_torch.fem import make_space
from ocean_torch.fem.interpolate import eval_velocity
from ocean_torch.adjoint import point_source_rhs
from ocean_torch.adjoint.cuda_psrc import point_source_limbs
from ocean_torch.ode.grideval import make_grideval

K, NT, H = 16, 200, 0.005


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    sj, st = jax_make_space(mj), make_space(mt, "cpu")
    center = np.array([1.0, 1.0])
    c = st.dof_coords_p2.numpy()
    u = np.stack([0.3 * np.sin(c[:, 1]), -0.3 * np.cos(c[:, 0])], axis=1)
    x = rng.uniform(0.0, 2.0, (K, NT, 2))
    x[3, 7] = [0.0, 2.0]                   # on the boundary corner
    x[5, :, 0] = 2.0                       # along the right edge
    mask = np.zeros(K, bool)
    mask[[4, 9]] = True
    x[mask] = center
    u_values = np.array(jax_eval_velocity(sj, jnp.asarray(u),
                                          jnp.asarray(x))[0])
    mu = rng.standard_normal((K, NT, 2))
    u_d = rng.standard_normal((K, NT, 2))
    args = (u, x, mu, u_d, mask)
    return dict(sj=sj, st=st, center=center, u_values=u_values,
                jx=tuple(jnp.asarray(a) for a in args),
                tt=tuple(torch.as_tensor(a) for a in args))


def _jax(case, method, **kw):
    return np.asarray(jax_psrc(case["sj"], *case["jx"], H,
                               jnp.asarray(case["center"]), method=method,
                               **kw))


def _torch(case, method, **kw):
    return point_source_rhs(case["st"], *case["tt"], H,
                            torch.as_tensor(case["center"]), method=method,
                            **kw).numpy()


def test_scatter_matches_jax(case):
    b_j = _jax(case, "scatter")
    assert np.abs(_torch(case, "scatter") - b_j).max() < 1e-12


def test_fused_twin_matches_jax_scatter(case):
    b_j = _jax(case, "scatter")
    b_t = _torch(case, "fused", grid=make_grideval(case["st"]),
                 u_values=torch.as_tensor(case["u_values"]))
    assert np.abs(b_t - b_j).max() < 1e-12
    # reproducible to the bit
    b_t2 = _torch(case, "fused", grid=make_grideval(case["st"]),
                  u_values=torch.as_tensor(case["u_values"]))
    assert np.array_equal(b_t, b_t2)


def test_fused_twin_matches_jax_fused_interpret(case):
    b_j = _jax(case, "fused", grid=jax_make_grideval(case["sj"]),
               u_values=jnp.asarray(case["u_values"]))
    b_t = _torch(case, "fused", grid=make_grideval(case["st"]),
                 u_values=torch.as_tensor(case["u_values"]))
    scale = float(np.abs(b_j).max())
    assert np.abs(b_t - b_j).max() < 5e-6 * max(scale, 1.0)


def test_fused_transpose_identity():
    """⟨PS(γ at p), w⟩ == γ · w(p): u = 0, μ = 0, u_d = γ/h plants exact
    γ sources."""
    st = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 6, 6),
                    "cpu")
    grid = make_grideval(st)
    rng = np.random.default_rng(5)
    w_vel = torch.as_tensor(rng.standard_normal((st.n_p2, 2)))
    pts = torch.as_tensor(0.2 + 1.6 * rng.random((2, 5, 2)))
    gamma = torch.as_tensor(rng.standard_normal((2, 5, 2)))
    zeros = torch.zeros(2, 5, 2, dtype=torch.float64)
    b = point_source_rhs(st, torch.zeros(st.n_p2, 2, dtype=torch.float64),
                         pts, zeros, gamma, torch.tensor([False, False]),
                         1.0, torch.tensor([1.0, 1.0], dtype=torch.float64),
                         method="fused", grid=grid, u_values=zeros)
    lhs = float(b[: 2 * st.n_p2] @ w_vel.reshape(-1))
    w_at_p, _ = eval_velocity(st, w_vel, pts)
    rhs = float(torch.sum(gamma * w_at_p))
    assert np.isclose(lhs, rhs, rtol=1e-12)


def test_limbs_sum_exactly():
    """The fixed-point limbs of Σ r φ equal an exact (math.fsum) sum of
    the float64 terms to 2⁻⁶⁰."""
    import math
    from ocean_torch.ode.grideval import grid_coords, p2_patch_weights
    st = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 2, 2),
                    "cpu")
    grid = make_grideval(st)
    rng = np.random.default_rng(2)
    pts = torch.as_tensor(rng.uniform(0.0, 2.0, (3000, 2)))
    r = torch.as_tensor(rng.uniform(-1.0, 1.0, (3000, 2)))
    hi, lo = point_source_limbs(grid, pts, r)
    img = hi.double() * 2.0 ** -40 + lo.double() * 2.0 ** -80
    ix, iy, s, t = grid_coords(grid.locator, pts)
    W = p2_patch_weights(s, t).reshape(-1, 9)
    Hx = grid.hg_shape[1]
    nodes = ((2 * iy) * Hx + 2 * ix)[:, None] + torch.tensor(
        [b * Hx + a for b in range(3) for a in range(3)])
    terms = {}
    for m in range(3000):
        for j in range(9):
            for c in range(2):
                terms.setdefault((int(nodes[m, j]), c), []).append(
                    float(W[m, j] * r[m, c]))
    for (node, c), vals in terms.items():
        assert abs(float(img[node, c]) - math.fsum(vals)) < 2.0 ** -60


def test_fused_last_step_outside_unmasked():
    """A buoy whose FINAL evaluation fails is NOT masked: the primal
    stores u_values[nt-1]=0 / x[nt-1]=center, and the reference's psrc
    loop re-evaluates at the stored center, getting u(center) != 0. The
    fused path's at-center substitution must reproduce the scatter path
    (port of the JAX package's regression test)."""
    from ocean_torch.config import OCPConfig
    from ocean_torch import system as sys_mod, control as ctrl_mod

    rng = np.random.default_rng(3)
    Kb = 64
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment=f"{Kb}_buoys",
                    T=0.25, dt=0.005, ode_backend="pallas")
    u_d = 0.05 * rng.standard_normal((Kb, cfg.num_time_steps, 2))
    x0 = np.column_stack([1.2 + 0.7 * rng.random(Kb),
                          0.3 + 1.4 * rng.random(Kb)])
    prob = sys_mod.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    f = ctrl_mod.constant(prob.space, prob.bq, [3.0, 0.0])
    p_sc = dataclasses.replace(prob, psrc_method="scatter",
                               ode_backend="gather")
    fwd = sys_mod._forward(p_sc, f.quad)
    center_last = ((fwd.x[:, -1] == prob.center).all(dim=1) & ~fwd.mask)
    assert bool(center_last.any()), "setup no longer hits the edge case"
    b_sc = sys_mod.adjoint_rhs(p_sc, fwd)
    b_fu = sys_mod.adjoint_rhs(
        dataclasses.replace(prob, psrc_method="fused"), fwd)
    d = float((b_fu - b_sc).abs().max() / b_sc.abs().max())
    assert d < 1e-12, d
