"""ocean_torch parity: NS residual and Jacobian, adjoint operator, P1
mass and ∇u projection, scalar functionals, and the dense solves against
ocean_jax, all in float64 at Nx=6.

Tolerance 1e-12 relative: both sides evaluate the same element formulas
in float64; only the summation order of the quadrature contractions and
of the dof reductions differs (≤ 1e-15 relative in practice). The solves
compare a float64 LU (port) with the JAX float32 factor plus float64
refinement, both converged to ~1e-15 relative residual.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem import spaces as jax_spaces, assemble as jax_assemble
from ocean_jax.solve import projection as jax_projection
from ocean_jax.solve import linear as jax_linear
from ocean_jax.ops import linalg as jax_linalg

from ocean_torch.mesh import structured
from ocean_torch.fem import spaces, assemble
from ocean_torch.solve import projection, linear
from ocean_torch.ops import linalg

N = 6
_G1 = lambda x: (np.abs(x[:, 0]) < 1e-12) | (np.abs(2.0 - x[:, 0]) < 1e-12)
_G2 = lambda x: (x[:, 0] > 1e-12) & (np.abs(2.0 - x[:, 0]) > 1e-12)


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
    rng = np.random.default_rng(0)
    w = 0.3 * rng.standard_normal(st.ndof)
    fq = 0.2 * rng.standard_normal(tuple(bt.points.shape))
    return dict(sj=sj, st=st, bj=bj, bt=bt, dj=dj, dt=dt_, w=w, fq=fq,
                rng=rng)


@pytest.mark.parametrize("nu,convection", [(1.0, True), (0.1, True),
                                           (1.0, False)])
def test_ns_residual_and_operator(both, nu, convection):
    b = both
    rj = jax_assemble.ns_residual(b["sj"], b["bj"], jnp.asarray(b["w"]),
                                  jnp.asarray(b["fq"]), nu, convection)
    rt = assemble.ns_residual(b["st"], b["bt"], torch.as_tensor(b["w"]),
                              torch.as_tensor(b["fq"]), nu, convection)
    assert _rel(rt, rj) < 1e-12
    oj = jax_assemble.ns_operator(b["sj"], b["bj"], jnp.asarray(b["w"]), nu,
                                  b["dj"], convection)
    ot = assemble.ns_operator(b["st"], b["bt"], torch.as_tensor(b["w"]), nu,
                              b["dt"], convection)
    assert _rel(ot.cell_mats, oj.cell_mats) < 1e-12
    assert _rel(ot.dense(), oj.dense(jnp.float64)) < 1e-12
    x = b["rng"].standard_normal(b["st"].ndof)
    assert _rel(ot.matvec64(torch.as_tensor(x)),
                oj.matvec64(jnp.asarray(x))) < 1e-12


def test_jvp_is_operator_matvec(both):
    """The chord Newton's J(w)·v (forward-mode tangent of the residual)
    is the assembled operator's matvec on non-BC rows."""
    b = both
    st, bt = b["st"], b["bt"]
    w = torch.as_tensor(b["w"])
    v = torch.as_tensor(b["rng"].standard_normal(st.ndof))
    _, jv = torch.func.jvp(
        lambda w_: assemble.ns_residual(st, bt, w_, None, 1.0), (w,), (v,))
    op = assemble.ns_operator(st, bt, w, 1.0, b["dt"])
    keep = torch.ones(st.ndof, dtype=torch.bool)
    keep[b["dt"]] = False
    assert _rel(jv[keep], op.matvec64(v)[keep]) < 1e-12


def test_adjoint_operator(both):
    b = both
    oj = jax_assemble.adjoint_operator(b["sj"], b["bj"], jnp.asarray(b["w"]),
                                       b["dj"])
    ot = assemble.adjoint_operator(b["st"], b["bt"], torch.as_tensor(b["w"]),
                                   b["dt"])
    assert _rel(ot.dense(), oj.dense(jnp.float64)) < 1e-12
    assert _rel(ot.facet_mats, oj.facet_mats) < 1e-12


def test_projection_and_functionals(both):
    b = both
    sj, st = b["sj"], b["st"]
    u = b["rng"].standard_normal((st.n_p2, 2))
    assert _rel(assemble.p1_mass_matrix(st),
                jax_assemble.p1_mass_matrix(sj)) < 1e-12
    assert _rel(assemble.gradu_projection_rhs(st, torch.as_tensor(u)),
                jax_assemble.gradu_projection_rhs(sj, jnp.asarray(u))) < 1e-12
    gj = jax_projection.GradProjector.build(sj).project(sj, jnp.asarray(u))
    gt = projection.GradProjector.build(st).project(st, torch.as_tensor(u))
    assert _rel(gt, gj) < 1e-12
    assert _rel(assemble.divergence_l2(st, torch.as_tensor(u)),
                jax_assemble.divergence_l2(sj, jnp.asarray(u))) < 1e-12
    for a, c in zip(assemble.velocity_norms(st, torch.as_tensor(u)),
                    jax_assemble.velocity_norms(sj, jnp.asarray(u))):
        assert _rel(a, c) < 1e-12


def test_dense_solves(both):
    """solve_operator and the transposed-factor adjoint solve against the
    JAX solves; the reuse path also against a direct float64 solve."""
    b = both
    st, bt = b["st"], b["bt"]
    w = torch.as_tensor(b["w"])
    rhs = b["rng"].standard_normal(st.ndof)
    bc_vals = np.zeros(len(b["dt"]))
    op_j = jax_assemble.adjoint_operator(b["sj"], b["bj"], jnp.asarray(b["w"]),
                                         b["dj"])
    op_t = assemble.adjoint_operator(st, bt, w, b["dt"])
    zj = jax_linear.solve_operator(op_j, jnp.asarray(rhs), jnp.asarray(bc_vals))
    zt = linear.solve_operator(op_t, torch.as_tensor(rhs),
                               torch.as_tensor(bc_vals))
    assert _rel(zt, zj) < 1e-12
    # transposed Stokes factors precondition the adjoint solve
    fac0 = linalg.factorize(assemble.ns_operator(
        st, bt, torch.zeros_like(w), 1.0, b["dt"]).dense())
    fac0_j = jax_linalg.factorize(jax_assemble.ns_operator(
        b["sj"], b["bj"], jnp.zeros(st.ndof), 1.0, b["dj"]).dense())
    zr, conv = linear.solve_operator_reuse_t(op_t, torch.as_tensor(rhs),
                                             torch.as_tensor(bc_vals), fac0)
    zrj, _ = jax_linear.solve_operator_reuse_t(
        op_j, jnp.asarray(rhs), jnp.asarray(bc_vals), fac0_j)
    assert _rel(zr, zt) < 1e-12
    assert _rel(zr, zrj) < 1e-12
