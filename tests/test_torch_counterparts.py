"""The small public counterparts of ocean_jax names that the port added
last (``TaylorHoodSpace.join``, ``fem.interpolate.eval_velocity_basis``,
``ops.linalg.solve_dense``, ``StencilTables.s_size``, ``system.forward``
/ ``solve_ns``) against the JAX package, and the
device rule of the space builders.

Tolerances: ``join``, ``eval_velocity_basis`` and ``s_size`` exactly (the
same numpy tables and float64 formulas); ``solve_dense`` within 1e-12
relative (JAX refines float32 factors, the port float64 ones, both 12
sweeps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ocean_jax.fem import interpolate as jax_interp
from ocean_jax.fem import spaces as jax_spaces
from ocean_jax.mesh import structured as jax_structured
from ocean_jax.ops import linalg as jax_linalg
from ocean_jax.ops import stencil as jax_stencil

from ocean_torch import system
from ocean_torch.fem import interpolate, make_boundary_quad, make_space
from ocean_torch.mesh import structured
from ocean_torch.ops import build_stencil_tables, linalg

import torch_parallel_cases as cases

torch.set_num_threads(2)

NX = 8
MESHES = {
    "square": lambda m: m.rectangle_mesh((0.0, 0.0), (2.0, 2.0), NX, NX),
    "lshape": lambda m: m.l_shape_mesh(NX),
}


def _pair(name):
    make = MESHES[name]
    mj, mt = make(jax_structured), make(structured)
    return mj, mt, jax_spaces.make_space(mj), make_space(mt, device="cpu")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_join_and_velocity_basis_match_jax(name):
    _, _, sj, st = _pair(name)
    rng = np.random.default_rng(0)
    u, p = rng.standard_normal((st.n_p2, 2)), rng.standard_normal(st.n_p1)
    w = st.join(torch.as_tensor(u), torch.as_tensor(p))
    assert np.array_equal(w.numpy(),
                          np.asarray(sj.join(jnp.asarray(u), jnp.asarray(p))))
    u_back, p_back = st.split(w)
    assert np.array_equal(u_back.numpy(), u)
    assert np.array_equal(p_back.numpy(), p)

    pts = rng.uniform(-0.3, 2.3, (7, 50, 2))        # some outside the domain
    got = interpolate.eval_velocity_basis(st, torch.as_tensor(pts))
    ref = jax_interp.eval_velocity_basis(sj, jnp.asarray(pts))
    for g, r in zip(got, ref):                       # cell, dofs, phi, inside
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert not bool(got[3].all()) and bool(got[3].any())


def test_solve_dense_matches_jax():
    rng = np.random.default_rng(1)
    n = 40
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    got = linalg.solve_dense(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = np.asarray(jax_linalg.solve_dense(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(a @ got - b).max() <= 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_stencil_image_size_matches_jax(name):
    mj, mt, sj, st = _pair(name)
    tags = structured.mark_boundary_facets(
        mt, lambda x: np.abs(x[:, 0]) < 1e-12)
    bj = jax_spaces.make_boundary_quad(mj, tags)
    bt = make_boundary_quad(mt, tags, device="cpu")
    for block in ("mixed", "vel"):
        assert (build_stencil_tables(st, bt, block).s_size
                == jax_stencil.build_stencil_tables(sj, bj, block).s_size)


def test_public_stage_names():
    prob = cases.tiny_problem("cpu")
    f = system.initial_control(prob, 0)
    fwd = system.forward(prob, f.quad)
    assert torch.equal(fwd.w, system.solve_ns(prob, f.quad).w)
    assert fwd.x.shape[:2] == (prob.x0.shape[0], prob.nt)


def test_space_builders_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 2, 2)
    tags = structured.mark_boundary_facets(
        mesh, lambda x: np.abs(x[:, 0]) < 1e-12)
    for call in (lambda: make_space(mesh),
                 lambda: make_boundary_quad(mesh, tags)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert make_space(mesh, device="cpu").device.type == "cpu"
    assert make_boundary_quad(mesh, tags, device="cpu").points.device.type \
        == "cpu"
