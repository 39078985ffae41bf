"""The port's offset-stencil matvec (``ocean_torch/ops/stencil.py``)
against the element matvec (``Operator.matvec64``, ``mg.op_matvec``) and
against ``ocean_jax/ops/stencil.py``, on the same meshes and numpy inputs
(mirrors ``tests/test_stencil.py``): the unit square, the [0,2]² square
with either diagonal, the L-shape, a graded pipe and the pipe with its
obstacle.

Tolerances (the JAX test's): float64 within 1e-11 absolute; float32
within 1e-4 of the largest entry.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.fem import assemble as jax_assemble
from ocean_jax.fem import spaces as jax_spaces
from ocean_jax.ops import stencil as jax_stencil
from ocean_jax.solve import mg as jax_mg

from ocean_torch.config import OCPConfig
from ocean_torch import system
from ocean_torch.mesh import structured
from ocean_torch.fem import assemble
from ocean_torch.fem.spaces import (make_space, make_boundary_quad,
                                    dirichlet_velocity_bc)
from ocean_torch.ops import stencil
from ocean_torch.solve import mg as mg_mod

torch.set_num_threads(2)

EPS = 1e-12

MESHES = [
    ("square", lambda m: m.unit_square_mesh(7)),
    ("rect", lambda m: m.rectangle_mesh((0., 0.), (2., 2.), 6, 6)),
    ("left", lambda m: m.rectangle_mesh((0., 0.), (2., 2.), 6, 5,
                                        diagonal="left")),
    ("lshape", lambda m: m.l_shape_mesh(8)),
    ("pipe-graded", lambda m: m.pipe_mesh(obstacle=False, graded=True,
                                          lc_min=0.1, lc_max=0.35)[0]),
    ("pipe-hole", lambda m: m.pipe_mesh(resolution=10, obstacle=True)[0]),
]


@functools.lru_cache(maxsize=None)
def _setup(name):
    """Both packages' space, boundary and NS operator at one random state
    (from a seed) on the mesh ``name`` of MESHES."""
    make, w = dict(MESHES)[name], None
    out = []
    for mod, sp_mod, asm in ((structured, None, assemble),
                             (jax_structured, jax_spaces, jax_assemble)):
        mesh = make(mod)
        tags = mod.mark_boundary_facets(mesh, lambda x: np.abs(x[:, 0]) < EPS)
        if sp_mod is None:
            space = make_space(mesh, device="cpu")
            bq = make_boundary_quad(mesh, tags, tag=1, device="cpu")
            bc, _ = dirichlet_velocity_bc(mesh, space,
                                          lambda x: x[:, 0] > EPS)
            if w is None:
                w = 0.3 * np.random.default_rng(0).standard_normal(
                    space.ndof)
            op = asm.ns_operator(space, bq, torch.as_tensor(w), 1.0, bc)
        else:
            space = sp_mod.make_space(mesh)
            bq = sp_mod.make_boundary_quad(mesh, tags, tag=1)
            bc, _ = sp_mod.dirichlet_velocity_bc(mesh, space,
                                                 lambda x: x[:, 0] > EPS)
            op = asm.ns_operator(space, bq, jnp.asarray(w), 1.0, bc)
        out.append((space, bq, op))
    return out


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_mixed_matvec_matches_scatter_and_jax(name):
    (space, bq, op), (sj, bqj, opj) = _setup(name)
    st = stencil.build_stencil_tables(space, bq, "mixed")
    stj = jax_stencil.build_stencil_tables(sj, bqj, "mixed")
    assert sorted(st.offsets) == sorted(stj.offsets) and st.n_off <= 25
    x = np.random.default_rng(1).standard_normal(space.ndof)
    xt = torch.as_tensor(x)

    got64 = stencil.matvec_of(st, torch.float64)(op)(xt)
    assert float((got64 - op.matvec64(xt)).abs().max()) < 1e-11, name
    jax64 = jax_stencil.matvec_of(stj, jnp.float64)(opj)(jnp.asarray(x))
    assert float(np.abs(got64.numpy() - np.asarray(jax64)).max()) < 1e-11

    got32 = stencil.matvec_of(st, torch.float32)(op)(xt)
    assert got32.dtype == torch.float32
    ref32 = mg_mod.op_matvec(op, torch.float32)(xt.float())
    scale = float(ref32.abs().max())
    assert float((got32 - ref32).abs().max()) < 1e-4 * scale, name
    jax32 = jax_stencil.matvec_of(stj, jnp.float32)(opj)(jnp.asarray(x))
    assert float(np.abs(got32.numpy() - np.asarray(jax32)).max()) \
        < 1e-4 * scale


@pytest.mark.parametrize("name", [m[0] for m in MESHES[:4]])
def test_velocity_block_matvec_matches_scatter_and_jax(name):
    (space, bq, op), (sj, bqj, opj) = _setup(name)
    n_vel = 2 * space.n_p2
    vel = mg_mod.velocity_block(op, n_vel)
    st = stencil.build_stencil_tables(space, bq, "vel")
    x = np.random.default_rng(2).standard_normal(n_vel)
    xt = torch.as_tensor(x)
    ref = mg_mod.op_matvec(vel, torch.float64)(xt)
    got = stencil.matvec_of(st, torch.float64)(vel)(xt)
    assert float((got - ref).abs().max()) < 1e-11, name
    velj = jax_mg.velocity_block(opj, n_vel)
    want = jax_mg.op_matvec(velj, jnp.float64)(jnp.asarray(x))
    assert float(np.abs(ref.numpy() - np.asarray(want)).max()) < 1e-11
    # the velocity block's dense matrix is the mixed one's upper-left block
    dense = op.dense()[:n_vel, :n_vel]
    assert float((vel.dense() - dense).abs().max()) < 1e-13


def test_facet_free_operator():
    """A Stokes operator without boundary terms pairs with tables built
    with bq=None."""
    mesh = structured.unit_square_mesh(6)
    space = make_space(mesh, device="cpu")
    bc, _ = dirichlet_velocity_bc(mesh, space, lambda x: x[:, 0] > EPS)
    op = assemble.ns_operator(space, None,
                              torch.zeros(space.ndof, dtype=torch.float64),
                              1.0, bc, convection=False)
    st = stencil.build_stencil_tables(space, None, "mixed")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(space.ndof))
    got = stencil.matvec_of(st, torch.float64)(op)(x)
    assert float((got - op.matvec64(x)).abs().max()) < 1e-12
    with pytest.raises(ValueError, match="facet layout"):
        stencil.build_coefficients(
            stencil.build_stencil_tables(
                space, make_boundary_quad(
                    mesh, structured.mark_boundary_facets(
                        mesh, lambda x: np.abs(x[:, 0]) < EPS), tag=1,
                    device="cpu"),
                "mixed"), op)


def _mg_cfg(**kw):
    return OCPConfig(unit_square_resolution=12, ud_experiment="2_buoys",
                     T=0.05, dt=0.005, linear_solver="mg", **kw)


def _mg_data(cfg):
    rng = np.random.default_rng(5)
    return dict(u_d=0.05 * rng.standard_normal((2, cfg.num_time_steps, 2)),
                x0=0.4 + 1.2 * rng.random((2, 2)), device="cpu")


def test_mg_matvec_knob_switches_paths():
    """mg_matvec="scatter" builds contexts without stencil tables, each
    context records its choice, and both solve to the same answer."""
    cfg = _mg_cfg()
    p_st = system.build_problem(cfg, **_mg_data(cfg))
    p_sc = system.build_problem(dataclasses.replace(cfg, mg_matvec="scatter"),
                                **_mg_data(cfg))
    assert p_st.mg.matvec == "stencil" and p_st.mg.st_mixed is not None
    assert p_sc.mg.matvec == "scatter" and p_sc.mg.st_vel is None
    f = system.initial_control(p_st, case=0)
    a = system.solve_ns(p_st, f.quad)
    b = system.solve_ns(p_sc, f.quad)
    assert a.converged and b.converged
    assert float((a.w - b.w).abs().max()) < 1e-9


def test_failed_table_build_falls_back_and_says_so(monkeypatch):
    """Where the stencil tables cannot be built the context uses element
    scatter matvecs and records it; the solve is unchanged."""
    def refuse(*args, **kw):
        raise ValueError("operator couples dofs beyond the 5×5 stencil")
    cfg = _mg_cfg()
    p_st = system.build_problem(cfg, **_mg_data(cfg))
    monkeypatch.setattr(stencil, "build_stencil_tables", refuse)
    p_fb = system.build_problem(cfg, **_mg_data(cfg))
    assert p_fb.mg.matvec == "scatter" and p_fb.mg.st_mixed is None
    f = system.initial_control(p_st, case=0)
    assert float((system.solve_ns(p_st, f.quad).w
                  - system.solve_ns(p_fb, f.quad).w).abs().max()) < 1e-9
