"""The matrix-free CG branch of the port's ∇u projection
(``ocean_torch/solve/projection.py``) against its dense branch and
against the CG branch of ``ocean_jax/solve/projection.py`` (mirrors
``tests/test_projection.py``).

Tolerances: CG against dense 1e-12·(max|∇u| + 1) (the JAX test's); CG
against JAX's CG 1e-12 of the same scale; the mass solve at Nx=64
against a dense float64 solve, 1e-12 relative (the JAX test's).
"""

import dataclasses

import numpy as np
import torch
import jax.numpy as jnp

from ocean_jax.fem import make_space as jax_make_space
from ocean_jax.mesh import rectangle_mesh as jax_rectangle_mesh
from ocean_jax.solve import projection as jax_projection

from ocean_torch.config import OCPConfig
from ocean_torch import system
from ocean_torch.fem import assemble, make_space
from ocean_torch.mesh import rectangle_mesh
from ocean_torch.solve import projection
from ocean_torch.solve.projection import GradProjector

torch.set_num_threads(2)


def _problem(nx=12):
    rng = np.random.default_rng(0)
    cfg = OCPConfig(unit_square_resolution=nx, ud_experiment="3_buoys",
                    T=0.05, dt=0.005)
    seeds = 0.3 + 1.0 * rng.random((3, 2))
    u_d = 0.05 * rng.standard_normal((3, cfg.num_time_steps, 2))
    return system.build_problem(cfg, u_d=u_d, x0=seeds, device="cpu")


def test_cg_projector_matches_dense_and_jax():
    mesh_t = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 12, 12)
    space = make_space(mesh_t, device="cpu")
    sj = jax_make_space(jax_rectangle_mesh((0.0, 0.0), (2.0, 2.0), 12, 12))
    u = np.random.default_rng(1).standard_normal((space.n_p2, 2))

    dense = GradProjector.build(space, solver="dense")
    cg = GradProjector.build(space, solver="cg")
    assert dense.mode != "cg" and cg.mode == "cg" and cg.fac is None
    gd = dense.project(space, torch.as_tensor(u))
    gc = cg.project(space, torch.as_tensor(u))
    scale = float(gd.abs().max()) + 1.0
    assert float((gd - gc).abs().max()) < 1e-12 * scale
    gj = jax_projection.GradProjector.build(sj, solver="cg").project(
        sj, jnp.asarray(u))
    assert float(np.abs(gc.numpy() - np.asarray(gj)).max()) < 1e-12 * scale


def test_cg_mass_solve_converges_at_nx64():
    """The fixed 60 lumped-Jacobi CG iterations reach float64 round-off
    against a dense solve at Nx=64 (4,225 P1 dofs)."""
    space = make_space(rectangle_mesh((0.0, 0.0), (2.0, 2.0), 64, 64),
                       device="cpu")
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (space.n_p1, 1)))
    minv = projection._lumped_inverse(space)
    x_cg = projection._pcg(space, minv, b, projection.CG_ITERS)
    mass = assemble.p1_mass_matrix(space)
    x_ref = torch.linalg.solve(mass, b)
    assert float((x_cg - x_ref).abs().max() / x_ref.abs().max()) < 1e-12


def test_cg_extra_iterations_are_no_ops():
    """Past convergence the guarded divisions keep the iterate: no NaN,
    and 200 iterations give the 60-iteration answer to round-off."""
    space = make_space(rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8),
                       device="cpu")
    minv = projection._lumped_inverse(space)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (space.n_p1, 4)))
    b[:, 2] = 0.0                      # a zero right-hand side: rz = 0
    x60 = projection._pcg(space, minv, b, 60)
    x200 = projection._pcg(space, minv, b, 200)
    assert bool(torch.isfinite(x200).all())
    assert float(x200[:, 2].abs().max()) == 0.0
    assert float((x200 - x60).abs().max()) < 1e-13


def test_auto_switches_at_the_cap(monkeypatch):
    """"auto": dense up to DENSE_P1_CAP P1 dofs, cg above it; "dense" and
    "cg" force a regime whatever the size."""
    space = make_space(rectangle_mesh((0.0, 0.0), (2.0, 2.0), 6, 6),
                       device="cpu")
    monkeypatch.setattr(projection, "DENSE_P1_CAP", space.n_p1)
    assert GradProjector.build(space, solver="auto").mode == "lu"
    assert GradProjector.build(space, solver="cg").mode == "cg"
    monkeypatch.setattr(projection, "DENSE_P1_CAP", space.n_p1 - 1)
    assert GradProjector.build(space, solver="auto").mode == "cg"
    assert GradProjector.build(space, solver="dense").mode == "lu"


def test_auto_uses_cg_past_the_cap():
    """Nx=142: 20,449 P1 dofs, past the cap of 20,000, builds the CG
    projector (no dense mass matrix)."""
    space = make_space(rectangle_mesh((0.0, 0.0), (2.0, 2.0), 142, 142),
                       device="cpu")
    assert space.n_p1 > projection.DENSE_P1_CAP
    pj = GradProjector.build(space)
    assert pj.mode == "cg" and pj.fac is None


def test_cg_projector_in_gd_step():
    """A full GD step with the CG projector equals the dense one's."""
    prob = _problem()
    f = system.initial_control(prob, case=1)
    prob_cg = dataclasses.replace(
        prob, projector=GradProjector.build(prob.space, solver="cg"))
    a = system.gd_step(prob, f, 1.0, use_line_search=True)
    b = system.gd_step(prob_cg, f, 1.0, use_line_search=True)
    assert abs(float(a.J) - float(b.J)) < 1e-11 * (abs(float(a.J)) + 1.0)
    assert float((a.f_new.quad - b.f_new.quad).abs().max()) < 1e-10
