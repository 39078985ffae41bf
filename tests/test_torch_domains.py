"""ocean_torch parity on the other structured domains against ocean_jax:
the "left" diagonal on the rectangle and the L-shape, and the gen-1 pipe
meshes (uniform, with the obstacle, on graded tensor grids, both). Mesh,
tags, space, grid maps and line tables; point location and the inside
predicate; the plain versions of the four grid kernels (primal ODE, ∇u
evaluation, adjoint ODE, fused point sources) against the JAX float64
gather and ``grid=`` paths.

Tolerances:
* exact equality for every table the port rebuilds with the same numpy
  code (mesh, tags, dofmaps, grid lines, ``dof_to_node``,
  ``vtx_to_node``) and for the cells and inside flags of point location;
  reference coordinates to 1e-15 (JAX's einsum and PyTorch's sum the
  2×2 product in another order: one rounding apart);
* 1e-12 absolute for the plain versions against the JAX float64 paths,
  with escape flags and steps equal, the bound the JAX package holds its
  own float64 backends to among each other (tests/test_ode_backends.py).
The JAX package's own pipe-domain Pallas tests are all ``slow``; here the
port is held to its float64 paths, not to interpret-mode Pallas.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import structured as jax_structured
from ocean_jax.mesh.locate import (locate_points as jax_locate,
                                   in_domain as jax_in_domain)
from ocean_jax.fem import spaces as jax_spaces
from ocean_jax.fem.interpolate import (eval_velocity as jax_eval_velocity,
                                       eval_p1_tensor as jax_eval_p1)
from ocean_jax.adjoint import point_source_rhs as jax_psrc
from ocean_jax.ode import solve_adjoint_ode as jax_adjoint
from ocean_jax.ode.primal import solve_primal_ode as jax_primal
from ocean_jax.ode.grideval import (
    make_grideval as jax_make_grideval, grad_to_grid as jax_grad_to_grid,
    velocity_to_grid as jax_velocity_to_grid,
    eval_velocity_grid as jax_eval_velocity_grid,
    eval_p1_tensor_grid as jax_eval_p1_grid)

from ocean_torch import kernels
from ocean_torch.adjoint import point_source_rhs
from ocean_torch.fem import spaces
from ocean_torch.fem.interpolate import eval_velocity, eval_p1_tensor
from ocean_torch.mesh import structured, locate_points, in_domain
from ocean_torch.ode import (solve_primal_ode, solve_primal_ode_cuda,
                             solve_adjoint_ode, solve_adjoint_ode_cuda,
                             eval_p1_tensor_cuda)
from ocean_torch.ode.cuda_ode import eval_velocity_six_nodes
from ocean_torch.ode.grideval import (make_grideval, velocity_to_grid,
                                      grad_to_grid, eval_velocity_grid,
                                      eval_p1_tensor_grid)
from ocean_torch.ode.primal import euler_steps, finish_trajectories
import torch_kernel_cases as kc

torch.set_num_threads(2)

# (the mesh made by a structured module, domain centre)
MESHES = {
    "rect_left": (lambda m: m.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8,
                                             diagonal="left"), (1.0, 1.0)),
    "lshape_left": (lambda m: m.l_shape_mesh(10, diagonal="left"),
                    (1.0, 0.5)),
    "pipe_uniform": (lambda m: m.pipe_mesh(resolution=10)[0], (1.0, 1.0)),
    "pipe_hole": (lambda m: m.pipe_mesh(resolution=14, obstacle=True)[0],
                  (1.0, 1.0)),
    "pipe_graded": (lambda m: m.pipe_mesh(graded=True, lc_min=0.08,
                                          lc_max=0.3)[0], (1.0, 1.0)),
    "pipe_hole_graded": (lambda m: m.pipe_mesh(
        obstacle=True, graded=True, lc_min=0.08, lc_max=0.3)[0], (1.0, 1.0)),
    "pipe_hole_graded_left": (lambda m: m.pipe_mesh(
        obstacle=True, graded=True, lc_min=0.08, lc_max=0.3,
        diagonal="left")[0], (1.0, 1.0)),
}
# the ODE and point-source parity runs on these (each new branch once)
ODE_MESHES = ["rect_left", "lshape_left", "pipe_hole", "pipe_graded",
              "pipe_hole_graded_left"]

_CACHE = {}


def _both(name):
    """(JAX mesh, port mesh, JAX space, port space), built once."""
    if name not in _CACHE:
        build = MESHES[name][0]
        mj, mt = build(jax_structured), build(structured)
        _CACHE[name] = (mj, mt, jax_spaces.make_space(mj),
                        spaces.make_space(mt, "cpu"))
    return _CACHE[name]


def _d(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _hard_points(name, mt, rng):
    """Random points in and around the box, points on grid lines and
    nodes, on the anti-diagonals, in the obstacle's fringe, −0.0 and NaN."""
    parts = [rng.uniform(-0.2, 2.2, (1200, 2)), kc.line_points(mt, 60),
             kc.anti_diagonal_points(mt.grid_shape[0], n=40)]
    if name.startswith("pipe"):
        parts.append(kc.fringe_points(mt, 60))
    pts = np.concatenate(parts)
    return pts, np.concatenate([pts, [[np.nan, 0.7], [1.3, np.nan]]])


# --- tables -------------------------------------------------------------------

def test_graded_lines_equal():
    for args in ((0.0, 2.0, 0.2, 0.05 / 3, 0.09, 0.05, 4.0),
                 (0.0, 2.0, 0.2, 0.08, 0.3, 0.05, 4.0),
                 (0.0, 2.0, 1.0, 0.06, 0.2, 0.05, 4.0),
                 (-1.0, 3.0, 2.9, 0.1, 0.4, 0.2, 1.0)):
        assert np.array_equal(jax_structured.graded_lines(*args),
                              structured.graded_lines(*args))
    with pytest.raises(ValueError):
        structured.graded_lines(0.0, 2.0, 0.2, 0.1, 0.3, 1.0, 1.0)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_tables_equal(name):
    mj, mt, _, _ = _both(name)
    for f in ("vertices", "cells", "edges", "cell_edges", "bf_vertices",
              "bf_cells", "bf_local", "bf_normals", "square_to_cell"):
        assert np.array_equal(np.asarray(getattr(mj, f)), getattr(mt, f)), f
    for f in ("origin", "spacing", "grid_shape", "extent", "diagonal",
              "domain", "lshape_corner", "hole", "uniform"):
        assert getattr(mj, f) == getattr(mt, f), f
    for f in ("xs", "ys"):
        a, b = getattr(mj, f), getattr(mt, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert np.array_equal(mj.facet_midpoints(), mt.facet_midpoints())
    assert np.array_equal(mj.facet_lengths(), mt.facet_lengths())
    if name.startswith("pipe"):
        kw = dict(lc_min=0.08, lc_max=0.3) if "graded" in name else {}
        for obstacle in (False, True):
            tj = jax_structured.pipe_mesh(
                resolution=10, obstacle=obstacle, graded="graded" in name,
                diagonal=mt.diagonal, **kw)[1]
            tt = structured.pipe_mesh(
                resolution=10, obstacle=obstacle, graded="graded" in name,
                diagonal=mt.diagonal, **kw)[1]
            assert np.array_equal(tj, tt)
            markers = {structured.PIPE_INLET_MARKER,
                       structured.PIPE_WALL_MARKER}
            if obstacle:
                markers.add(structured.PIPE_OBSTACLE_MARKER)
            assert set(tt.tolist()) == markers
        assert (structured.PIPE_INLET_MARKER, structured.PIPE_OUTLET_MARKER,
                structured.PIPE_WALL_MARKER,
                structured.PIPE_OBSTACLE_MARKER) == (
            jax_structured.PIPE_INLET_MARKER,
            jax_structured.PIPE_OUTLET_MARKER,
            jax_structured.PIPE_WALL_MARKER,
            jax_structured.PIPE_OBSTACLE_MARKER)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_space_and_grid_maps_equal(name):
    mj, mt, sj, st = _both(name)
    assert (sj.n_p2, sj.n_p1, sj.ndof) == (st.n_p2, st.n_p1, st.ndof)
    for f in ("cell_dofs_p2", "cell_dofs_p1", "cell_jinv", "cell_detj",
              "dof_coords_p2"):
        assert np.array_equal(np.asarray(getattr(sj, f)),
                              getattr(st, f).numpy()), f
    gj, gt = jax_make_grideval(sj), make_grideval(st)
    assert np.array_equal(np.asarray(gj.dof_to_node), gt.dof_to_node.numpy())
    assert np.array_equal(np.asarray(gj.vtx_to_node), gt.vtx_to_node.numpy())
    assert (gj.hg_shape, gj.vg_shape) == (gt.hg_shape, gt.vg_shape)
    lj, lt = sj.locator, st.locator
    assert lj.uniform == lt.uniform and lj.hole == lt.hole
    if not lt.uniform:
        assert np.array_equal(np.asarray(lj.xs_lines), lt.xs_lines.numpy())
        assert np.array_equal(np.asarray(lj.ys_lines), lt.ys_lines.numpy())


# --- point location -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_location_matches(name):
    _, mt, sj, st = _both(name)
    finite, pts = _hard_points(name, mt, np.random.default_rng(1))
    inside_j = np.asarray(jax_in_domain(sj.locator, jnp.asarray(pts)))
    inside_t = in_domain(st.locator, torch.as_tensor(pts)).numpy()
    assert np.array_equal(inside_j, inside_t)
    assert 0 < inside_j.sum() < len(pts)
    cj, xj, ij = jax_locate(sj.locator, jnp.asarray(finite))
    ct, xt, it = locate_points(st.locator, torch.as_tensor(finite))
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert _d(xt, xj) < 1e-15
    if st.locator.hole is not None:
        assert not inside_t[-62:-2].any()         # the fringe is outside


# --- the four grid kernels' plain versions ----------------------------------------

@pytest.mark.parametrize("name", ODE_MESHES)
def test_grid_evaluation_matches_jax(name):
    """Velocity and ∇u from the half-grid (the kernels' plain versions)
    against the JAX grid and table paths, inside flags equal. Off the
    table path on the L-shape's re-entrant edge y = 1, x < 1, where the
    table path of both packages extrapolates from the wrong cell
    (tests/test_torch_lshape.py::test_grid_evaluation_matches_jax)."""
    _, mt, sj, st = _both(name)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((st.n_p2, 2))
    g = rng.standard_normal((st.n_p1, 2, 2))
    pts, _ = _hard_points(name, mt, rng)
    pt, pj = torch.as_tensor(pts), jnp.asarray(pts)
    gj, gt = jax_make_grideval(sj), make_grideval(st)
    inj = np.asarray(jax_in_domain(sj.locator, pj))
    off = inj & ~((pts[:, 1] == 1.0) & (pts[:, 0] < 1.0)
                  & (mt.domain == "lshape"))
    ref_u = np.asarray(jax_eval_velocity_grid(
        gj, jax_velocity_to_grid(gj, jnp.asarray(u)), pj)[0])
    ref_g = np.asarray(jax_eval_p1_grid(
        gj, jax_grad_to_grid(gj, jnp.asarray(g)), pj)[0])
    tab_u = np.asarray(jax_eval_velocity(sj, jnp.asarray(u), pj)[0])
    tab_g = np.asarray(jax_eval_p1(sj, jnp.asarray(g), pj)[0])
    u_img = velocity_to_grid(gt, torch.as_tensor(u))
    for vals, ins in (eval_velocity_grid(gt, u_img, pt),
                      eval_velocity_six_nodes(gt, u_img, pt)):
        assert np.array_equal(ins.numpy(), inj)
        assert _d(vals.numpy()[inj], ref_u[inj]) < 1e-12
        assert _d(vals.numpy()[off], tab_u[off]) < 1e-12
    vals, ins = eval_velocity(st, torch.as_tensor(u), pt)
    assert _d(vals.numpy()[inj], tab_u[inj]) < 1e-12
    g_img = grad_to_grid(gt, torch.as_tensor(g))
    for vals, ins in (eval_p1_tensor_grid(gt, g_img, pt),
                      eval_p1_tensor_cuda(gt, g_img, pt)):
        assert np.array_equal(ins.numpy(), inj)
        assert _d(vals.numpy()[inj], ref_g[inj]) < 1e-12
        assert _d(vals.numpy()[off], tab_g[off]) < 1e-12
    vals, _ = eval_p1_tensor(st, torch.as_tensor(g), pt)
    assert _d(vals.numpy()[inj], tab_g[inj]) < 1e-12


def _check_primal(res, ref, tol=1e-12):
    assert np.array_equal(res.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(res.kfail.numpy(), np.asarray(ref.kfail))
    for f in ("x", "u_values", "x_raw"):
        assert _d(getattr(res, f), getattr(ref, f)) < tol, f


@pytest.mark.parametrize("name", ODE_MESHES)
def test_primal_ode_matches_jax(name):
    """The inputs of tests/test_ode_backends.py::
    test_primal_ode_backends_agree in a slower field, with seeds around
    the obstacle and the edges: the
    port's table path, ``grid=`` path, the kernel's plain version and its
    six-node mirror against JAX's gather and ``grid=`` paths."""
    _, mt, sj, st = _both(name)
    rng = np.random.default_rng(3)
    # a field slow enough that 50 steps do not amplify the one-ulp
    # differences of evaluation order past 1e-12
    u = 0.3 * rng.standard_normal((st.n_p2, 2))
    K, nt, h = 37, 50, 0.01
    x0 = rng.uniform(0.1, 1.9, (K, 2))
    x0[:10] = rng.uniform(0.15, 0.45, (10, 2))
    x0[10:20, 0] = rng.uniform(0.0, 0.04, 10)      # near the edge x = 0
    x0[20] = [2.0 + 1e-6, 1.0]                     # outside from step 0
    center = np.asarray(MESHES[name][1])
    ref = jax_primal(sj, jnp.asarray(u), jnp.asarray(x0), h, nt,
                     jnp.asarray(center))
    refg = jax_primal(sj, jnp.asarray(u), jnp.asarray(x0), h, nt,
                      jnp.asarray(center), grid=jax_make_grideval(sj))
    _check_primal(
        solve_primal_ode(st, torch.as_tensor(u), torch.as_tensor(x0), h, nt,
                         torch.as_tensor(center)), refg, 1e-12)
    assert 0 < int(ref.mask.sum()) < K
    gt = make_grideval(st)
    args = (torch.as_tensor(u), torch.as_tensor(x0), h, nt,
            torch.as_tensor(center))
    before = kernels.launch_counts()
    for res in (solve_primal_ode(st, *args), solve_primal_ode(st, *args,
                                                              grid=gt),
                solve_primal_ode_cuda(gt, *args)):
        _check_primal(res, ref)
    assert kernels.launch_counts() == before      # CPU: the plain version
    u_img = velocity_to_grid(gt, args[0])
    eval6 = lambda p: eval_velocity_six_nodes(gt, u_img, p)
    x, us, failed, kfail = euler_steps(eval6, args[1], h, nt)
    _check_primal(finish_trajectories(st.locator, eval6, x, us, failed,
                                      kfail, args[-1]), ref)


@pytest.mark.parametrize("name", ODE_MESHES)
def test_adjoint_ode_matches_jax(name):
    """Synthetic trajectories as tests/test_pallas_adjoint.py builds them
    (points outside, a masked buoy, a stretch inside the obstacle where the
    carry of the last in-domain ∇u engages): the port's sequential,
    parallel, ``grid=`` and kernel paths against JAX's."""
    _, mt, sj, st = _both(name)
    rng = np.random.default_rng(4)
    K, nt, h = 9, 40, 0.005
    x = rng.uniform(0.0, 2.0, (K, nt, 2))
    out = rng.random((K, nt)) < 0.3
    x[..., 0] = np.where(out, 2.5 + rng.random((K, nt)), x[..., 0])
    x[1, 5:9] = [0.2, 0.21]                      # in the disk (pipes)
    if name.startswith("pipe"):
        x[2, 10:20] = kc.fringe_points(mt, 10)
    u_values = 0.1 * rng.standard_normal((K, nt, 2))
    u_d = 0.1 * rng.standard_normal((K, nt, 2))
    mask = np.zeros(K, bool)
    mask[0] = True
    grad_u = rng.standard_normal((st.n_p1, 2, 2))
    arrays = (grad_u, x, u_values, u_d, mask)
    jx = tuple(jnp.asarray(a) for a in arrays)
    tt = tuple(torch.as_tensor(a) for a in arrays)
    mu_j = np.asarray(jax_adjoint(sj, *jx, h))
    assert _d(np.asarray(jax_adjoint(sj, *jx, h, method="scan")), mu_j) \
        < 1e-12
    gt = make_grideval(st)
    for mu in (solve_adjoint_ode(st, *tt, h),
               solve_adjoint_ode(st, *tt, h, method="scan"),
               solve_adjoint_ode(st, *tt, h, grid=gt),
               solve_adjoint_ode_cuda(gt, *tt, h)):
        assert _d(mu, mu_j) < 1e-12
    assert float(np.abs(mu_j[0]).max()) == 0.0 and np.abs(mu_j[1:]).max() > 0


@pytest.mark.parametrize("method", ["scatter", "fused"])
@pytest.mark.parametrize("name", ODE_MESHES)
def test_point_sources_match_jax(name, method):
    """System-consistent inputs (tests/test_psrc_fused.py): trajectories
    inside and clear of the obstacle, a masked buoy parked at the centre;
    the port's scatter and fused (kernel 3's plain version) against the
    JAX float64 scatter."""
    _, mt, sj, st = _both(name)
    rng = np.random.default_rng(5)
    K, nt, h = 8, 25, 0.01
    center = np.asarray(MESHES[name][1])
    c = st.dof_coords_p2.numpy()
    u = np.stack([0.3 * np.sin(c[:, 1]), -0.3 * np.cos(c[:, 0])], axis=1)
    lo, hi = ((0.05, 0.95) if name.startswith("lshape") else (0.5, 1.8))
    x = lo + (hi - lo) * rng.random((K, nt, 2))
    x[3, :, 0] = lo + hi - x[3, :, 1]           # along an anti-diagonal
    mask = np.zeros(K, bool)
    mask[4] = True
    x[mask] = center
    u_values, inside = jax_eval_velocity(sj, jnp.asarray(u), jnp.asarray(x))
    assert bool(inside.all())
    mu = rng.standard_normal((K, nt, 2))
    u_d = rng.standard_normal((K, nt, 2))
    args = (u, x, mu, u_d, mask)
    b_j = np.asarray(jax_psrc(sj, *(jnp.asarray(a) for a in args), h,
                              jnp.asarray(center), method="scatter"))
    kw = (dict(grid=make_grideval(st),
               u_values=torch.as_tensor(np.array(u_values)))
          if method == "fused" else {})
    b_t = point_source_rhs(st, *(torch.as_tensor(a) for a in args), h,
                           torch.as_tensor(center), method=method,
                           **kw).numpy()
    assert np.abs(b_j).max() > 0.01 and _d(b_t, b_j) < 1e-12
