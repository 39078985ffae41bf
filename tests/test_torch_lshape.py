"""ocean_torch parity on the L-shape domain [0,2]x[0,1] ∪ [1,2]x[1,2]
against ocean_jax: mesh, space, boundary tags, quadrature and half-grid
maps; point location around the inner corner; the plain versions of the
five kernels; problem set-up and the analytic measurements.

Tolerances:
* exact equality for every table the port rebuilds with the same numpy
  code (mesh, dofmaps, tags, quadrature, BC dofs, ``dof_to_node``,
  ``vtx_to_node``) and for cells and inside flags of point location;
  reference coordinates to 1e-15;
* 1e-12 absolute for the five plain versions against the JAX float64
  paths (the same float64 formulas, summed in another order), the bound
  the JAX package holds its own float64 backends to among each other
  (tests/test_ode_backends.py);
* against the JAX Pallas kernels in interpret mode on the CPU: the bounds
  of the JAX package's own tests (primal 1e-9, adjoint and ∇u evaluation
  2e-6, point sources 5e-6 of the RHS scale, segment sum 1e-15 of the
  largest sum).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
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
from ocean_jax.ode.pallas_ode import solve_primal_ode_pallas
from ocean_jax.ode.pallas_adjoint import solve_adjoint_ode_pallas
from ocean_jax.ode.pallas_eval import eval_p1_tensor_pallas
from ocean_jax.ops.psum_pallas import ozaki_segment_sum_pallas

from ocean_torch import convert, kernels, system
from ocean_torch.config import OCPConfig
from ocean_torch.adjoint import point_source_rhs
from ocean_torch.fem import spaces
from ocean_torch.fem.interpolate import eval_velocity, eval_p1_tensor
from ocean_torch.mesh import structured, locate_points, in_domain
from ocean_torch.ode import (solve_primal_ode, solve_primal_ode_cuda,
                             solve_adjoint_ode, solve_adjoint_ode_cuda,
                             eval_p1_tensor_cuda)
from ocean_torch.ode.grideval import (make_grideval, velocity_to_grid,
                                      grad_to_grid, eval_velocity_grid,
                                      eval_p1_tensor_grid)

# The suite runs in several worker processes on one machine; PyTorch's
# default of one thread a core in each of them oversubscribes it.
torch.set_num_threads(2)

_EPS = 1e-12
RESOLUTIONS = [4, 8, 10]


def _gamma1(x):
    return (np.abs(x[:, 0]) < _EPS) | (np.abs(2.0 - x[:, 1]) < _EPS)


def _gamma2(x):
    return (x[:, 0] > _EPS) & (np.abs(2.0 - x[:, 1]) > _EPS)


def _spaces(res):
    mj, mt = jax_structured.l_shape_mesh(res), structured.l_shape_mesh(res)
    return mj, mt, jax_spaces.make_space(mj), spaces.make_space(mt, "cpu")


def _d(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# --- tables -----------------------------------------------------------------

@pytest.mark.parametrize("res", RESOLUTIONS)
def test_lshape_mesh_tables_equal(res):
    mj, mt = jax_structured.l_shape_mesh(res), structured.l_shape_mesh(res)
    for name in ("vertices", "cells", "edges", "cell_edges", "bf_vertices",
                 "bf_cells", "bf_local", "bf_normals", "square_to_cell"):
        assert np.array_equal(np.asarray(getattr(mj, name)),
                              getattr(mt, name)), name
    for name in ("origin", "spacing", "grid_shape", "extent", "diagonal",
                 "domain", "lshape_corner"):
        assert getattr(mj, name) == getattr(mt, name), name
    assert mt.domain == "lshape"
    # three quarters of the squares are active, the rest marked −1
    assert int((mt.square_to_cell[..., 0] >= 0).sum()) == 3 * res * res // 4
    assert np.array_equal(jax_structured.mark_boundary_facets(mj, _gamma1),
                          structured.mark_boundary_facets(mt, _gamma1))


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_lshape_space_quadrature_and_grid_maps_equal(res):
    mj, mt, sj, st = _spaces(res)
    assert (sj.n_p2, sj.n_p1, sj.ndof) == (st.n_p2, st.n_p1, st.ndof)
    for name in ("cell_dofs_p2", "cell_dofs_p1", "cell_dofs_mixed",
                 "cell_jinv", "cell_detj", "dof_coords_p2", "inc_mixed"):
        assert np.array_equal(np.asarray(getattr(sj, name)),
                              getattr(st, name).numpy()), name
    tags = structured.mark_boundary_facets(mt, _gamma1)
    bj = jax_spaces.make_boundary_quad(mj, tags)
    bt = spaces.make_boundary_quad(mt, tags, device="cpu")
    for name in ("facet_ids", "cells", "phi2", "normals", "weights",
                 "points"):
        assert np.array_equal(np.asarray(getattr(bj, name)),
                              getattr(bt, name).numpy()), name
    dj, vj = jax_spaces.dirichlet_velocity_bc(mj, sj, _gamma2)
    dt_, vt = spaces.dirichlet_velocity_bc(mt, st, _gamma2)
    assert np.array_equal(np.asarray(dj), dt_.numpy())
    assert np.array_equal(np.asarray(vj), vt.numpy())
    gj, gt = jax_make_grideval(sj), make_grideval(st)
    assert np.array_equal(np.asarray(gj.dof_to_node), gt.dof_to_node.numpy())
    assert np.array_equal(np.asarray(gj.vtx_to_node), gt.vtx_to_node.numpy())
    assert (gj.hg_shape, gj.vg_shape) == (gt.hg_shape, gt.vg_shape)
    # the grid covers the bounding box; the missing block's nodes own no dof
    assert st.n_p2 < gt.hg_shape[0] * gt.hg_shape[1]


def _corner_points(res, rng):
    """Points around the inner corner (1, 1): on it, on and around its
    slack on both re-entrant edges, in the missing block, on grid lines,
    and random ones in and around the bounding box."""
    h = 2.0 / res
    offs = np.array([0.0, 0.5e-12, -0.5e-12, 2e-12, -2e-12, 1e-12, h / 2,
                     -h / 2, h, -h])
    around = np.array([(1.0 - dx, 1.0 + dy) for dx in offs for dy in offs])
    block = np.stack([rng.uniform(-0.2, 1.0, 200),
                      rng.uniform(1.0, 2.2, 200)], 1)
    lines = np.round(rng.uniform(0.0, 2.0, (100, 2)) / h) * h
    return np.concatenate([around, block, lines,
                           rng.uniform(-0.3, 2.3, (600, 2))])


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_lshape_location_matches(res):
    _, _, sj, st = _spaces(res)
    pts = _corner_points(res, np.random.default_rng(res))
    inside_j = np.asarray(jax_in_domain(sj.locator, jnp.asarray(pts)))
    assert np.array_equal(inside_j,
                          in_domain(st.locator, torch.as_tensor(pts)).numpy())
    assert 0 < inside_j.sum() < len(pts)
    # the slack: (1 − 0.5e-12, 1 + 2e-12) is inside, (1 − 2e-12, 1 + 2e-12)
    # is not
    probe = torch.tensor([[1.0 - 0.5e-12, 1.0 + 2e-12],
                          [1.0 - 2e-12, 1.0 + 2e-12],
                          [1.0 - 2e-12, 1.0 + 0.5e-12], [1.0, 1.0]],
                         dtype=torch.float64)
    assert in_domain(st.locator, probe).tolist() == [True, False, True, True]
    cj, xj, ij = jax_locate(sj.locator, jnp.asarray(pts))
    ct, xt, it = locate_points(st.locator, torch.as_tensor(pts))
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert _d(xt, xj) < 1e-15
    # projection: no point is located in a cell that does not exist
    assert int(ct.min()) >= 0 and int(ct.max()) < st.num_cells


# --- the five plain versions --------------------------------------------------

@pytest.fixture(scope="module")
def fields():
    """Random P2 velocity and P1 ∇u fields on the L-shape at resolution
    10 and points in and around its bounding box."""
    rng = np.random.default_rng(0)
    _, _, sj, st = _spaces(10)
    u = rng.standard_normal((st.n_p2, 2))
    g = rng.standard_normal((st.n_p1, 2, 2))
    pts = np.concatenate([rng.uniform(-0.2, 2.2, (3000, 2)),
                          _corner_points(10, rng)])
    return dict(sj=sj, st=st, gj=jax_make_grideval(sj), gt=make_grideval(st),
                u=u, g=g, pts=pts)


def test_grid_evaluation_matches_jax(fields):
    """Mirror of tests/test_ode_backends.py::test_grideval_matches_tables
    on the L-shape: the port's table evaluation against the JAX tables,
    its half-grid stencils (what the kernels read) against the JAX
    stencils, and stencils against tables.

    One exception, the same in both packages: a point exactly on the
    re-entrant edge y = 1, x < 1 is not projected (it is not above the
    corner) and floors into a square of the missing block. The stencil
    reads that square's bottom row, which lies on the edge, and is right;
    the tables clamp the missing cell's index −1 to cell 0 and
    extrapolate. Tables are compared with tables and stencils with
    stencils on all points, and the two with each other off that edge."""
    sj, st, gj, gt = (fields[k] for k in ("sj", "st", "gj", "gt"))
    pts = fields["pts"]
    pts_t, pts_j = torch.as_tensor(pts), jnp.asarray(pts)
    u_t, g_t = torch.as_tensor(fields["u"]), torch.as_tensor(fields["g"])
    u_j, g_j = jnp.asarray(fields["u"]), jnp.asarray(fields["g"])
    inj = np.asarray(jax_in_domain(sj.locator, pts_j))
    on_edge = (pts[:, 1] == 1.0) & (pts[:, 0] < 1.0)
    assert on_edge.any()
    off = inj & ~on_edge

    tab_u, ins = eval_velocity(st, u_t, pts_t)
    tab_g, _ = eval_p1_tensor(st, g_t, pts_t)
    assert np.array_equal(ins.numpy(), inj)
    assert _d(tab_u.numpy()[inj],
              np.asarray(jax_eval_velocity(sj, u_j, pts_j)[0])[inj]) < 1e-12
    assert _d(tab_g.numpy()[inj],
              np.asarray(jax_eval_p1(sj, g_j, pts_j)[0])[inj]) < 1e-12

    ref_u = np.asarray(jax_eval_velocity_grid(
        gj, jax_velocity_to_grid(gj, u_j), pts_j)[0])
    ref_g = np.asarray(jax_eval_p1_grid(
        gj, jax_grad_to_grid(gj, g_j), pts_j)[0])
    got_u, ins = eval_velocity_grid(gt, velocity_to_grid(gt, u_t), pts_t)
    assert np.array_equal(ins.numpy(), inj)
    assert _d(got_u.numpy()[inj], ref_u[inj]) < 1e-12
    assert _d(got_u.numpy()[off], tab_u.numpy()[off]) < 1e-12
    for vals, ins in (eval_p1_tensor_grid(gt, grad_to_grid(gt, g_t), pts_t),
                      eval_p1_tensor_cuda(gt, grad_to_grid(gt, g_t), pts_t)):
        assert np.array_equal(ins.numpy(), inj)
        assert _d(vals.numpy()[inj], ref_g[inj]) < 1e-12
        assert _d(vals.numpy()[off], tab_g.numpy()[off]) < 1e-12


def test_p1_eval_matches_jax_pallas_interpret(fields):
    """Kernel 4's plain version against the JAX Pallas ∇u kernel
    (mirror of tests/test_pallas_eval.py::test_eval_matches_gather)."""
    pts = fields["pts"][:256]
    val, ins = eval_p1_tensor_pallas(
        fields["gj"], jax_grad_to_grid(fields["gj"], jnp.asarray(fields["g"])),
        jnp.asarray(pts))
    gt = fields["gt"]
    vt, it = eval_p1_tensor_cuda(
        gt, grad_to_grid(gt, torch.as_tensor(fields["g"])),
        torch.as_tensor(pts))
    sel = np.asarray(ins)
    assert np.array_equal(it.numpy(), sel)
    assert _d(vt.numpy()[sel], np.asarray(val)[sel]) < 2e-6


@pytest.fixture(scope="module")
def primal_case():
    """The inputs of tests/test_ode_backends.py::
    test_primal_ode_backends_agree on the L-shape."""
    rng = np.random.default_rng(3)
    _, _, sj, st = _spaces(8)
    u = 0.9 * rng.standard_normal((st.n_p2, 2))
    K, nt, h = 37, 50, 0.02
    x0 = rng.uniform(0.1, 1.9, (K, 2))
    center = np.array([1.0, 0.5])
    ref = jax_primal(sj, jnp.asarray(u), jnp.asarray(x0), h, nt,
                     jnp.asarray(center))
    assert 0 < int(ref.mask.sum()) < K
    return dict(sj=sj, st=st, u=u, x0=x0, center=center, ref=ref, h=h, nt=nt)


def _check_primal(res, ref, tol):
    assert np.array_equal(res.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(res.kfail.numpy(), np.asarray(ref.kfail))
    for name in ("x", "u_values", "x_raw"):
        assert _d(getattr(res, name), getattr(ref, name)) < tol, name


def test_primal_ode_matches_jax(primal_case):
    c = primal_case
    args = (torch.as_tensor(c["u"]), torch.as_tensor(c["x0"]), c["h"],
            c["nt"], torch.as_tensor(c["center"]))
    before = kernels.launch_counts()
    _check_primal(solve_primal_ode(c["st"], *args), c["ref"], 1e-12)
    _check_primal(solve_primal_ode_cuda(make_grideval(c["st"]), *args),
                  c["ref"], 1e-12)
    assert kernels.launch_counts() == before      # CPU: the plain version
    # some buoys leave through the re-entrant edges, into the missing block
    kf = np.minimum(np.asarray(c["ref"].kfail), c["nt"] - 1)
    gone = np.asarray(c["ref"].x_raw)[np.arange(len(kf)), kf]
    gone = gone[np.asarray(c["ref"].mask)]
    assert bool(((gone[:, 0] < 1.0) & (gone[:, 1] > 1.0)).any())


def test_primal_ode_matches_jax_pallas_interpret(primal_case):
    c = primal_case
    pal = solve_primal_ode_pallas(
        c["sj"], jax_make_grideval(c["sj"]), jnp.asarray(c["u"]),
        jnp.asarray(c["x0"]), c["h"], c["nt"], jnp.asarray(c["center"]),
        interpret=True)
    res = solve_primal_ode_cuda(
        make_grideval(c["st"]), torch.as_tensor(c["u"]),
        torch.as_tensor(c["x0"]), c["h"], c["nt"],
        torch.as_tensor(c["center"]))
    _check_primal(res, pal, 1e-9)


@pytest.fixture(scope="module")
def adjoint_case():
    """Synthetic trajectories as tests/test_pallas_adjoint.py builds them
    (points outside, a masked buoy), on the L-shape at resolution 6, with
    stretches in the missing block and across the re-entrant edges."""
    rng = np.random.default_rng(3)
    _, _, sj, st = _spaces(6)
    K, nt, h = 9, 40, 0.005
    x = rng.uniform(0.0, 2.0, (K, nt, 2))          # a quarter: missing block
    out = rng.random((K, nt)) < 0.3
    x[..., 0] = np.where(out, 2.5 + rng.random((K, nt)), x[..., 0])
    x[1] = [1.0 - 0.5e-12, 1.7]                    # on the slack: inside
    x[2, 5:] = [1.0 - 2e-12, 1.0 + 2e-12]          # just outside from step 5
    u_values = 0.1 * rng.standard_normal((K, nt, 2))
    u_d = 0.1 * rng.standard_normal((K, nt, 2))
    mask = np.zeros(K, bool)
    mask[0] = True
    grad_u = rng.standard_normal((st.n_p1, 2, 2))
    arrays = (grad_u, x, u_values, u_d, mask)
    return dict(sj=sj, st=st, h=h,
                jx=tuple(jnp.asarray(a) for a in arrays),
                tt=tuple(torch.as_tensor(a) for a in arrays))


def test_adjoint_ode_matches_jax(adjoint_case):
    c = adjoint_case
    mu_j = jax_adjoint(c["sj"], *c["jx"], c["h"])
    assert _d(solve_adjoint_ode(c["st"], *c["tt"], c["h"]), mu_j) < 1e-12
    mu_t = solve_adjoint_ode_cuda(make_grideval(c["st"]), *c["tt"], c["h"])
    assert _d(mu_t, mu_j) < 1e-12
    assert float(mu_t[0].abs().max()) == 0.0 and bool(mu_t[1:].any())
    inside = in_domain(c["st"].locator, c["tt"][1])
    assert bool(inside[1].all()) and not bool(inside[2, 5:].any())


def test_adjoint_ode_matches_jax_pallas_interpret(adjoint_case):
    c = adjoint_case
    mu_p = solve_adjoint_ode_pallas(jax_make_grideval(c["sj"]), *c["jx"],
                                    c["h"], interpret=True)
    mu_t = solve_adjoint_ode_cuda(make_grideval(c["st"]), *c["tt"], c["h"])
    assert _d(mu_t, mu_p) < 2e-6


@pytest.fixture(scope="module")
def psrc_case():
    """System-consistent inputs as tests/test_psrc_fused.py::
    test_fused_matches_scatter_lshape builds them, with trajectories in
    both arms of the L, along the re-entrant edge x = 1 and along the
    line y = 1."""
    rng = np.random.default_rng(13)
    _, _, sj, st = _spaces(12)
    center = np.array([1.0, 0.5])
    K, nt, h = 8, 30, 0.01
    c = st.dof_coords_p2.numpy()
    u = np.stack([0.2 * c[:, 1], -0.2 * c[:, 0]], axis=1)
    x = np.stack([0.05 + 1.9 * rng.random((K, nt)),
                  0.05 + 0.9 * rng.random((K, nt))], -1)    # lower arm
    x[1, :, 1] += 1.0
    x[1, :, 0] = 1.0 + 0.95 * rng.random(nt)                # upper arm
    # the line y = 1 right of the corner; left of it the table path that
    # is the reference here mislocates (see the evaluation test above)
    x[3, :, 0] = 1.0 + 0.95 * rng.random(nt)
    x[3, :, 1] = 1.0
    x[5, :, 0] = 1.0
    x[5, :, 1] = 1.0 + rng.random(nt)                       # edge x = 1
    mask = np.zeros(K, bool)
    mask[2] = True
    x[mask] = center
    u_values, inside = jax_eval_velocity(sj, jnp.asarray(u), jnp.asarray(x))
    assert bool(inside.all())
    mu = rng.standard_normal((K, nt, 2))
    u_d = rng.standard_normal((K, nt, 2))
    args = (u, x, mu, u_d, mask)
    return dict(sj=sj, st=st, center=center, h=h,
                u_values=np.array(u_values),
                jx=tuple(jnp.asarray(a) for a in args),
                tt=tuple(torch.as_tensor(a) for a in args))


def _psrc_torch(c, method, **kw):
    return point_source_rhs(c["st"], *c["tt"], c["h"],
                            torch.as_tensor(c["center"]), method=method,
                            **kw).numpy()


@pytest.mark.parametrize("method", ["scatter", "fused", "ozaki",
                                    "ozaki_pallas", "sorted", "binned"])
def test_point_sources_match_jax_scatter(psrc_case, method):
    """Kernels 3 ("fused") and 5 ("ozaki", "ozaki_pallas") and the float64
    methods against the JAX float64 scatter."""
    c = psrc_case
    b_j = np.asarray(jax_psrc(c["sj"], *c["jx"], c["h"],
                              jnp.asarray(c["center"]), method="scatter"))
    kw = (dict(grid=make_grideval(c["st"]),
               u_values=torch.as_tensor(c["u_values"]))
          if method == "fused" else {})
    b_t = _psrc_torch(c, method, **kw)
    assert np.abs(b_j).max() > 0.01 and _d(b_t, b_j) < 1e-12


def test_point_sources_match_jax_fused_interpret(psrc_case):
    c = psrc_case
    b_j = np.asarray(jax_psrc(
        c["sj"], *c["jx"], c["h"], jnp.asarray(c["center"]), method="fused",
        grid=jax_make_grideval(c["sj"]),
        u_values=jnp.asarray(c["u_values"])))
    b_t = _psrc_torch(c, "fused", grid=make_grideval(c["st"]),
                      u_values=torch.as_tensor(c["u_values"]))
    assert _d(b_t, b_j) < 5e-6 * max(float(np.abs(b_j).max()), 1.0)


def test_segment_sum_of_lshape_cells_matches_jax_pallas_interpret(psrc_case):
    """Kernel 5's plain version on the cells the L-shape locator gives,
    against the JAX Pallas segment sum."""
    from ocean_torch.adjoint.point_sources import point_source_terms
    from ocean_torch.ops.scatter import ozaki_segment_sum
    c = psrc_case
    u, x, mu, u_d, mask = c["tt"]
    active = (~mask)[:, None].expand(x.shape[:2])
    cell, vals = point_source_terms(c["st"], u, x, mu, u_d, active, c["h"],
                                    torch.as_tensor(c["center"]))
    vals = vals.reshape(-1, 12)
    S = c["st"].num_cells
    out = ozaki_segment_sum(cell, vals, S).numpy()
    pal = np.asarray(ozaki_segment_sum_pallas(
        jnp.asarray(cell.numpy()), jnp.asarray(vals.numpy()), S, chunk=512,
        s_tile=1024, interpret=True))
    assert np.abs(out - pal).max() <= 1e-15 * np.abs(pal).max()


# --- problem set-up ---------------------------------------------------------

def test_lshape_ud_and_problem_match_jax():
    kw = dict(L_shape=True, L_shape_resolution=6, ud_experiment="3_buoys")
    cj, ct = JaxConfig(**kw), OCPConfig(**kw)
    udj, x0j = jax_system.lshape_ud(cj)
    udt, x0t = system.lshape_ud(ct)
    assert np.array_equal(udj, udt) and np.array_equal(x0j, x0t)
    # the quirk: sampled on linspace(t0, T, nt), spacing T/(nt−1) ≠ dt
    assert udt.shape == (3, 200, 2) and ct.dt != ct.T / (udt.shape[1] - 1)
    pj = jax_system.build_problem(cj)
    pt = system.build_problem(ct, device="cpu")
    assert pt.K == 3 and pj.K == 3
    assert pt.alpha == pj.alpha == 3e-6          # K from the string
    assert np.array_equal(np.asarray(pj.center), pt.center.numpy())
    assert np.array_equal(np.asarray(pj.bc_dofs), pt.bc_dofs.numpy())
    assert np.array_equal(np.asarray(pj.bq.points), pt.bq.points.numpy())
    assert np.array_equal(np.asarray(pj.u_d), pt.u_d.numpy())
    # alpha_scaled takes K from the string even when it disagrees
    odd = system.build_problem(
        OCPConfig(L_shape=True, L_shape_resolution=4,
                  ud_experiment="7_buoys"), device="cpu")
    assert odd.K == 3 and odd.alpha == 7e-6
    # the JAX package's (u_d, x0) carried across give the same problem
    ud_c, x0_c = convert.problem_data(udj, x0j)
    assert torch.equal(ud_c, pt.u_d) and torch.equal(x0_c, pt.x0)
    for case in range(5):
        fj = jax_system.initial_control(pj, case=case)
        ft = system.initial_control(pt, case=case)
        assert np.array_equal(ft.quad.numpy(), np.asarray(fj.quad))
        assert np.array_equal(ft.p2.numpy(), np.asarray(fj.p2))
    dj, dt_ = jax_system.fd_direction(pj), system.fd_direction(pt)
    assert np.array_equal(dt_.quad.numpy(), np.asarray(dj.quad))


@pytest.mark.parametrize("backend,psrc", [("gather", "scatter"),
                                          ("pallas", "fused")])
def test_lshape_gd_step_matches_jax(backend, psrc):
    """One GD step on the L-shape, table paths and kernel twins, against
    the JAX float64 table paths: J 1e-10, f_new and z 1e-8 relative (the
    bounds of tests/test_torch_system.py)."""
    kw = dict(L_shape=True, L_shape_resolution=6, ud_experiment="3_buoys",
              use_line_search=False, T=0.1, dt=0.005)
    pj = jax_system.build_problem(JaxConfig(**kw))
    pt = system.build_problem(
        OCPConfig(ode_backend=backend, psrc_method=psrc, **kw), device="cpu")
    fj = jax_system.initial_control(pj, case=0)
    rj = jax_system.gd_step(pj, fj, jnp.asarray(5.0), use_line_search=False)
    rt = system.gd_step(pt, convert.control(fj), 5.0)
    rel = lambda a, b: _d(a, b) / float(np.abs(np.asarray(b)).max())
    assert not rt.diverged and rt.fwd.newton.converged
    assert abs(float(rt.J) - float(rj.J)) / abs(float(rj.J)) < 1e-10
    assert rel(rt.f_new.quad, rj.f_new.quad) < 1e-8
    assert rel(rt.z, rj.z) < 1e-8
    assert rel(rt.fwd.x, rj.fwd.x) < 1e-10
    assert np.array_equal(rt.fwd.mask.numpy(), np.asarray(rj.fwd.mask))
