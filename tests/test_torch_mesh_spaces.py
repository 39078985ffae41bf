"""ocean_torch parity: config, mesh, Taylor–Hood space, boundary
quadrature, Dirichlet BCs and point location against ocean_jax.

Tolerance: exact equality for every table the port copies or rebuilds
with the same numpy code (dofmaps, tags, BC dofs and values, quadrature);
point location goes through the same float64 formulas in another
framework, so reference coordinates agree to 1e-15 and cells exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax.mesh import structured as jax_structured
from ocean_jax.mesh.locate import locate_points as jax_locate
from ocean_jax.fem import spaces as jax_spaces
from ocean_jax.pipelines import ud_construction as jax_udc

from ocean_torch.config import OCPConfig
from ocean_torch.mesh import structured, locate_points
from ocean_torch.fem import spaces
from ocean_torch.pipelines import ud_construction as udc


def test_config_fields_and_quirks_match():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(OCPConfig)}
    assert jf.keys() == tf.keys()
    # the reference-runs location is a deployment path, not a knob of the
    # algorithm; the port keeps it relative
    for d in (jf, tf):
        d.pop("reference_runs_dir")
    assert jf == tf
    for exp in ("2_buoys", "10000_buoys"):
        j = JaxConfig(ud_experiment=exp, T=0.73, dt=0.005)
        t = OCPConfig(ud_experiment=exp, T=0.73, dt=0.005)
        assert (j.K, j.alpha_scaled, j.num_time_steps) == \
            (t.K, t.alpha_scaled, t.num_time_steps)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_mesh_tables_equal(n):
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n)
    for name in ("vertices", "cells", "edges", "cell_edges", "bf_vertices",
                 "bf_cells", "bf_local", "bf_normals", "square_to_cell"):
        assert np.array_equal(np.asarray(getattr(mj, name)),
                              getattr(mt, name)), name
    for name in ("origin", "spacing", "grid_shape", "extent", "diagonal"):
        assert getattr(mj, name) == getattr(mt, name), name
    pred = lambda x: np.abs(x[:, 0]) < 1e-12
    assert np.array_equal(jax_structured.mark_boundary_facets(mj, pred),
                          structured.mark_boundary_facets(mt, pred))


def test_unit_square_equal():
    mj = jax_structured.unit_square_mesh(5)
    mt = structured.unit_square_mesh(5)
    assert np.array_equal(mj.vertices, mt.vertices)
    assert np.array_equal(mj.cells, mt.cells)


def test_space_bcs_and_boundary_quad_equal():
    n = 6
    mj = jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n)
    mt = structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n)
    sj = jax_spaces.make_space(mj)
    st = spaces.make_space(mt, "cpu")
    assert (sj.n_p2, sj.n_p1, sj.ndof) == (st.n_p2, st.n_p1, st.ndof)
    for name in ("cell_dofs_p2", "cell_dofs_p1", "cell_dofs_mixed",
                 "cell_jinv", "cell_detj", "qw", "phi1", "phi2",
                 "dphi2_ref", "dphi1_ref", "dof_coords_p2", "inc_mixed"):
        assert np.array_equal(np.asarray(getattr(sj, name)),
                              getattr(st, name).numpy()), name

    g1 = lambda x: (np.abs(x[:, 0]) < 1e-12) | (np.abs(2.0 - x[:, 0]) < 1e-12)
    tags = jax_structured.mark_boundary_facets(mj, g1)
    bj = jax_spaces.make_boundary_quad(mj, tags)
    bt = spaces.make_boundary_quad(mt, tags, device="cpu")
    for name in ("facet_ids", "cells", "phi2", "normals", "weights",
                 "points"):
        assert np.array_equal(np.asarray(getattr(bj, name)),
                              getattr(bt, name).numpy()), name
    assert np.array_equal(np.asarray(sj.cell_dofs_mixed)[np.asarray(bj.cells)],
                          bt.dofs_mixed.numpy())

    # the u_d construction's three BCs, merged last-wins
    inflow = jax_udc.constant_inflow
    _, _, (dj, vj), _ = jax_udc.build(n, 1.0, "right", inflow)
    _, _, (dt_, vt), _ = udc.build(n, 1.0, "right", inflow, device="cpu")
    assert np.array_equal(np.asarray(dj), dt_.numpy())
    assert np.array_equal(np.asarray(vj), vt.numpy())
    pj = jax_spaces.dirichlet_pressure_bc(mj, sj, lambda x: x[:, 0] < 1e-12)
    pt = spaces.dirichlet_pressure_bc(mt, st, lambda x: x[:, 0] < 1e-12)
    assert np.array_equal(np.asarray(pj[0]), pt[0].numpy())


def test_locate_points_match():
    n = 8
    sj = jax_spaces.make_space(
        jax_structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n))
    st = spaces.make_space(
        structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n), "cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.3, 2.3, (500, 2))
    pts[:20] = np.round(pts[:20] * 4) / 4          # points on grid lines
    pts[20:30, 0] = 2.0 + 1e-13                     # inside the slack
    pts[30:40, 1] = -2e-12                          # outside the slack
    cj, xj, ij = jax_locate(sj.locator, pts)
    ct, xt, it = locate_points(st.locator, torch.as_tensor(pts))
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert np.max(np.abs(np.asarray(xj) - xt.numpy())) < 1e-15
