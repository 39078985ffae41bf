"""The port's dolfin HDF5 reader (``ocean_torch/io/dolfin_h5.py``), its
dolfin warm start (``io/checkpoint.py::load_dolfin_control``) and the
``norm_table.txt`` of the limits and initial-control pipelines, against
ocean_jax on the same files.

The files are written with h5py in the layout of
``read_checkpoint_velocity``'s docstring (``tests/torch_dolfin_files.py``:
vertices permuted, cells renumbered, local vertices rotated, dofs
scattered). Bars: the two readers' arrays equal, and equal to the field
written; the dolfin control within 1e-14 of JAX's; a checkpoint of
another resolution raises ``ValueError`` in both packages; the norm
table of a tiny ``limits.run`` and ``initial_control.run`` within 1e-12
relative of JAX's.
"""

import sys

import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax.fem import make_space as jax_make_space
from ocean_jax.io import checkpoint as jax_checkpoint
from ocean_jax.io import dolfin_h5 as jax_dolfin
from ocean_jax.mesh import (rectangle_mesh as jax_rectangle_mesh,
                            l_shape_mesh as jax_l_shape_mesh)
from ocean_jax.pipelines import initial_control as jax_ic
from ocean_jax.pipelines import limits as jax_limits
from ocean_jax import system as jax_system

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.fem import make_space
from ocean_torch.io import checkpoint, dolfin_h5
from ocean_torch.mesh import rectangle_mesh, l_shape_mesh
from ocean_torch.pipelines import initial_control, limits, ud_construction

from torch_dolfin_files import write_dolfin_velocity

pytest.importorskip("h5py", reason="the dolfin reader needs h5py")

torch.set_num_threads(2)

MESHES = {
    "square Nx=8": (lambda: rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8),
                    lambda: jax_rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)),
    "square Nx=6 left": (
        lambda: rectangle_mesh((0.0, 0.0), (2.0, 2.0), 6, 6, "left"),
        lambda: jax_rectangle_mesh((0.0, 0.0), (2.0, 2.0), 6, 6, "left")),
    "L-shape 6": (lambda: l_shape_mesh(6), lambda: jax_l_shape_mesh(6)),
}


def _field(space, seed=3):
    return np.random.default_rng(seed).standard_normal((space.n_p2, 2))


def _write(path, mesh, space, u, name="u"):
    write_dolfin_velocity(str(path), mesh, space.cell_dofs_p2.numpy(), u,
                          name=name)


@pytest.mark.parametrize("which", list(MESHES))
def test_readers_agree(tmp_path, which):
    mk_t, mk_j = MESHES[which]
    mt, mj = mk_t(), mk_j()
    st, sj = make_space(mt, device="cpu"), jax_make_space(mj)
    u = _field(st)
    _write(tmp_path / "u.h5", mt, st, u)
    got_t = dolfin_h5.read_checkpoint_velocity(str(tmp_path / "u.h5"), mt,
                                               st, "u")
    got_j = jax_dolfin.read_checkpoint_velocity(str(tmp_path / "u.h5"), mj,
                                                sj, "u")
    assert np.array_equal(got_t, np.asarray(got_j))
    assert np.array_equal(got_t, u)


def test_dolfin_control_matches_jax(tmp_path):
    cfg = dict(unit_square_resolution=8, ud_experiment="2_buoys")
    u_d, x0 = np.zeros((2, 200, 2)), np.full((2, 2), 0.5)
    pt = system.build_problem(OCPConfig(**cfg), u_d=u_d, x0=x0, device="cpu")
    pj = jax_system.build_problem(JaxConfig(**cfg), u_d=u_d, x0=x0)
    mt = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    mj = jax_rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    path = str(tmp_path / "q.h5")
    _write(path, mt, pt.space, _field(pt.space, seed=5), name="f")
    ft = checkpoint.load_dolfin_control(path, mt, pt.space, pt.bq)
    fj = jax_checkpoint.load_dolfin_control(path, mj, pj.space, pj.bq)
    for a, b in ((ft.quad, fj.quad), (ft.p2, fj.p2)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-14 * np.abs(b).max()
    # load_control refuses a dolfin file by name in both packages
    for load, space, bq in ((checkpoint.load_control, pt.space, pt.bq),
                            (jax_checkpoint.load_control, pj.space, pj.bq)):
        with pytest.raises(ValueError, match="load_dolfin_control"):
            load(path, space, bq)


def test_other_resolution_raises_in_both(tmp_path):
    m8 = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    s8 = make_space(m8, device="cpu")
    _write(tmp_path / "u.h5", m8, s8, _field(s8))
    mt = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 6, 6)
    mj = jax_rectangle_mesh((0.0, 0.0), (2.0, 2.0), 6, 6)
    with pytest.raises(ValueError, match="resolutions must match"):
        dolfin_h5.read_checkpoint_velocity(str(tmp_path / "u.h5"), mt,
                                           make_space(mt, device="cpu"))
    with pytest.raises(ValueError, match="resolutions must match"):
        jax_dolfin.read_checkpoint_velocity(str(tmp_path / "u.h5"), mj,
                                            jax_make_space(mj))


def test_reader_without_h5py_names_it(tmp_path, monkeypatch):
    m = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 4, 4)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        dolfin_h5.read_checkpoint_velocity(str(tmp_path / "u.h5"), m,
                                           make_space(m, device="cpu"))


K = 6
BASE = dict(ud_experiment=f"{K}_buoys", unit_square_resolution=8,
            num_steps=1, use_line_search=False, T=0.1)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """A reference_runs directory: the 6-buoy measurements and the stored
    ū (the Nx=8 Taylor–Green flow, ν = 1) as a dolfin checkpoint."""
    base = tmp_path_factory.mktemp("reference_runs")
    r = ud_construction.run(nx=8, K=K, T=0.1,
                            out_dir=str(base / f"{K}_buoys"), device="cpu")
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    space = make_space(mesh, device="cpu")
    ubar = base / "u_bar_chapter_6.3.3" / "paraview" / "checkpoint"
    ubar.mkdir(parents=True)
    u, _ = space.split(r["w"])
    _write(ubar / "u.h5", mesh, space, u.numpy())
    return str(base)


def _table(path):
    with open(path) as fh:
        return [float(v) for v in fh.read().split()[2:]]


@pytest.mark.parametrize("pipeline", ["limits", "initial_control"])
def test_norm_table_matches_jax(reference_runs, tmp_path, pipeline):
    kw = dict(BASE, reference_runs_dir=reference_runs)
    out_t, out_j = str(tmp_path / "torch") + "/", str(tmp_path / "jax") + "/"
    if pipeline == "limits":
        _, _, nt = limits.run(OCPConfig(**kw, out_dir=out_t), verbose=False,
                              fast_paths=False, device="cpu")
        _, _, nj = jax_limits.run(JaxConfig(**kw, out_dir=out_j),
                                  verbose=False, fast_paths=False)
    else:
        _, _, nt = initial_control.run(OCPConfig(**kw, out_dir=out_t),
                                       verbose=False, device="cpu")
        _, _, nj = jax_ic.run(JaxConfig(**kw, out_dir=out_j), verbose=False)
    assert nt is not None and nj is not None
    for a, b in zip(nt, nj):
        assert 0.0 < b and abs(a - b) <= 1e-12 * b
    ft, fj = _table(out_t + "norm_table.txt"), _table(out_j + "norm_table.txt")
    assert np.allclose(ft, fj, rtol=1e-12, atol=0.0)
    assert ft == list(nt)
