"""The port's figure set (``ocean_torch/io/plots.py``) wired into
``pipelines/ocp.py`` as the JAX package draws it, and the post-processing
toolbox (``ocean_torch/postprocess.py``), against ocean_jax.

* A tiny ``ocp.run`` in both packages (Nx = 8, 2 buoys, 2 iterations) on
  the same synthesized measurements, written in the reference layout under
  a temporary ``reference_runs_dir``: the same set of file names, and
  ``variables.txt`` equal line for line. At K = 400 (one iteration) both
  append the line of the 12-plot cap.
* matplotlib made unimportable: the port prints the skip line once and
  writes every file but the figures.
* ``aggregate_timings`` equal to JAX's on a run's ``timings.txt``; each
  figure function of ``postprocess`` writes its PNG.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ocean_jax import postprocess as jax_postprocess
from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax.pipelines import ocp as jax_ocp

from ocean_torch import postprocess
from ocean_torch.config import OCPConfig
from ocean_torch.io import plots
from ocean_torch.mesh import rectangle_mesh
from ocean_torch.fem import make_space
from ocean_torch.pipelines import ocp, ud_construction

from torch_dolfin_files import write_dolfin_velocity

pytest.importorskip("matplotlib", reason="the figures need matplotlib")

torch.set_num_threads(2)

BASE = dict(unit_square_resolution=8, use_line_search=True, T=0.1)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("reference_runs")
    for K in (2, 400):
        ud_construction.run(nx=8, K=K, T=0.1,
                            out_dir=str(base / f"{K}_buoys"), device="cpu")
    return str(base)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _runs(reference_runs, tmp_path, K, num_steps, torch_only=False):
    kw = dict(BASE, ud_experiment=f"{K}_buoys", num_steps=num_steps,
              reference_runs_dir=reference_runs)
    out_t, out_j = str(tmp_path / "torch") + "/", str(tmp_path / "jax") + "/"
    ocp.run(OCPConfig(**kw, out_dir=out_t), verbose=False, device="cpu")
    if not torch_only:
        jax_ocp.run(JaxConfig(**kw, out_dir=out_j), verbose=False)
    return out_t, out_j


@pytest.fixture(scope="module")
def two_buoys(reference_runs, tmp_path_factory):
    return _runs(reference_runs, tmp_path_factory.mktemp("k2"), 2, 2)


def test_same_files_as_jax(two_buoys):
    out_t, out_j = two_buoys
    files = _files(out_t)
    assert files == _files(out_j)
    for name in ("mesh.png", "J.png", "u_field.png", "ud_plot_buoy_1.png",
                 "flow_fields/u_1_field.png",
                 "buoy_movements/frames/buoy_movement_1.png"):
        assert name in files and os.path.getsize(out_t + name) > 1000


def test_variables_equal_to_jax(two_buoys):
    out_t, out_j = two_buoys
    with open(out_t + "variables.txt") as a, open(out_j + "variables.txt") as b:
        assert a.read().splitlines() == b.read().splitlines()


def test_cap_line_at_400_buoys(reference_runs, tmp_path):
    out_t, out_j = _runs(reference_runs, tmp_path, 400, 1)
    with open(out_t + "variables.txt") as a, open(out_j + "variables.txt") as b:
        lines_t, lines_j = a.read().splitlines(), b.read().splitlines()
    cap = ("per-buoy velocity plots capped at 12 of 400 buoys "
           "(plot_all_buoys=False)")
    assert lines_t == lines_j and lines_t[-1] == cap
    plotted = [f for f in _files(out_t) if f.startswith("ud_plot_buoy_")]
    assert len(plotted) == 12 and _files(out_t) == _files(out_j)


def test_without_matplotlib_everything_else(reference_runs, tmp_path,
                                            monkeypatch, capsys,
                                            two_buoys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plots.available()
    out_t, _ = _runs(reference_runs, tmp_path, 2, 2, torch_only=True)
    assert capsys.readouterr().out.splitlines().count(plots.SKIP_LINE) == 1
    want = [f for f in _files(two_buoys[0]) if not f.endswith(".png")]
    assert _files(out_t) == want


def test_aggregate_timings_equal_to_jax(two_buoys):
    out_t, _ = two_buoys
    path = out_t + "timings.txt"
    assert postprocess.aggregate_timings(path) == \
        jax_postprocess.aggregate_timings(path)


def test_postprocess_figures(two_buoys, tmp_path):
    pytest.importorskip("h5py", reason="a dolfin field needs h5py")
    out_t, out_j = two_buoys
    path = str(tmp_path / "overlay.png")
    postprocess.cost_curve_overlay({"port": out_t + "J_array.npy",
                                    "jax": out_j + "J_array.npy"}, path)
    hist = str(tmp_path / "hist.png")
    postprocess.timing_histogram(hist, iteration_times=[0.01, 0.1, 0.5, 4.6])
    npz = str(tmp_path / "field_npz.png")
    postprocess.replot_field(out_t + "paraview/checkpoint/up.npz", npz, nx=8)
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    space = make_space(mesh, device="cpu")
    u = np.load(out_t + "paraview/checkpoint/up.npz")["u"]
    write_dolfin_velocity(str(tmp_path / "u.h5"), mesh,
                          space.cell_dofs_p2.numpy(), u)
    h5 = str(tmp_path / "field_h5.png")
    postprocess.replot_field(str(tmp_path / "u.h5"), h5, nx=8)
    for p in (path, hist, npz, h5):
        assert os.path.getsize(p) > 1000
