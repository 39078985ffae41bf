"""ocean_torch parity: the OCP and limits pipelines, their artifacts,
checkpoints and command line against ocean_jax.

Both packages run the L-shape experiment at resolution 6 for two
iterations (the square experiments of the JAX pipeline load reference
data that the repository does not hold). Tolerances: ``variables.txt``
equal as text; ``timings.txt`` equal as text once the seconds are masked;
``u_divergence.txt``, ``J_array.npy`` and the checkpointed control to
1e-8 relative (J 1e-10), the bounds of tests/test_torch_driver.py; the
mesh part of the XDMF files equal as text. A checkpoint written by either
package loads in the other with its arrays unchanged.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from ocean_jax import cli as jax_cli
from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax.io import checkpoint as jax_checkpoint
from ocean_jax.pipelines import ocp as jax_ocp

from ocean_torch import cli, convert
from ocean_torch import control as ctrl_mod
from ocean_torch.config import OCPConfig
from ocean_torch.fem import make_space
from ocean_torch.io import artifacts, checkpoint, plots
from ocean_torch.pipelines import limits, ocp

from torch_dolfin_files import write_dolfin_velocity

# The suite runs in several worker processes on one machine; PyTorch's
# default of one thread a core in each of them oversubscribes it.
torch.set_num_threads(2)

ARTIFACTS = ("variables.txt", "timings.txt", "u_divergence.txt",
             "J_array.npy", "checkpoints/q.npz", "checkpoints/q_history.npz",
             "q_backup/q.npz", "paraview/velocity.npz",
             "paraview/checkpoint/up.npz", "paraview/velocity.xdmf",
             "paraview/pressure.xdmf")
LSHAPE = dict(L_shape=True, ud_experiment="3_buoys", use_line_search=True,
              LR=5.0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_lshape_ocp_descends(tmp_path):
    """Mirror of tests/test_pipelines_e2e.py::test_lshape_ocp_descends at
    resolution 8: analytic 3-buoy measurements, Γ₁ = {x=0} ∪ {y=2},
    Armijo on, through the kernels' plain versions."""
    d = str(tmp_path) + "/"
    cfg = OCPConfig(L_shape_resolution=8, num_steps=3, out_dir=d,
                    ode_backend="pallas", psrc_method="fused", **LSHAPE)
    res, prob = ocp.run(cfg, verbose=False, device="cpu")
    assert prob.K == 3 and prob.space.locator.domain == "lshape"
    j = res.j_array
    assert len(j) == 3 and j[2] < j[1] < j[0]
    assert res.last_fwd.newton.converged
    assert not bool(res.last_fwd.mask.any())
    assert "L-shape" in open(d + "variables.txt").read()
    assert not [a for a in ARTIFACTS if not os.path.isfile(d + a)]
    # the JAX package's figures: mesh, cost, final field, a flow field and
    # a buoy-movement frame an iteration, a velocity comparison a buoy
    pngs = sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs if f.endswith(".png"))
    assert pngs == sorted(
        ["mesh.png", "J.png", "u_field.png"]
        + [f"flow_fields/u_{i}_field.png" for i in range(3)]
        + [f"buoy_movements/frames/buoy_movement_{i}.png" for i in range(3)]
        + [f"ud_plot_buoy_{k}.png" for k in range(3)])


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    dj = str(tmp_path_factory.mktemp("jax")) + "/"
    dt = str(tmp_path_factory.mktemp("torch")) + "/"
    kw = dict(L_shape_resolution=6, num_steps=2, **LSHAPE)
    rj, pj = jax_ocp.run(JaxConfig(out_dir=dj, **kw), verbose=False)
    rt, pt = ocp.run(OCPConfig(out_dir=dt, **kw), verbose=False,
                     device="cpu")
    return dj, dt, rj, rt, pj, pt


def test_artifact_text_equals_jax(both_runs):
    dj, dt, rj, rt, _, _ = both_runs
    assert rt.inner_iterations == rj.inner_iterations and rt.lr == rj.lr
    assert open(dt + "variables.txt").read() == \
        open(dj + "variables.txt").read()
    mask = lambda s: re.sub(r"\d+\.\d+ seconds", "# seconds", s)
    assert mask(open(dt + "timings.txt").read()) == \
        mask(open(dj + "timings.txt").read())
    assert "outer loop time: # seconds" in mask(open(dt + "timings.txt").read())
    lt = open(dt + "u_divergence.txt").read().splitlines()
    lj = open(dj + "u_divergence.txt").read().splitlines()
    assert len(lt) == len(lj) == 4 and lt[0::2] == lj[0::2]
    for a, b in zip(lt[1::2], lj[1::2]):
        (da, ia), (db, ib) = a.split(), b.split()
        assert ia == ib and abs(float(da) - float(db)) <= 1e-8 * float(db)
    assert _rel(np.load(dt + "J_array.npy"), np.load(dj + "J_array.npy")) \
        < 1e-10
    for name in ("velocity.xdmf", "pressure.xdmf"):
        xt = open(dt + "paraview/" + name).read().splitlines()
        xj = open(dj + "paraview/" + name).read().splitlines()
        assert len(xt) == len(xj)
        head = xt.index("      <Geometry GeometryType=\"XYZ\">")
        assert xt[:head] == xj[:head]                 # header and topology
        assert [l for l in xt if l.startswith(" ") and "<" in l] == \
            [l for l in xj if l.startswith(" ") and "<" in l]
    for name in ("paraview/velocity.npz", "paraview/checkpoint/up.npz"):
        with np.load(dt + name) as zt, np.load(dj + name) as zj:
            assert sorted(zt.files) == sorted(zj.files) == ["p", "u", "w"]
            assert _rel(zt["u"], zj["u"]) < 1e-8
            assert zt["w"].shape == zj["w"].shape


def test_checkpoints_load_across_packages(both_runs, tmp_path):
    dj, dt, rj, rt, pj, pt = both_runs
    # written by the JAX package, loaded by the port
    for path in ("q_backup/q.npz", "checkpoints/q.npz"):
        f, lr, it = checkpoint.load_control(dj + path, pt.space, pt.bq)
        assert np.array_equal(f.quad.numpy(), np.asarray(rj.f.quad))
        assert np.array_equal(f.p2.numpy(), np.asarray(rj.f.p2))
        f2, lr2, it2 = convert.control_checkpoint(dj + path)
        assert torch.equal(f2.quad, f.quad) and (lr2, it2) == (lr, it)
    assert (lr, it) == (None, 1)
    _, lr, it = checkpoint.load_control(dj + "q_backup/q.npz", pt.space,
                                        pt.bq)
    assert (lr, it) == (rj.lr, 2)
    # written by the port, loaded by the JAX package
    f, lr, it = jax_checkpoint.load_control(dt + "q_backup/q.npz", pj.space,
                                            pj.bq)
    assert np.array_equal(np.asarray(f.quad), rt.f.quad.numpy())
    assert np.array_equal(np.asarray(f.p2), rt.f.p2.numpy())
    assert (lr, it) == (rt.lr, 2)
    # the two runs' controls agree
    assert _rel(rt.f.quad.numpy(), rj.f.quad) < 1e-8
    # the history: one entry an iteration, same keys and shapes
    ht = jax_checkpoint.load_control_history(dt + "checkpoints/q_history.npz")
    hj = checkpoint.load_control_history(dj + "checkpoints/q_history.npz")
    for a, b in zip(ht, hj):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert ht[3].tolist() == [0, 1] and np.isnan(ht[2]).all()
    assert np.array_equal(ht[0][-1], rt.f.quad.numpy())
    # a control carried across as an object
    assert torch.equal(convert.control(rj.f).quad,
                       torch.as_tensor(np.asarray(rj.f.quad)))
    # a dolfin file: load_control names load_dolfin_control (as in the JAX
    # package), which reads it on this mesh
    with pytest.raises(ValueError, match="load_dolfin_control"):
        checkpoint.load_control("q.h5", pt.space, pt.bq)
    h5 = str(tmp_path / "q.h5")
    mesh = ocp._mesh(OCPConfig(L_shape_resolution=6, **LSHAPE))
    write_dolfin_velocity(h5, mesh, pt.space.cell_dofs_p2.numpy(),
                          rt.f.p2.numpy(), name="f")
    f_h5 = checkpoint.load_dolfin_control(h5, mesh, pt.space, pt.bq)
    assert torch.equal(f_h5.p2, rt.f.p2)
    assert torch.equal(f_h5.quad,
                       ctrl_mod.from_p2(pt.space, pt.bq, rt.f.p2).quad)


def test_warm_start_and_resume(both_runs, tmp_path):
    dj, dt, rj, rt, _, _ = both_runs
    kw = dict(L_shape_resolution=6, num_steps=1, **LSHAPE)
    # load_q: another run's final control, here the JAX package's
    warm, _ = ocp.run(OCPConfig(out_dir=str(tmp_path) + "/a/", load_q=True,
                                load_string=dj + "q_backup/q.npz", **kw),
                      verbose=False, device="cpu")
    assert warm.j_array[0] < rt.j_array[-1]
    # checkpoints=True resumes from the run directory's checkpoints/q.npz
    d = str(tmp_path) + "/b/"
    first, _ = ocp.run(OCPConfig(out_dir=d, **kw), verbose=False,
                       device="cpu")
    again, _ = ocp.run(OCPConfig(out_dir=d, checkpoints=True, **kw),
                       verbose=False, device="cpu")
    assert again.j_array[0] < first.j_array[0]
    assert _rel(again.j_array[0], rt.j_array[1]) < 1e-10
    hist = checkpoint.load_control_history(d + "checkpoints/q_history.npz")
    assert hist[3].tolist() == [0, 0]          # appended, not overwritten
    # a checkpoint of another problem is refused
    with pytest.raises(ValueError):
        ocp.run(OCPConfig(out_dir=str(tmp_path) + "/c/", load_q=True,
                          load_string=dj + "q_backup/q.npz",
                          **{**kw, "L_shape_resolution": 4}),
                verbose=False, device="cpu")


def prob_cfg(cfg):
    """The square of a limits run (which forces the square)."""
    return dataclasses.replace(cfg, L_shape=False)


def test_limits_run_small(tmp_path, capsys, monkeypatch):
    """The scalability pipeline at Nx=8, K=100: measurements synthesized
    into a cache, fast paths on, line search on, escape threshold 10.
    Figures off: a hundred buoys' would take a minute here, and
    ``test_torch_plots.py`` draws them."""
    monkeypatch.setattr(plots, "available", lambda: False)
    d, cache = str(tmp_path) + "/run/", str(tmp_path / "ud")
    cfg = OCPConfig(ud_experiment="100_buoys", unit_square_resolution=8,
                    use_line_search=True, LR=5.0, num_steps=2, out_dir=d,
                    reference_runs_dir=str(tmp_path / "none"),
                    L_shape=True)                   # limits forces the square
    res, prob, norm_table = limits.run(cfg, verbose=False, device="cpu",
                                       ud_cache_dir=cache)
    assert norm_table is None and prob.K == 100
    assert prob.space.locator.domain == "rect"
    assert (prob.newton_reuse_lu, prob.psrc_method, prob.ode_backend,
            prob.projector.mode) == (True, "fused", "pallas", "inverse")
    assert os.path.isfile(cache + "/100_buoys/u_d_array.npy")
    assert res.iterations_run == 2 and res.j_array[1] < res.j_array[0]
    assert not [a for a in ARTIFACTS if not os.path.isfile(d + a)]
    text = open(d + "variables.txt").read()
    assert "buoy count: 100 \n" in text and "ud type: custom_ud \n" in text
    # fast_paths=False leaves the configuration's plain defaults
    _, slow, _ = limits.run(dataclasses.replace(cfg, num_steps=1),
                            write_artifacts=False, verbose=False,
                            fast_paths=False, device="cpu",
                            ud_cache_dir=cache)
    assert (slow.newton_reuse_lu, slow.psrc_method, slow.ode_backend,
            slow.projector.mode) == (False, "scatter", "gather", "lu")
    # the u_bar comparison: with the stored checkpoint present the run
    # writes norm_table.txt; at another resolution it says it skips
    ubar = tmp_path / "ref" / "u_bar_chapter_6.3.3" / "paraview" / "checkpoint"
    ubar.mkdir(parents=True)
    u, _ = prob.space.split(res.last_fwd.w)
    write_dolfin_velocity(str(ubar / "u.h5"), ocp._mesh(prob_cfg(cfg)),
                          prob.space.cell_dofs_p2.numpy(), u.numpy())
    ref_cfg = dataclasses.replace(cfg, reference_runs_dir=str(tmp_path / "ref"),
                                  num_steps=1, out_dir=d + "ubar/")
    _, _, table = limits.run(ref_cfg, verbose=False, device="cpu",
                             ud_cache_dir=cache)
    assert len(table) == 2 and all(v > 0 for v in table)
    assert open(d + "ubar/norm_table.txt").read().split()[2:] == \
        [str(v) for v in table]
    _, _, skipped = limits.run(
        dataclasses.replace(ref_cfg, unit_square_resolution=6,
                            out_dir=d + "ubar6/"),
        verbose=True, device="cpu", ud_cache_dir=cache)
    assert skipped is None and "skipping u_bar comparison: checkpoint mesh " \
        "has 81 vertices but ours has 49" in capsys.readouterr().out
    assert not os.path.exists(d + "ubar6/norm_table.txt")


ARGVS = [
    [],
    ["--l-shape", "--l-shape-resolution", "12", "--num-steps", "7",
     "--no-line-search", "--lr", "2.5", "--out-dir", "x/"],
    ["--fast", "--ud-experiment", "10000_buoys", "--viscosity", "0.5",
     "--alpha", "1e-5", "--dt", "0.01", "--T", "0.5", "--grad-check",
     "--checkpoints", "--load-q", "q.npz", "--lr-min", "1e-5", "--lr-max",
     "9", "--conv-crit", "1e-4"],
    ["--fast", "--psrc-method", "ozaki_pallas", "--ode-backend", "gather",
     "--dense-apply", "lu", "--projector-solver", "cg"],
    ["--linear-solver", "mg", "--mg-pre", "3", "--mg-post", "1",
     "--mg-coarse-krylov", "4", "--mg-leaf-budget", "100",
     "--newton-continuation", "6", "--newton-chord-f32"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:2]) or "-")
def test_cli_flags_give_the_jax_config(argv):
    """Every flag of the JAX command line is accepted and gives the same
    configuration; ``--device`` is the port's own."""
    dj, dt = JaxConfig(use_line_search=True), OCPConfig(use_line_search=True)
    cj = jax_cli.config_from_args(
        jax_cli.build_parser("p", dj).parse_args(argv), dj)
    args = cli.build_parser("p", dt).parse_args(argv + ["--device", "cpu"])
    ct = cli.config_from_args(args, dt)
    a, b = dataclasses.asdict(cj), dataclasses.asdict(ct)
    a.pop("reference_runs_dir"), b.pop("reference_runs_dir")
    assert a == b and args.device == "cpu"
    assert cli.build_parser("p", dt).parse_args(argv).device == "cuda"


@pytest.mark.parametrize("flags,name", [
    (["--linear-solver", "mg", "--newton-continuation", "2",
      "--viscosity", "0.5"], "linear_solver"),
    (["--newton-continuation", "3", "--viscosity", "0.2"],
     "newton_continuation"),
    (["--newton-chord-f32", "--fast"], "newton_chord_f32"),
    (["--load-q", "q.h5"], "load_dolfin_control"),
])
def test_cli_once_refused_flags_run(tmp_path, flags, name):
    """The four command lines once refused by name run to their end and
    write their artifacts; ``--load-q`` takes a dolfin control on the
    mesh."""
    out = str(tmp_path) + "/run/"
    if name == "load_dolfin_control":
        cfg = OCPConfig(L_shape_resolution=4, **LSHAPE)
        mesh = ocp._mesh(cfg)
        space = make_space(mesh, device="cpu")
        u = np.random.default_rng(2).standard_normal((space.n_p2, 2))
        write_dolfin_velocity(str(tmp_path / "q.h5"), mesh,
                              space.cell_dofs_p2.numpy(), 0.1 * u, name="f")
        flags = ["--load-q", str(tmp_path / "q.h5")]
    res, prob = ocp.main(["--device", "cpu", "--l-shape",
                          "--l-shape-resolution", "4", "--num-steps", "1",
                          "--out-dir", out] + flags)
    assert res.iterations_run == 1 and res.last_fwd.newton.converged
    assert not [a for a in ARTIFACTS if not os.path.isfile(out + a)]
    assert prob.newton_continuation == int(
        dict(zip(flags, flags[1:])).get("--newton-continuation", 0))
    assert prob.newton_chord_f32 == ("--newton-chord-f32" in flags)


def test_cli_entry_points_run(tmp_path, monkeypatch):
    d = str(tmp_path) + "/ocp/"
    res, prob = ocp.main(["--device", "cpu", "--l-shape",
                          "--l-shape-resolution", "4", "--num-steps", "1",
                          "--out-dir", d])
    assert prob.K == 3 and os.path.isfile(d + "variables.txt")
    # without a card the default device refuses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ocp.main(["--l-shape", "--l-shape-resolution", "4", "--out-dir", d])
    # both modules have a __main__ entry point
    for mod in (ocp, limits):
        assert 'if __name__ == "__main__":' in open(mod.__file__).read()


def test_artifact_writers_equal_the_jax_package(tmp_path):
    """The port keeps its own copy of the writers: same bytes."""
    from ocean_jax.io import artifacts as jax_artifacts
    calls = [
        ("write_variables", (32, "custom_ud", 0.0, 1.0, 0.005, 1.0, 10000,
                             0.00244140625, 5.0, 1e-6, 1e-3, 30)),
        ("write_timings", ([0.5, 0.25], [1.5, 0.125], [12, 1])),
        ("write_divergence", ([1.25e-3, 2.5e-4],)),
        ("write_norm_table", (0.125, 0.5)),
        ("write_grad_table", (-0.25, [(-0.2, 0.05, 0.1), (-0.24, 0.01, 0.01)])),
        ("save_j_array", ([28.9, 5.9, 3.0],)),
    ]
    for name, args in calls:
        pj, pt = str(tmp_path / ("j_" + name)), str(tmp_path / ("t_" + name))
        getattr(jax_artifacts, name)(pj, *args)
        getattr(artifacts, name)(pt, *args)
        assert open(pj, "rb").read() == open(pt, "rb").read(), name
    assert artifacts.RunDirectory.SUBDIRS == jax_artifacts.RunDirectory.SUBDIRS
    run_dir = artifacts.RunDirectory(str(tmp_path / "tree"))
    assert all(os.path.isdir(run_dir.path(s)) for s in run_dir.SUBDIRS)
