"""ocean_torch parity: the initial-control study
(``pipelines/initial_control.py``) against ocean_jax, on a temporary
``reference_runs_dir`` (K=6, Nx=8, nt=100, measurements from a numpy
seed), line search off as in the study's command line.

* ``run`` of both packages from case 2 for 2 iterations: ``J_array.npy``
  to 1e-10 relative, the port's artifacts present.
* ``run_all_cases_fused`` against the port's own ``run_ensemble`` over the
  four cases (bit for bit), and against ``run_all_cases`` (each case
  through the driver: the same J histories to 1e-12).
* The stored ū flow present (a dolfin checkpoint): ``norm_table.txt``
  holds ‖u − ū‖ in L² and H¹; at another resolution the comparison is
  skipped with the JAX package's message.
* The command line on the CPU.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax.pipelines import initial_control as jax_ic

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.fem import assemble, make_space
from ocean_torch.mesh import rectangle_mesh
from ocean_torch.opt.ensemble import run_ensemble, stack_controls
from ocean_torch.pipelines import initial_control

from torch_dolfin_files import write_dolfin_velocity

torch.set_num_threads(2)

K = 6
BASE = dict(ud_experiment=f"{K}_buoys", unit_square_resolution=8,
            num_steps=2, use_line_search=False, T=0.5, LR=2.0)
ARTIFACTS = ("variables.txt", "timings.txt", "u_divergence.txt",
             "J_array.npy", "q_backup/q.npz", "paraview/velocity.npz",
             "paraview/checkpoint/up.npz", "paraview/velocity.xdmf",
             "paraview/pressure.xdmf")


def _write_runs(base):
    """u_d_array.npy (K, nt, 2) and x_0_array.npy (K, nt, 2) in the
    reference's layout."""
    rng = np.random.default_rng(21)
    nt = OCPConfig(**BASE).num_time_steps
    d = os.path.join(base, f"{K}_buoys")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "u_d_array.npy"),
            0.05 * rng.standard_normal((K, nt, 2)))
    x0 = 0.4 + 1.2 * rng.random((K, 2))
    np.save(os.path.join(d, "x_0_array.npy"),
            np.repeat(x0[:, None, :], nt, axis=1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("reference_runs"))
    _write_runs(base)
    return base


def test_run_matches_jax(runs, tmp_path):
    rj, _, nj = jax_ic.run(
        JaxConfig(**BASE, reference_runs_dir=runs,
                  out_dir=str(tmp_path / "jax") + "/"),
        case=2, verbose=False)
    rt, pt, nt_ = initial_control.run(
        OCPConfig(**BASE, reference_runs_dir=runs,
                  out_dir=str(tmp_path / "torch") + "/"),
        case=2, verbose=False, device="cpu")
    assert nj is None and nt_ is None
    assert pt.K == K and rt.iterations_run == rj.iterations_run == 2
    out = tmp_path / "torch"
    assert [a for a in ARTIFACTS if not (out / a).is_file()] == []
    jt = np.load(out / "J_array.npy")
    jj = np.load(tmp_path / "jax" / "J_array.npy")
    assert jt.shape == jj.shape == (2,)
    assert np.abs(jt - jj).max() < 1e-10 * np.abs(jj).max()


def test_fused_cases_are_the_ensemble_and_the_driver(runs, tmp_path):
    cfg = OCPConfig(**BASE, reference_runs_dir=runs,
                    out_dir=str(tmp_path) + "/")
    ens, prob = initial_control.run_all_cases_fused(cfg, device="cpu")
    f0 = stack_controls([system.initial_control(prob, c) for c in range(4)])
    ref = run_ensemble(prob, f0, torch.full((4,), cfg.LR), cfg.num_steps,
                       escape_threshold=K / 2)
    for a, b in zip(ens[:4], ref[:4]):
        assert torch.equal(a, b)
    assert torch.equal(ens.f_final.quad, ref.f_final.quad)
    assert ens.j_history.shape == (2, 4)
    assert bool(torch.isfinite(ens.j_history).all())
    assert len(np.unique(np.round(ens.j_history[-1].numpy(), 12))) == 4
    per_case = initial_control.run_all_cases(cfg, device="cpu")
    for c in range(4):
        res = per_case[c][0]
        assert (tmp_path / f"case_{c}" / "J_array.npy").is_file()
        assert np.abs(np.asarray(res.j_array)
                      - ens.j_history[:, c].numpy()).max() \
            < 1e-12 * float(ens.j_history[:, c].abs().max())


def test_stored_ubar_is_not_ported(runs, tmp_path, capsys):
    """The stored ū flow, once refused, gives ``norm_table.txt``: from a
    dolfin checkpoint on this mesh, and at another resolution the JAX
    package's skip message."""
    ubar = tmp_path / "ref" / "u_bar_chapter_6.3.3" / "paraview" / "checkpoint"
    ubar.mkdir(parents=True)
    ref = str(tmp_path / "ref")
    shutil.copytree(os.path.join(runs, f"{K}_buoys"),
                    os.path.join(ref, f"{K}_buoys"))
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8)
    space = make_space(mesh, device="cpu")
    u = np.random.default_rng(4).standard_normal((space.n_p2, 2))
    write_dolfin_velocity(str(ubar / "u.h5"), mesh,
                          space.cell_dofs_p2.numpy(), 0.1 * u)
    out = str(tmp_path / "out") + "/"
    cfg = OCPConfig(**{**BASE, "num_steps": 1}, reference_runs_dir=ref,
                    out_dir=out)
    res, prob, table = initial_control.run(cfg, verbose=False, device="cpu")
    uf, _ = prob.space.split(res.last_fwd.w)
    l2, h1 = assemble.velocity_diff_norms(prob.space, uf,
                                          torch.as_tensor(0.1 * u))
    assert table == (float(l2), float(h1))
    assert open(out + "norm_table.txt").read().split()[2:] == \
        [str(v) for v in table]
    _, _, skipped = initial_control.run(
        dataclasses.replace(cfg, unit_square_resolution=6),
        write_artifacts=False, device="cpu")
    assert skipped is None and "skipping u_bar comparison: checkpoint " \
        "mesh has 81 vertices but ours has 49" in capsys.readouterr().out


def test_command_line(runs, tmp_path, monkeypatch):
    """``python -m ocean_torch.pipelines.initial_control`` reads the
    default ``reference/reference_runs`` beside the working directory."""
    ref = tmp_path / "reference"
    ref.mkdir()
    os.symlink(runs, ref / "reference_runs")
    monkeypatch.chdir(tmp_path)
    res, prob, _ = initial_control.main(
        ["--device", "cpu", "--case", "2", "--unit-square-resolution", "8",
         "--num-steps", "1", "--T", "0.5", "--out-dir", str(tmp_path / "o")])
    assert prob.K == K and res.iterations_run == 1
    assert dataclasses.asdict(OCPConfig())["reference_runs_dir"] == \
        "reference/reference_runs"
    assert (tmp_path / "o" / "J_array.npy").is_file()
