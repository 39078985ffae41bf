"""Flagship OCP pipeline (port of ``ocean_jax/pipelines/ocp.py``).

Full reduced-gradient optimal control on the [0,2]² square or the L-shape
domain with Armijo line search, gradient checking, per-iteration
checkpoints, the text, array and ParaView artifacts and the figure set
(``io/plots.py``). Entry point:

    from ocean_torch.pipelines import ocp
    result, prob = ocp.run(OCPConfig(...))

or ``python -m ocean_torch.pipelines.ocp`` (``--device cpu`` without a
card). Where matplotlib is not installed the run prints
``plots.SKIP_LINE`` once and writes every other artifact (the JAX package
fails at import there).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import system as sys_mod
from ..config import OCPConfig
from ..fem import assemble
from ..io import artifacts, checkpoint, plots, xdmf
from ..mesh import rectangle_mesh, l_shape_mesh
from ..opt.driver import run_gradient_descent


def run(cfg: OCPConfig, initial_case: int = 0,
        write_artifacts: bool = True, verbose: bool = True,
        plot_all_buoys: bool = False, device="cuda"):
    """Run the full OCP experiment on ``device``; returns the GDRunResult
    plus the problem. ``plot_all_buoys`` draws the per-buoy velocity
    comparison of every buoy (the default caps it at 12 past 100)."""
    prob = sys_mod.build_problem(cfg, device=device)
    mesh = _mesh(cfg)
    run_dir = artifacts.RunDirectory(cfg.out_dir) if write_artifacts else None
    figures = _figures(write_artifacts)

    f = sys_mod.initial_control(prob, case=initial_case)
    if cfg.load_q and cfg.load_string.endswith(".h5"):
        f = checkpoint.load_dolfin_control(cfg.load_string, mesh,
                                           prob.space, prob.bq)
    elif cfg.load_q and cfg.load_string:
        f, _, _ = checkpoint.load_control(cfg.load_string, prob.space,
                                          prob.bq)
    if cfg.checkpoints and run_dir is not None:
        ck = run_dir.path("checkpoints", "q.npz")
        if os.path.exists(ck):
            f, _, _ = checkpoint.load_control(ck, prob.space, prob.bq)

    result = run_gradient_descent(
        cfg, prob, f,
        grad_check_dir=(cfg.out_dir if write_artifacts else None),
        reuse_ls_forward=cfg.reuse_ls_forward, staged=cfg.staged_driver,
        on_iteration=_iteration_writer(run_dir, prob, mesh, figures),
        verbose=verbose)

    if write_artifacts:
        _write_final_artifacts(cfg, prob, mesh, result, run_dir, figures,
                               plot_all_buoys=plot_all_buoys)
    return result, prob


def _mesh(cfg: OCPConfig):
    if cfg.L_shape:
        return l_shape_mesh(cfg.L_shape_resolution, cfg.mesh_diagonal)
    n = cfg.unit_square_resolution
    return rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n, cfg.mesh_diagonal)


def _figures(write_artifacts: bool) -> bool:
    """Whether this run draws its figures: it writes artifacts and
    matplotlib is there; where it is not, say so once."""
    if not write_artifacts:
        return False
    if not plots.available():
        print(plots.SKIP_LINE, flush=True)
        return False
    return True


def _vertex_velocity(prob, mesh, w: torch.Tensor) -> np.ndarray:
    u, _ = prob.space.split(w)
    return u[: mesh.num_vertices].cpu().numpy()


def _iteration_writer(run_dir, prob, mesh, figures: bool):
    """The driver's per-iteration hook: the flow-field figure
    ``flow_fields/u_{i}_field.png``, the control checkpoint
    ``checkpoints/q.npz`` and its time series ``q_history.npz``."""
    def on_iteration(i, f_i, fwd, z, j_array):
        if run_dir is None:
            return
        if figures:
            plots.plot_velocity_field(
                mesh, _vertex_velocity(prob, mesh, fwd.w),
                run_dir.path("flow_fields", f"u_{i}_field.png"),
                title=f"u_{i}_field")
        checkpoint.save_control(run_dir.path("checkpoints", "q.npz"),
                                f_i, iteration=i)
        checkpoint.append_control_history(
            run_dir.path("checkpoints", "q_history.npz"), f_i, iteration=i)
    return on_iteration


def ubar_norm_table(cfg: OCPConfig, prob, mesh, result, run_dir,
                    verbose: bool):
    """‖u − ū‖ in L² and H¹ against the stored reference flow
    ``u_bar_chapter_6.3.3/paraview/checkpoint/u.h5`` under
    ``reference_runs_dir``, written to ``norm_table.txt``: (l2, h1), or
    None where the file is absent or holds another resolution (then the
    comparison is skipped with the JAX package's message)."""
    path = os.path.join(cfg.reference_runs_dir, "u_bar_chapter_6.3.3",
                        "paraview", "checkpoint", "u.h5")
    if not os.path.exists(path) or result.last_fwd is None:
        return None
    from ..io.dolfin_h5 import read_checkpoint_velocity
    try:
        ubar = read_checkpoint_velocity(path, mesh, prob.space, "u")
    except ValueError as e:
        # the stored ū lives on the Nx=32 square mesh
        if verbose:
            print(f"skipping u_bar comparison: {e}")
        return None
    u, _ = prob.space.split(result.last_fwd.w)
    l2, h1 = assemble.velocity_diff_norms(
        prob.space, u, torch.as_tensor(ubar, dtype=torch.float64,
                                       device=prob.device))
    table = (float(l2), float(h1))
    if run_dir is not None:
        artifacts.write_norm_table(run_dir.path("norm_table.txt"), *table)
    return table


def _write_final_artifacts(cfg, prob, mesh, result, run_dir, figures,
                           plot_all_buoys=False):
    """The post-loop artifact block: timings, the final control, the
    divergence, ``variables.txt``, J, the figures and the field
    checkpoints."""
    if figures:
        plots.plot_mesh(mesh, run_dir.path("mesh.png"), l_shape=cfg.L_shape)
    artifacts.write_timings(run_dir.path("timings.txt"),
                            result.outer_times, result.inner_times,
                            result.inner_iterations)
    checkpoint.save_control(run_dir.path("q_backup", "q.npz"), result.f,
                            lr=result.lr, iteration=result.iterations_run)
    artifacts.write_divergence(run_dir.path("u_divergence.txt"),
                               result.divs_u)
    ud_type = "L-shape" if cfg.L_shape else "custom_ud"
    nx = (cfg.L_shape_resolution if cfg.L_shape
          else cfg.unit_square_resolution)
    artifacts.write_variables(
        run_dir.path("variables.txt"), nx, ud_type, cfg.t0, cfg.T, cfg.dt,
        cfg.viscosity, prob.K, result.lr, cfg.LR_MAX, cfg.LR_MIN,
        cfg.conv_crit, cfg.num_steps)
    artifacts.save_j_array(run_dir.path("J_array.npy"), result.j_array)

    # the reference draws every buoy's velocity comparison; past 100
    # buoys only the first 12 are drawn, and variables.txt says so
    n_plot = prob.K if (plot_all_buoys or prob.K <= 100) else 12
    if n_plot < prob.K:
        with open(run_dir.path("variables.txt"), "a") as fh:
            fh.write(f"per-buoy velocity plots capped at {n_plot} of "
                     f"{prob.K} buoys (plot_all_buoys=False)\n")
    w = result.last_fwd.w.cpu().numpy()
    if figures:
        plots.plot_cost(result.j_array, run_dir.path("J.png"))
        x_d = _desired_trajectories(cfg)
        seeds = prob.x0.cpu().numpy()
        for k, x_k in enumerate(result.x_array):
            plots.plot_buoy_movement(
                x_k, x_d, seeds,
                run_dir.path("buoy_movements", "frames",
                             f"buoy_movement_{k}.png"),
                l_shape=cfg.L_shape)
        time_interval = np.linspace(cfg.t0, cfg.T, prob.nt)
        u_d = prob.u_d.cpu().numpy()
        for k in range(n_plot):
            plots.plot_velocity_comparison(
                time_interval, u_d, result.last_u_values, k,
                run_dir.path(f"ud_plot_buoy_{k}.png"))
        plots.plot_velocity_field(
            mesh, _vertex_velocity(prob, mesh, result.last_fwd.w),
            run_dir.path("u_field.png"))

    checkpoint.save_fields(run_dir.path("paraview", "velocity.npz"), w,
                           prob.space)
    checkpoint.save_fields(run_dir.path("paraview", "checkpoint", "up.npz"),
                           w, prob.space)
    xdmf.write_velocity_pressure(
        run_dir.path("paraview", "velocity.xdmf"),
        run_dir.path("paraview", "pressure.xdmf"),
        mesh, w, prob.space.n_p2)


def _desired_trajectories(cfg) -> Optional[np.ndarray]:
    """x_d overlays of the buoy-movement frames: the stored trajectories
    of a square experiment where ``reference_runs_dir`` holds them; on the
    L-shape the analytic desired segments (buoy 1 horizontal, 2 diagonal,
    3 vertical, each of length 1/π = ∫₀¹ u_d dt)."""
    if cfg.L_shape:
        s = 1.0 / np.pi
        return np.array([[[0.5, 0.5], [0.5 + s, 0.5]],
                         [[1.0, 0.5], [1.0 + s, 0.5 + s]],
                         [[1.5, 1.0], [1.5, 1.0 + s]]])
    path = os.path.join(cfg.reference_runs_dir, cfg.ud_experiment,
                        "x_0_array.npy")
    return np.load(path) if os.path.exists(path) else None


def main(argv=None, defaults: OCPConfig = None, prog: str = None,
         runner=None):
    from ..cli import build_parser, config_from_args
    defaults = defaults or OCPConfig(use_line_search=True)
    args = build_parser(prog or "ocean_torch.pipelines.ocp",
                        defaults).parse_args(argv)
    return (runner or run)(config_from_args(args, defaults),
                           device=args.device)


if __name__ == "__main__":
    main()
