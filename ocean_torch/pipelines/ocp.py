"""Flagship OCP pipeline (port of ``ocean_jax/pipelines/ocp.py``).

Full reduced-gradient optimal control on the [0,2]² square or the L-shape
domain with Armijo line search, gradient checking, per-iteration
checkpoints and the text, array and ParaView artifacts. Entry point:

    from ocean_torch.pipelines import ocp
    result, prob = ocp.run(OCPConfig(...))

or ``python -m ocean_torch.pipelines.ocp`` (``--device cpu`` without a
card). The figure set of the JAX package (``io/plots.py``: mesh, cost,
flow-field, buoy-movement and velocity-comparison PNGs) is not written
yet: it waits until matplotlib is there where the port runs.
"""

from __future__ import annotations

import os

from .. import system as sys_mod
from ..config import OCPConfig
from ..io import artifacts, checkpoint, xdmf
from ..mesh import rectangle_mesh, l_shape_mesh
from ..opt.driver import run_gradient_descent


def run(cfg: OCPConfig, initial_case: int = 0,
        write_artifacts: bool = True, verbose: bool = True,
        device="cuda"):
    """Run the full OCP experiment on ``device``; returns the GDRunResult
    plus the problem."""
    prob = sys_mod.build_problem(cfg, device=device)
    mesh = _mesh(cfg)
    run_dir = artifacts.RunDirectory(cfg.out_dir) if write_artifacts else None

    f = sys_mod.initial_control(prob, case=initial_case)
    if cfg.load_q and cfg.load_string:
        f, _, _ = checkpoint.load_control(cfg.load_string, prob.space,
                                          prob.bq)
    if cfg.checkpoints and run_dir is not None:
        ck = run_dir.path("checkpoints", "q.npz")
        if os.path.exists(ck):
            f, _, _ = checkpoint.load_control(ck, prob.space, prob.bq)

    result = run_gradient_descent(
        cfg, prob, f,
        grad_check_dir=(cfg.out_dir if write_artifacts else None),
        reuse_ls_forward=cfg.reuse_ls_forward,
        on_iteration=_checkpoint_writer(run_dir), verbose=verbose)

    if write_artifacts:
        _write_final_artifacts(cfg, prob, mesh, result, run_dir)
    return result, prob


def _mesh(cfg: OCPConfig):
    if cfg.L_shape:
        return l_shape_mesh(cfg.L_shape_resolution, cfg.mesh_diagonal)
    n = cfg.unit_square_resolution
    return rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n, cfg.mesh_diagonal)


def _refuse_ubar(cfg: OCPConfig) -> None:
    """The ‖u − ū‖ comparison against the stored reference flow needs the
    dolfin HDF5 reader, which is not ported yet: raise where that file is
    present (where it is absent the JAX package skips the comparison)."""
    ubar_path = os.path.join(cfg.reference_runs_dir, "u_bar_chapter_6.3.3",
                             "paraview", "checkpoint", "u.h5")
    if os.path.exists(ubar_path):
        raise NotImplementedError(
            "ocean_torch: the u_bar comparison (norm_table.txt) against "
            f"{ubar_path} is not ported yet")


def _checkpoint_writer(run_dir):
    """The driver's per-iteration hook: the control checkpoint
    ``checkpoints/q.npz`` and its time series ``q_history.npz``."""
    def on_iteration(i, f_i, fwd, z, j_array):
        if run_dir is None:
            return
        checkpoint.save_control(run_dir.path("checkpoints", "q.npz"),
                                f_i, iteration=i)
        checkpoint.append_control_history(
            run_dir.path("checkpoints", "q_history.npz"), f_i, iteration=i)
    return on_iteration


def _write_final_artifacts(cfg, prob, mesh, result, run_dir):
    """The post-loop artifact block, figures left out."""
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

    w = result.last_fwd.w.cpu().numpy()
    checkpoint.save_fields(run_dir.path("paraview", "velocity.npz"), w,
                           prob.space)
    checkpoint.save_fields(run_dir.path("paraview", "checkpoint", "up.npz"),
                           w, prob.space)
    xdmf.write_velocity_pressure(
        run_dir.path("paraview", "velocity.xdmf"),
        run_dir.path("paraview", "pressure.xdmf"),
        mesh, w, prob.space.n_p2)


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
