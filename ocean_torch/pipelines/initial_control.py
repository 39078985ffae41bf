"""Initial-control sensitivity study (port of
``ocean_jax/pipelines/initial_control.py``).

Runs the square-mesh OCP experiment from four initial controls:

  case 0: Taylor–Green-like        (−cos πx sin πy, sin πx cos πy)
  case 1: zero
  case 2: component-swapped TG     (sin πx cos πy, −cos πx sin πy)
  case 3: constant (0.1, 0.1)

with the line search off by default. ``run_all_cases`` runs the cases
one after another with their artifacts; ``run_all_cases_fused`` runs the
four as one ensemble (``opt.ensemble``) with member-wise exits.

At the end ``run`` writes the ‖u − ū‖_{L²/H¹} table against the stored
reference flow (a dolfin HDF5 file under ``reference_runs_dir``) to
``norm_table.txt``, as the JAX package does; it skips the comparison
where the file is absent or holds another resolution.

    python -m ocean_torch.pipelines.initial_control --device cpu --case 2
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .. import system as sys_mod
from ..config import OCPConfig
from ..io import artifacts
from ..opt.driver import run_gradient_descent
from ..opt.ensemble import run_ensemble, stack_controls
from . import ocp as ocp_pipeline


def run(cfg: OCPConfig, case: int = 0, write_artifacts: bool = True,
        verbose: bool = True, device="cuda"):
    """One case through the driver on ``device``: (GDRunResult, problem,
    norm table or None)."""
    cfg = dataclasses.replace(cfg, L_shape=False)
    prob = sys_mod.build_problem(cfg, device=device)
    mesh = ocp_pipeline._mesh(cfg)
    run_dir = (artifacts.RunDirectory(cfg.out_dir)
               if write_artifacts else None)
    f = sys_mod.initial_control(prob, case=case)
    result = run_gradient_descent(
        cfg, prob, f,
        grad_check_dir=(cfg.out_dir if write_artifacts else None),
        reuse_ls_forward=cfg.reuse_ls_forward, verbose=verbose)
    norm_table = ocp_pipeline.ubar_norm_table(cfg, prob, mesh, result,
                                              run_dir, verbose)
    if write_artifacts:
        ocp_pipeline._write_final_artifacts(
            cfg, prob, mesh, result, run_dir,
            ocp_pipeline._figures(write_artifacts))
    return result, prob, norm_table


def run_all_cases(cfg: OCPConfig, verbose: bool = False, device="cuda"):
    """All four cases, each with its artifacts under ``case_<c>/``."""
    out = {}
    for case in range(4):
        case_cfg = dataclasses.replace(
            cfg, out_dir=os.path.join(cfg.out_dir, f"case_{case}") + "/")
        out[case] = run(case_cfg, case=case, verbose=verbose, device=device)
    return out


def run_all_cases_fused(cfg: OCPConfig, device="cuda"):
    """All four cases as one ensemble, a member leaving on escape past
    K/2 buoys: (EnsembleResult, problem); the histories have the
    iteration axis first and the case axis second."""
    cfg = dataclasses.replace(cfg, L_shape=False)
    prob = sys_mod.build_problem(cfg, device=device)
    f0 = stack_controls([sys_mod.initial_control(prob, case=c)
                         for c in range(4)])
    lr0 = torch.full((4,), cfg.LR, dtype=torch.float64)
    return run_ensemble(
        prob, f0, lr0, num_steps=cfg.num_steps,
        use_line_search=cfg.use_line_search, tau=cfg.tau,
        c_armijo=cfg.c_armijo, lr_min=cfg.LR_MIN,
        max_ls_iters=cfg.max_line_search_iters,
        conv_crit=cfg.conv_crit, escape_threshold=prob.K / 2), prob


def main(argv=None):
    from ..cli import build_parser, config_from_args
    defaults = OCPConfig(ud_experiment="6_buoys", use_line_search=False)
    p = build_parser("ocean_torch.pipelines.initial_control", defaults)
    p.add_argument("--case", type=int, default=0, choices=range(4))
    args = p.parse_args(argv)
    return run(config_from_args(args, defaults), case=args.case,
               device=args.device)


if __name__ == "__main__":
    main()
