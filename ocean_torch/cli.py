"""Command-line entry points for the pipelines (port of
``ocean_jax/cli.py``): every knob is a flag with the JAX package's name
and default, plus ``--device``.

    python -m ocean_torch.pipelines.ocp --ud-experiment 6_buoys --num-steps 50
    python -m ocean_torch.pipelines.ocp --device cpu --l-shape \\
        --l-shape-resolution 8 --num-steps 2
    python -m ocean_torch.pipelines.limits --ud-experiment 10000_buoys --fast
    python -m ocean_torch.pipelines.limits --device cpu --linear-solver mg \\
        --ud-experiment 100_buoys --unit-square-resolution 8 --num-steps 2
    python -m ocean_torch.pipelines.ocp --ud-experiment 10_buoys \\
        --viscosity 0.01 --newton-continuation 6 --fast

``--fast`` is the JAX package's bundle: the chord Newton on the Stokes
factor, the CUDA point-source and ODE kernels, and the explicit float32
inverse of the dense applies (``dense_apply="inverse"``).
"""

from __future__ import annotations

import argparse
import dataclasses

from .config import OCPConfig


def build_parser(prog: str, defaults: OCPConfig) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="ocean_torch pipeline (see OCPConfig)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--ud-experiment", default=defaults.ud_experiment)
    p.add_argument("--num-steps", type=int, default=defaults.num_steps)
    p.add_argument("--out-dir", default=defaults.out_dir)
    p.add_argument("--l-shape", action="store_true",
                   default=defaults.L_shape)
    p.add_argument("--l-shape-resolution", type=int,
                   default=defaults.L_shape_resolution)
    p.add_argument("--unit-square-resolution", type=int,
                   default=defaults.unit_square_resolution)
    p.add_argument("--viscosity", type=float, default=defaults.viscosity)
    p.add_argument("--alpha", type=float, default=defaults.alpha)
    p.add_argument("--dt", type=float, default=defaults.dt)
    p.add_argument("--T", type=float, default=defaults.T)
    p.add_argument("--grad-check", action="store_true",
                   default=defaults.grad_check)
    p.add_argument("--no-line-search", action="store_true")
    p.add_argument("--lr", type=float, default=defaults.LR)
    p.add_argument("--lr-min", type=float, default=defaults.LR_MIN)
    p.add_argument("--lr-max", type=float, default=defaults.LR_MAX)
    p.add_argument("--conv-crit", type=float, default=defaults.conv_crit)
    p.add_argument("--load-q", default="",
                   help="warm-start control checkpoint (.npz, or a dolfin "
                        ".h5 on this mesh)")
    p.add_argument("--checkpoints", action="store_true",
                   default=defaults.checkpoints)
    p.add_argument("--fast", action="store_true",
                   help="enable the fast paths (chord Newton on the Stokes "
                        "factor, the CUDA point-source kernel, the CUDA ODE "
                        "kernels, dense_apply=inverse)")
    p.add_argument("--ode-backend", default=None,
                   choices=["gather", "grid", "pallas"],
                   help="primal/adjoint buoy-ODE backend (overrides the "
                        "--fast bundle; pallas = the CUDA kernels; grid = "
                        "their plain half-grid stencil for the primal ODE)")
    p.add_argument("--psrc-method", default=None,
                   choices=["scatter", "sorted", "binned", "ozaki",
                            "ozaki_pallas", "fused"],
                   help="point-source reduction (overrides --fast bundle)")
    p.add_argument("--dense-apply", default=None,
                   choices=["lu", "inverse"],
                   help="dense applies: lu = float64 LU factors, inverse = "
                        "explicit float32 inverse refined in float64 "
                        "(overrides the --fast bundle)")
    p.add_argument("--projector-solver", default=defaults.projector_solver,
                   choices=["auto", "dense", "cg"],
                   help="∇u-projection mass solves")
    p.add_argument("--linear-solver", default=defaults.linear_solver,
                   choices=["auto", "dense", "mg"],
                   help="saddle-point linear solver: dense = float64 LU, "
                        "mg = FGMRES + geometric multigrid (auto: mg past "
                        "25,000 mixed dofs)")
    p.add_argument("--mg-pre", type=int, default=defaults.mg_pre,
                   help="V-cycle pre-smoothing sweeps (mg path)")
    p.add_argument("--mg-post", type=int, default=defaults.mg_post)
    p.add_argument("--mg-coarse-krylov", type=int,
                   default=defaults.mg_coarse_krylov,
                   help="inner FGMRES iterations on the coarse operator at "
                        "the linearization state (mg path; 0 = off)")
    p.add_argument("--mg-leaf-budget", type=int,
                   default=defaults.mg_leaf_budget,
                   help="velocity dofs of the coarsest level's dense "
                        "inverse (mg path; 0 = 20,000)")
    p.add_argument("--newton-continuation", type=int,
                   default=defaults.newton_continuation,
                   help="viscosity-continuation rungs of the NS solve "
                        "below ν=1 (0 = Newton from w=0; 6 for ν=0.01)")
    p.add_argument("--newton-chord-f32", action="store_true",
                   default=defaults.newton_chord_f32,
                   help="run the chord Newton's correction sweeps in "
                        "float32 (with --fast)")
    return p


def config_from_args(args, defaults: OCPConfig) -> OCPConfig:
    return dataclasses.replace(
        defaults,
        ud_experiment=args.ud_experiment,
        num_steps=args.num_steps,
        out_dir=args.out_dir,
        L_shape=args.l_shape,
        L_shape_resolution=args.l_shape_resolution,
        unit_square_resolution=args.unit_square_resolution,
        viscosity=args.viscosity,
        alpha=args.alpha,
        dt=args.dt,
        T=args.T,
        grad_check=args.grad_check,
        use_line_search=(defaults.use_line_search
                         and not args.no_line_search),
        LR=args.lr,
        LR_MIN=args.lr_min,
        LR_MAX=args.lr_max,
        conv_crit=args.conv_crit,
        load_q=bool(args.load_q),
        load_string=args.load_q,
        checkpoints=args.checkpoints,
        newton_reuse_lu=args.fast,
        psrc_method=(args.psrc_method if args.psrc_method is not None
                     else ("fused" if args.fast else "scatter")),
        ode_backend=(args.ode_backend if args.ode_backend is not None
                     else ("pallas" if args.fast
                           else defaults.ode_backend)),
        dense_apply=(args.dense_apply if args.dense_apply is not None
                     else ("inverse" if args.fast
                           else defaults.dense_apply)),
        projector_solver=args.projector_solver,
        linear_solver=args.linear_solver,
        mg_pre=args.mg_pre,
        mg_post=args.mg_post,
        mg_coarse_krylov=args.mg_coarse_krylov,
        mg_leaf_budget=args.mg_leaf_budget,
        newton_continuation=args.newton_continuation,
        newton_chord_f32=args.newton_chord_f32,
    )
