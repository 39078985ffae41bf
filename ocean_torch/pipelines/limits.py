"""Scalability pipeline (port of ``ocean_jax/pipelines/limits.py``).

Differences from the flagship OCP pipeline, as in the reference:
  * constant initial control f = (0.1, 0.0),
  * line search off by default,
  * square mesh only,
  * buoy-escape exit threshold is 10 buoys, not K/2,
  * final ‖u − ū‖_{L²/H¹} comparison against the stored chapter-6.3.3
    velocity checkpoint (a dolfin HDF5 file under ``reference_runs_dir``),
    written to ``norm_table.txt``; skipped where the file is absent or
    holds another resolution.

The reference ships no measurements for the 10⁴-buoy case, so they are
synthesized with ``pipelines.ud_construction`` and cached (``ensure_ud``).
The port keeps its own cache (``data/ud_torch/`` by default) and never
reads the JAX package's. As ``ocp.run``, ``run`` writes the figures where
matplotlib is installed.

    python -m ocean_torch.pipelines.limits --ud-experiment 10000_buoys --fast
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import system as sys_mod
from ..config import OCPConfig
from ..io import artifacts
from ..opt.driver import run_gradient_descent
from . import ocp as ocp_pipeline
from . import ud_construction

DEFAULT_CACHE = os.path.join("data", "ud_torch")


def ensure_ud(cfg: OCPConfig, cache_dir: str = DEFAULT_CACHE,
              device="cuda"):
    """Return (u_d, x0) numpy arrays, synthesizing and caching the
    measurements on ``device`` if neither the reference runs nor the
    cache hold them for this buoy count."""
    for base in (os.path.join(cfg.reference_runs_dir, cfg.ud_experiment),
                 os.path.join(cache_dir, cfg.ud_experiment)):
        if os.path.exists(os.path.join(base, "u_d_array.npy")):
            u_d = np.load(os.path.join(base, "u_d_array.npy"))
            x0 = np.load(os.path.join(base, "x_0_array.npy"))[:, 0, :]
            return u_d, x0
    r = ud_construction.run(nx=cfg.unit_square_resolution, K=cfg.K,
                            viscosity=cfg.viscosity, T=cfg.T, dt=cfg.dt,
                            out_dir=os.path.join(cache_dir,
                                                 cfg.ud_experiment),
                            device=device)
    return r["u_values"], r["x"][:, 0, :]


def run(cfg: OCPConfig, write_artifacts: bool = True, verbose: bool = True,
        fast_paths: bool = True, device="cuda",
        ud_cache_dir: str = DEFAULT_CACHE):
    """Run the scalability experiment on ``device``: (GDRunResult, problem,
    norm table or None).

    ``fast_paths=True`` (default) turns on the chord Newton on the Stokes
    factor (``newton_reuse_lu``), the CUDA point-source kernel
    (``psrc_method="fused"``), the CUDA ODE kernels
    (``ode_backend="pallas"``) and the explicit float32 inverse of the
    dense applies (``dense_apply="inverse"``), each only where the config
    still holds the plain default, as in the JAX package; the driver
    re-solves a diverged chord Newton with fresh factorizations."""
    cfg = dataclasses.replace(cfg, L_shape=False)
    if fast_paths:
        cfg = dataclasses.replace(
            cfg,
            newton_reuse_lu=True,
            psrc_method=("fused" if cfg.psrc_method == "scatter"
                         else cfg.psrc_method),
            ode_backend=("pallas" if cfg.ode_backend == "gather"
                         else cfg.ode_backend),
            dense_apply=("inverse" if cfg.dense_apply == "lu"
                         else cfg.dense_apply))
    u_d, x0 = ensure_ud(cfg, cache_dir=ud_cache_dir, device=device)
    prob = sys_mod.build_problem(cfg, u_d=u_d, x0=x0, device=device)
    mesh = ocp_pipeline._mesh(cfg)
    run_dir = (artifacts.RunDirectory(cfg.out_dir)
               if write_artifacts else None)
    figures = ocp_pipeline._figures(write_artifacts)

    f = sys_mod.initial_control(prob, case=4)   # constant (0.1, 0.0)
    result = run_gradient_descent(
        cfg, prob, f, escape_threshold=10,
        on_iteration=ocp_pipeline._iteration_writer(run_dir, prob, mesh,
                                                    figures),
        reuse_ls_forward=cfg.reuse_ls_forward, staged=cfg.staged_driver,
        grad_check_dir=(cfg.out_dir if write_artifacts else None),
        verbose=verbose)

    norm_table = ocp_pipeline.ubar_norm_table(cfg, prob, mesh, result,
                                              run_dir, verbose)
    if write_artifacts:
        ocp_pipeline._write_final_artifacts(cfg, prob, mesh, result, run_dir,
                                            figures)
    return result, prob, norm_table


if __name__ == "__main__":
    ocp_pipeline.main(
        defaults=OCPConfig(ud_experiment="10_buoys", use_line_search=False),
        prog="ocean_torch.pipelines.limits", runner=run)
