"""Ground-truth measurement-data generator (port of
``ocean_jax/pipelines/ud_construction.py``).

Solve stationary NS on the [0,2]² square driven by Dirichlet conditions —
the inflow profile on x=0/x=2, no-slip on y=0/y=2, pressure pinned to 0
on the left edge — then advect K buoy seeds through the flow and record
their velocity time series as the synthetic measurements
``u_d_array.npy`` / ``x_0_array.npy``. As in the reference, the Γ₁
boundary is never marked, so the flow is purely Dirichlet-driven.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..fem import (make_space, dirichlet_velocity_bc, dirichlet_pressure_bc,
                   combine_bcs, assemble)
from ..mesh import rectangle_mesh
from ..ode import solve_primal_ode
from ..solve import newton_solve

_EPS = 1e-12


def seed_positions(K: int) -> np.ndarray:
    base6 = np.array([[0.25, 1.25], [1.75, 0.5], [0.5, 1.6],
                      [1.5, 0.3], [0.75, 1.0], [1.0, 1.5]])
    if K in (2, 4, 6):
        return base6[:K]
    if K == 10:
        return np.stack([np.full(10, 0.1),
                         np.linspace(0.25, 1.75, 10)], axis=1)
    grids = {100: 10, 400: 20, 10000: 100}
    if K in grids:
        n = grids[K]
        xg, yg = np.meshgrid(np.linspace(0.1, 0.25 if K == 100 else 0.4, n),
                             np.linspace(0.25, 1.75, n))
        return np.stack([xg.ravel(), yg.ravel()], axis=1)
    raise ValueError(f"no seed layout for K={K}")


def taylor_green(x: np.ndarray) -> np.ndarray:
    """inflow = (-cos(πx)sin(πy), sin(πx)cos(πy))."""
    return np.stack([-np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]),
                     np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])],
                    axis=1)


def constant_inflow(x: np.ndarray) -> np.ndarray:
    """inflow = (0.1, 0.0): the profile of the 10/100/400/10000-buoy
    datasets."""
    return np.stack([np.full(len(x), 0.1), np.zeros(len(x))], axis=1)


def inflow_for(K: int):
    return taylor_green if K in (2, 4, 6) else constant_inflow


def build(nx: int = 32, viscosity: float = 1.0, diagonal: str = "right",
          inflow=taylor_green, device="cuda"):
    """Mesh, space, the combined Dirichlet conditions and ν on
    ``device``."""
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 2.0), nx, nx, diagonal=diagonal)
    space = make_space(mesh, resolve_device(device))
    # BCs in dolfin list order (later applications overwrite earlier)
    bc_noslip = dirichlet_velocity_bc(
        mesh, space,
        lambda x: (np.abs(x[:, 1]) < _EPS) | (np.abs(x[:, 1] - 2.0) < _EPS))
    bc_inflow = dirichlet_velocity_bc(
        mesh, space,
        lambda x: (np.abs(x[:, 0]) < _EPS) | (np.abs(x[:, 0] - 2.0) < _EPS),
        value=inflow)
    bc_p = dirichlet_pressure_bc(mesh, space, lambda x: x[:, 0] < _EPS, 0.0)
    bc_dofs, bc_vals = combine_bcs(bc_noslip, bc_inflow, bc_p)
    return mesh, space, (bc_dofs, bc_vals), viscosity


def solve_flow(space, bcs, viscosity: float):
    """Newton solve of the Dirichlet-driven NS flow, one factorization per
    step."""
    bc_dofs, bc_vals = bcs
    w0 = torch.zeros(space.ndof, dtype=torch.float64, device=space.device)
    return newton_solve(
        lambda w: assemble.ns_residual(space, None, w, None, viscosity),
        lambda w: assemble.ns_operator(space, None, w, viscosity, bc_dofs),
        w0, bc_dofs, bc_vals)


def run(nx: int = 32, K: int = 6, viscosity: float = 1.0,
        T: float = 1.0, dt: float = 0.005, out_dir: Optional[str] = None,
        diagonal: str = "right", inflow=None, device="cuda") -> dict:
    """Full pipeline on ``device``; returns numpy arrays x, u_values, mask
    and the flow diagnostics, and writes ``u_d_array.npy`` /
    ``x_0_array.npy`` under ``out_dir`` when given."""
    dev = resolve_device(device)
    if inflow is None:
        inflow = inflow_for(K)
    mesh, space, bcs, nu = build(nx, viscosity, diagonal, inflow, dev)
    res = solve_flow(space, bcs, nu)
    u, _ = space.split(res.w)
    nt = int(T / dt)
    seeds = torch.as_tensor(seed_positions(K), dtype=torch.float64,
                            device=dev)
    center = torch.tensor([1.0, 1.0], dtype=torch.float64, device=dev)
    ode = solve_primal_ode(space, u, seeds, dt, nt, center)
    l2, h1 = assemble.velocity_norms(space, u)
    div = assemble.divergence_l2(space, u)
    result = {
        "w": res.w, "x": ode.x.cpu().numpy(),
        "u_values": ode.u_values.cpu().numpy(),
        "mask": ode.mask.cpu().numpy(),
        "L2": float(l2), "H1": float(h1), "div": float(div),
        "newton_iters": int(res.iterations),
        "converged": bool(res.converged),
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "u_d_array.npy"), result["u_values"])
        np.save(os.path.join(out_dir, "x_0_array.npy"), result["x"])
    return result
