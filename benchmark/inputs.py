"""The inputs of a run, made from ``--seed`` by the benchmark's own code.

Seed 0 is the published layout of the configuration. Any other seed moves
each buoy's start by an independent uniform offset of at most
``traffic["start_jitter"]`` of the spacing between neighbouring starts on
each axis (a mesh cell's side for a list of starts), so every seed has
the same number of buoys, the same measurements' recipe and the same
sizes. The measurements u_d are

  * ``dirichlet_flow``: the velocities along the starts' trajectories
    through the Dirichlet-driven NS flow on [0,2]² (no slip on y = 0, 2,
    the inflow on x = 0, 2), advected for nt steps; the flow does not
    depend on the seed and is kept in ``benchmark/.cache/``; it is solved
    at ``ud.viscosity`` where the configuration gives one (a fit at a low
    ν to data from the flow at ν = 1), else at the configuration's ν;
  * ``lshape_analytic``: the L-shape's analytic series for 3 buoys,
    sampled on linspace(t0, T, nt).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .reference import fem, ode, ocp, mesh as mesh_mod

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


def base_starts(cfg: dict):
    """(starts (K, 2), spacing (2,)) of the published layout."""
    s = cfg["starts"]
    if "grid" in s:
        (x0, x1, nx), (y0, y1, ny) = s["grid"]
        xg, yg = np.meshgrid(np.linspace(x0, x1, nx), np.linspace(y0, y1, ny))
        return (np.stack([xg.ravel(), yg.ravel()], axis=1),
                np.array([(x1 - x0) / (nx - 1), (y1 - y0) / (ny - 1)]))
    h = 2.0 / cfg["resolution"]
    return np.asarray(s["points"], dtype=np.float64), np.array([h, h])


def starts(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    x0, spacing = base_starts(cfg)
    if seed == 0:
        return x0
    rng = np.random.default_rng(seed)
    off = rng.uniform(-1.0, 1.0, size=x0.shape)
    return x0 + traffic["start_jitter"] * spacing * off


def flow_viscosity(cfg: dict) -> float:
    """The ν of the measurements' flow: ``ud.viscosity`` where the
    configuration gives it, else its own ν."""
    return cfg["ud"].get("viscosity", cfg["viscosity"])


def flow_file(cfg: dict) -> str:
    """The name of the flow's file in ``CACHE``."""
    ud = cfg["ud"]
    return (f"flow_n{cfg['resolution']}_nu{flow_viscosity(cfg)}_"
            f"in{ud['inflow'][0]}_{ud['inflow'][1]}.npy")


def _flow_velocity(cfg: dict, device) -> tuple:
    """The space and P2 velocity of the Dirichlet-driven flow, solved once
    and kept as a float64 file."""
    path = os.path.join(CACHE, flow_file(cfg))
    if os.path.exists(path):
        sp = fem.make_space(mesh_mod.build("square", cfg["resolution"]),
                            device)
        w = torch.as_tensor(np.load(path), device=device)
    else:
        sp, w = ocp.dirichlet_flow(cfg["resolution"], flow_viscosity(cfg),
                                   cfg["ud"]["inflow"], device)
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.partial.npy"
        np.save(tmp, w.cpu().numpy())
        os.replace(tmp, path)
    return sp, sp.split(w)[0]


def measurements(cfg: dict, x0: np.ndarray, device) -> np.ndarray:
    nt = int(round(cfg["T"] / cfg["dt"]))
    kind = cfg["ud"]["kind"]
    if kind == "dirichlet_flow":
        sp, u = _flow_velocity(cfg, device)
        x = torch.as_tensor(x0, dtype=torch.float64, device=device)
        c = torch.tensor([1.0, 1.0], dtype=torch.float64, device=device)
        _, u_values, _ = ode.primal(sp, u, x, cfg["dt"], nt, c)
        return u_values.cpu().numpy()
    if kind == "lshape_analytic":
        t = np.linspace(cfg["t0"], cfg["T"], nt)
        s = 0.5 * (np.cos(np.pi * (t - 0.5)) - 1 - np.cos(np.pi))
        u_d = np.zeros((3, nt, 2))
        u_d[0, :, 0] = s
        u_d[1, :, 0] = s
        u_d[1, :, 1] = s
        u_d[2, :, 1] = s
        return u_d
    raise ValueError(f"unknown measurements {kind!r}")


def make(cfg: dict, traffic: dict, seed: int, device):
    """(x0 (K, 2), u_d (K, nt, 2)) as float64 NumPy arrays."""
    x0 = starts(cfg, traffic, seed)
    return x0, measurements(cfg, x0, device)
