"""Scalability pipeline data (port of ``ensure_ud`` from
``ocean_jax/pipelines/limits.py``).

The reference ships no measurements for the 10⁴-buoy case, so they are
synthesized with ``pipelines.ud_construction`` and cached. The port keeps
its own cache (``data/ud_torch/`` by default) and never reads the JAX
package's.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import OCPConfig
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
