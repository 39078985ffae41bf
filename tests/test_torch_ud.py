"""ocean_torch parity: the measurement generator (u_d construction) and
its cache, against ocean_jax at Nx=8, K=100, nt=200.

Tolerance 1e-12 absolute on u_d and trajectories: the JAX Newton steps
through float32 factors, the port through float64 ones, and both run to
the same float64 residual test; the converged flows differ at ~1e-16 and
the trajectories integrate that difference over 200 steps.
"""

import os

import numpy as np

from ocean_jax.pipelines import ud_construction as jax_udc

from ocean_torch.config import OCPConfig
from ocean_torch.pipelines import ud_construction as udc, limits


def test_ud_generator_matches_jax(tmp_path):
    rj = jax_udc.run(nx=8, K=100, out_dir=None)
    cfg = OCPConfig(ud_experiment="100_buoys", unit_square_resolution=8,
                    reference_runs_dir=str(tmp_path / "none"))
    cache = str(tmp_path / "ud_torch")
    u_d, x0 = limits.ensure_ud(cfg, cache_dir=cache, device="cpu")
    assert u_d.shape == (100, 200, 2) and x0.shape == (100, 2)
    assert np.abs(u_d - rj["u_values"]).max() < 1e-12
    assert np.abs(x0 - rj["x"][:, 0, :]).max() == 0.0
    assert np.array_equal(x0, jax_udc.seed_positions(100))
    # the second call reads the port's own cache
    assert os.path.exists(os.path.join(cache, "100_buoys", "u_d_array.npy"))
    u_d2, x02 = limits.ensure_ud(cfg, cache_dir=cache, device="cpu")
    assert np.array_equal(u_d, u_d2) and np.array_equal(x0, x02)


def test_ud_flow_diagnostics_match_jax():
    rj = jax_udc.run(nx=6, K=6, T=0.05, out_dir=None)
    rt = udc.run(nx=6, K=6, T=0.05, out_dir=None, device="cpu")
    assert rt["converged"] and rt["newton_iters"] == rj["newton_iters"]
    for key in ("L2", "H1", "div"):
        assert abs(rt[key] - rj[key]) < 1e-12 * max(abs(rj[key]), 1.0), key
    assert np.abs(rt["x"] - rj["x"]).max() < 1e-12
    assert np.array_equal(rt["mask"], rj["mask"])
