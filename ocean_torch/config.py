"""Configuration layer (port of ``ocean_jax/config.py``).

Same keys, defaults and quirks as the JAX ``OCPConfig``:

* the buoy count ``K`` is parsed from the ``ud_experiment`` string,
* the Tikhonov weight is rescaled by buoy count (``alpha_scaled``),
* the number of ODE time steps is ``int(T / dt)``.

Every knob selects what it selects in the JAX package, the float32
dense applies (``dense_apply="inverse"``, ``newton_chord_f32``) and the
viscosity continuation (``newton_continuation``) included.
"""

from __future__ import annotations

import dataclasses
import json
import re


def load_parameters(path: str = "parameters.json") -> dict:
    """Load the physics and discretization constants (viscosity, t0, T,
    dt, alpha) from a parameters.json file."""
    with open(path, "r") as fh:
        return json.load(fh)


@dataclasses.dataclass
class OCPConfig:
    """All knobs of the reference pipelines, field for field as
    ``ocean_jax.config.OCPConfig``."""

    # --- physics / discretization (parameters.json) ---
    viscosity: float = 1.0
    t0: float = 0.0
    T: float = 1.0
    dt: float = 0.005
    alpha: float = 1e-6          # rescaled by K via alpha_scaled

    # --- experiment setup ---
    experiment: int = 1
    ud_experiment: str = "2_buoys"
    num_steps: int = 50
    out_dir: str = "results/ocean_jax/OCP/experiments/1/"
    L_shape: bool = False
    L_shape_resolution: int = 50
    unit_square_resolution: int = 32
    grad_check: bool = False
    use_line_search: bool = True
    tau: float = 0.5
    c_armijo: float = 1e-4
    LR_MIN: float = 1e-6
    LR_MAX: float = 5.0
    LR: float = 5.0
    conv_crit: float = 1e-3
    load_q: bool = False
    load_string: str = ""
    checkpoints: bool = False

    # --- framework knobs ---
    # where the reference project's runs (u_d_array.npy, x_0_array.npy per
    # experiment) are looked for; a deployment path, relative by default
    reference_runs_dir: str = "reference/reference_runs"
    mesh_diagonal: str = "right"
    newton_rtol: float = 1e-9
    newton_atol: float = 1e-10
    newton_max_iter: int = 50
    max_line_search_iters: int = 80
    refine_iters: int = 6
    newton_reuse_lu: bool = False
    newton_correction_iters: int = 1
    newton_chord_f32: bool = False
    dense_apply: str = "lu"
    linear_solver: str = "auto"
    mg_matvec: str = "stencil"
    newton_continuation: int = 0
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarse_krylov: int = 0
    mg_leaf_budget: int = 0
    adjoint_mode: str = "reference"
    projector_solver: str = "auto"
    psrc_method: str = "scatter"
    ode_backend: str = "gather"
    adjoint_reuse_lu: str = "auto"
    reuse_ls_forward: bool = True
    staged_driver: bool = True
    seed: int = 0

    @property
    def K(self) -> int:
        """Buoy count parsed from the ud_experiment string."""
        match = re.search(r"\d+", self.ud_experiment)
        if match is None:
            raise ValueError(f"no buoy count in {self.ud_experiment!r}")
        return int(match.group())

    @property
    def alpha_scaled(self) -> float:
        """alpha * K."""
        return self.alpha * self.K

    @property
    def num_time_steps(self) -> int:
        """int(T / dt) — 200 for the shipped parameters."""
        return int(self.T / self.dt)

    def with_parameters(self, params: dict) -> "OCPConfig":
        """Return a copy updated from a parameters.json dict."""
        return dataclasses.replace(
            self,
            viscosity=params.get("viscosity", self.viscosity),
            t0=params.get("t0", self.t0),
            T=params.get("T", self.T),
            dt=params.get("dt", self.dt),
            alpha=params.get("alpha", self.alpha),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
