"""The coupled OCP system: problem container and the stage functions of
one gradient-descent iteration (port of the dense, reference-mode,
no-line-search branch of ``ocean_jax/system.py``).

    _solve_ns          primal Navier–Stokes chord Newton solve
    _forward           NS + primal buoy ODE
    cost               J(u_values, f)
    adjoint_rhs        ∇u projection + adjoint ODE + point sources
    _solve_adjoint_flagged   adjoint RHS + adjoint NS solve
    reduced_gradient   αf − z on Γ₁
    gd_step            one full GD iteration without line search

PyTorch runs eagerly, so host loops and Python ``if`` on ``.item()``
values replace ``lax.while_loop``/``lax.cond``. Branches the port does
not have yet (L-shape domain, multigrid, continuation, consistent
adjoint, Armijo line search, float32 chord sweeps) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import control as ctrl_mod
from .adjoint import point_source_rhs
from .config import OCPConfig
from .control import Control
from .device import resolve_device
from .fem import (assemble, make_space, make_boundary_quad,
                  dirichlet_velocity_bc)
from .fem.interpolate import boundary_eval_velocity
from .fem.spaces import TaylorHoodSpace, BoundaryQuad
from .mesh import rectangle_mesh, mark_boundary_facets
from .ode import (solve_primal_ode, solve_adjoint_ode, solve_primal_ode_cuda,
                  solve_adjoint_ode_cuda)
from .ode.grideval import GridEval, make_grideval
from .ops import linalg
from .solve import (newton_solve, solve_operator, solve_operator_reuse_t,
                    GradProjector, NewtonResult)

_EPS = 1e-12

# past this many mixed dofs the JAX package switches to its multigrid
# Krylov path, which is not ported yet
AUTO_MG_DOF_THRESHOLD = 25000


@dataclasses.dataclass(frozen=True)
class OCPProblem:
    """All device tables and constants of one OCP experiment."""

    space: TaylorHoodSpace
    bq: BoundaryQuad                 # Γ₁ quadrature (the ds(1) measure)
    bc_dofs: torch.Tensor            # homogeneous Dirichlet velocity dofs Γ₂
    bc_vals: torch.Tensor
    projector: GradProjector         # factorized P1 mass matrix
    u_d: torch.Tensor                # (K, nt, 2) measurements
    x0: torch.Tensor                 # (K, 2) buoy seeds
    center: torch.Tensor             # (2,) domain center (escape target)
    nu: float
    alpha: float                     # already rescaled by K
    h: float                         # dt
    nt: int
    refine_iters: int = 6
    newton_reuse_lu: bool = False    # chord Newton on the Stokes factor
    newton_correction_iters: int = 1
    psrc_method: str = "scatter"     # "scatter" | "fused" (CUDA kernel)
    ode_backend: str = "gather"      # "gather" | "pallas" (CUDA kernels)
    grid: Optional[GridEval] = None  # half-grid tables of the kernels
    adjoint_reuse_lu: bool = False   # adjoint through the transposed fac0
    # float64 LU factors of the Stokes (w=0) Jacobian: the first matrix
    # every Newton solve factorizes is control-independent, so it is
    # factorized once per problem
    fac0: Optional[linalg.LUSolver] = None

    @property
    def K(self) -> int:
        return self.u_d.shape[0]

    @property
    def device(self) -> torch.device:
        return self.u_d.device


class ForwardState(NamedTuple):
    w: torch.Tensor            # mixed NS solution
    x: torch.Tensor            # (K, nt, 2) trajectories
    u_values: torch.Tensor     # (K, nt, 2)
    mask: torch.Tensor         # (K,) escaped buoys
    newton: NewtonResult
    x_raw: torch.Tensor        # (K, nt, 2) pre-escape positions
    kfail: torch.Tensor        # (K,) first failing step (nt if none)


class GDStepResult(NamedTuple):
    f_new: Control
    lr: float
    J: torch.Tensor            # J(old u_values, new f)
    div_u: torch.Tensor
    fwd: ForwardState
    z: torch.Tensor
    grad: Control              # αf − z (pre-update)
    gradj: float               # 0 without line search
    inner_iterations: int
    diverged: bool             # non-finite Newton residual or cost, or a
                               # failed adjoint solve


# ---------------------------------------------------------------------------
# problem construction
# ---------------------------------------------------------------------------

def _domain_setup(cfg: OCPConfig):
    """Mesh, domain center and boundary predicates of the [0,2]² square."""
    if cfg.L_shape:
        raise NotImplementedError("ocean_torch: the L-shape domain is not "
                                  "ported yet")
    n = cfg.unit_square_resolution
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n,
                          diagonal=cfg.mesh_diagonal)
    center = np.array([1.0, 1.0])
    gamma1 = lambda x: ((np.abs(x[:, 0]) < _EPS)
                        | (np.abs(2.0 - x[:, 0]) < _EPS))
    gamma2 = lambda x: ((x[:, 0] > _EPS)
                        & (np.abs(2.0 - x[:, 0]) > _EPS))
    return mesh, center, gamma1, gamma2


def resolve_adjoint_reuse(mode: str, nu: float) -> bool:
    """The ``adjoint_reuse_lu`` knob: "auto" means on exactly when ν = 1,
    where the adjoint operator is the transposed Jacobian (the port has
    the dense path only)."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"adjoint_reuse_lu must be auto|on|off, got {mode!r}")
    return nu == 1.0


def _check_supported(cfg: OCPConfig) -> None:
    unsupported = {
        "adjoint_mode": (cfg.adjoint_mode, ("reference",)),
        "ode_backend": (cfg.ode_backend, ("gather", "pallas")),
        "psrc_method": (cfg.psrc_method, ("scatter", "fused")),
        "linear_solver": (cfg.linear_solver, ("auto", "dense")),
        "newton_continuation": (cfg.newton_continuation, (0,)),
        "newton_chord_f32": (cfg.newton_chord_f32, (False,)),
    }
    for key, (val, ok) in unsupported.items():
        if val not in ok:
            raise NotImplementedError(
                f"ocean_torch: {key}={val!r} is not ported yet "
                f"(supported: {ok})")


def _as_f64(a, device) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.array(a))
    return a.to(device=device, dtype=torch.float64).contiguous()


def build_problem(cfg: OCPConfig, u_d=None, x0=None,
                  device="cuda") -> OCPProblem:
    """Build the problem on ``device`` from a config, loading u_d/x0 from
    ``reference_runs/<ud_experiment>`` unless given."""
    dev = resolve_device(device)
    _check_supported(cfg)
    mesh, center, gamma1, gamma2 = _domain_setup(cfg)
    space = make_space(mesh, dev)
    tags = mark_boundary_facets(mesh, gamma1, tag=1)
    bq = make_boundary_quad(mesh, tags, tag=1, device=dev)
    bc_dofs, bc_vals = dirichlet_velocity_bc(mesh, space, gamma2)
    if space.ndof > AUTO_MG_DOF_THRESHOLD:
        raise NotImplementedError(
            f"ocean_torch: {space.ndof} mixed dofs needs the multigrid "
            "path, which is not ported yet")
    fac0 = linalg.factorize(assemble.ns_operator(
        space, bq, torch.zeros(space.ndof, dtype=torch.float64, device=dev),
        cfg.viscosity, bc_dofs).dense())

    nt = cfg.num_time_steps
    if u_d is None or x0 is None:
        base = os.path.join(cfg.reference_runs_dir, cfg.ud_experiment)
        u_d = np.load(os.path.join(base, "u_d_array.npy"))
        x0 = np.load(os.path.join(base, "x_0_array.npy"))[:, 0, :]
    u_d, x0 = _as_f64(u_d, dev), _as_f64(x0, dev)
    if u_d.shape[1] != nt:
        raise ValueError(
            f"u_d has {u_d.shape[1]} time samples but int(T/dt) = {nt}")
    return OCPProblem(
        space=space, bq=bq, bc_dofs=bc_dofs, bc_vals=bc_vals,
        projector=GradProjector.build(space, solver=cfg.projector_solver),
        u_d=u_d, x0=x0,
        center=torch.as_tensor(center, dtype=torch.float64, device=dev),
        nu=cfg.viscosity, alpha=cfg.alpha_scaled, h=cfg.dt, nt=nt,
        refine_iters=cfg.refine_iters,
        newton_reuse_lu=cfg.newton_reuse_lu,
        newton_correction_iters=cfg.newton_correction_iters,
        psrc_method=cfg.psrc_method,
        ode_backend=cfg.ode_backend,
        grid=(make_grideval(space)
              if cfg.ode_backend != "gather" or cfg.psrc_method == "fused"
              else None),
        adjoint_reuse_lu=resolve_adjoint_reuse(cfg.adjoint_reuse_lu,
                                               cfg.viscosity),
        fac0=fac0)


def initial_control(prob: OCPProblem, case: int = 0) -> Control:
    """The q₀ presets: case 0 the OCP default (Taylor–Green), 1 zero, 2
    the component-swapped Taylor–Green, 3 constant 0.1, 4 the limits
    pipeline's constant (0.1, 0)."""
    def tg(x):
        return np.stack([-np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]),
                         np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])],
                        axis=1)
    if case == 0:
        fn = tg
    elif case == 1:
        fn = lambda x: np.zeros((len(x), 2))
    elif case == 2:
        fn = lambda x: np.stack(
            [np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1]),
             -np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])], axis=1)
    elif case == 3:
        fn = lambda x: np.full((len(x), 2), 0.1)
    elif case == 4:
        fn = lambda x: np.stack([np.full(len(x), 0.1),
                                 np.zeros(len(x))], axis=1)
    else:
        raise ValueError(f"unknown control case {case}")
    return ctrl_mod.from_expression(prob.space, prob.bq, fn)


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def _solve_ns(prob: OCPProblem, f_quad: torch.Tensor) -> NewtonResult:
    """Primal NS Newton solve from w = 0."""
    def residual(w):
        return assemble.ns_residual(prob.space, prob.bq, w, f_quad, prob.nu)

    def operator(w):
        return assemble.ns_operator(prob.space, prob.bq, w, prob.nu,
                                    prob.bc_dofs)

    w0 = torch.zeros(prob.space.ndof, dtype=torch.float64,
                     device=prob.device)
    return newton_solve(residual, operator, w0, prob.bc_dofs, prob.bc_vals,
                        reuse_factorization=prob.newton_reuse_lu,
                        correction_iters=prob.newton_correction_iters,
                        fac0=prob.fac0)


def _primal_ode(prob: OCPProblem, u: torch.Tensor):
    """Primal buoy ODE on the configured backend: the CUDA kernel
    ("pallas", the JAX name of the fused path) or the table path."""
    if prob.ode_backend == "pallas":
        return solve_primal_ode_cuda(prob.grid, u, prob.x0, prob.h, prob.nt,
                                     prob.center)
    return solve_primal_ode(prob.space, u, prob.x0, prob.h, prob.nt,
                            prob.center)


def _forward(prob: OCPProblem, f_quad: torch.Tensor) -> ForwardState:
    """NS solve + primal buoy ODE."""
    res = _solve_ns(prob, f_quad)
    u, _ = prob.space.split(res.w)
    ode = _primal_ode(prob, u)
    return ForwardState(res.w, ode.x, ode.u_values, ode.mask, res,
                        ode.x_raw, ode.kfail)



def cost(prob: OCPProblem, u_values: torch.Tensor,
         f_quad: torch.Tensor) -> torch.Tensor:
    """J = 0.5 Σ_k Σ_t h‖u − u_d‖² + α/2 ∫_{Γ₁}|f|² ds (masked buoys
    still contribute their partial u_values, as in the reference)."""
    track = prob.h * torch.sum((u_values - prob.u_d) ** 2, dim=-1)
    part_a = 0.5 * torch.sum(track)
    part_b = 0.5 * prob.alpha * torch.sum(
        prob.bq.weights * torch.sum(f_quad ** 2, dim=-1))
    return part_a + part_b


def _adjoint_rhs_body(prob: OCPProblem, u: torch.Tensor,
                      grad_u: torch.Tensor, x: torch.Tensor,
                      u_values: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Adjoint ODE + point-source RHS (reference mode)."""
    if prob.ode_backend == "pallas":
        mu = solve_adjoint_ode_cuda(prob.grid, grad_u, x, u_values, prob.u_d,
                                    mask, prob.h)
    else:
        mu = solve_adjoint_ode(prob.space, grad_u, x, u_values, prob.u_d,
                               mask, prob.h)
    return point_source_rhs(prob.space, u, x, mu, prob.u_d, mask, prob.h,
                            prob.center, method=prob.psrc_method,
                            grid=prob.grid, u_values=u_values)


def adjoint_rhs(prob: OCPProblem, fwd: ForwardState) -> torch.Tensor:
    """∇u projection + adjoint ODE + point-source RHS: the adjoint solve's
    load vector b."""
    u, _ = prob.space.split(fwd.w)
    grad_u = prob.projector.project(prob.space, u)
    return _adjoint_rhs_body(prob, u, grad_u, fwd.x, fwd.u_values, fwd.mask)


def _solve_adjoint_flagged(prob: OCPProblem, fwd: ForwardState
                           ) -> Tuple[torch.Tensor, bool]:
    """Adjoint RHS + adjoint NS solve: (mixed adjoint state z, converged).
    The dense paths are accurate unconditionally (the reuse path falls
    back to a fresh factorization), so the flag is True."""
    b = adjoint_rhs(prob, fwd)
    op = assemble.adjoint_operator(prob.space, prob.bq, fwd.w, prob.bc_dofs)
    if prob.adjoint_reuse_lu and fwd.newton.fac is not None:
        z, _ = solve_operator_reuse_t(op, b, prob.bc_vals, fwd.newton.fac,
                                      refine_iters=prob.refine_iters)
        return z, True
    return solve_operator(op, b, prob.bc_vals,
                          refine_iters=prob.refine_iters), True


def reduced_gradient(prob: OCPProblem, f: Control,
                     z: torch.Tensor) -> Control:
    """g = αf − z restricted to Γ₁."""
    zu, _ = prob.space.split(z)
    z_quad = boundary_eval_velocity(prob.space, prob.bq, zu)
    return Control(prob.alpha * f.quad - z_quad, prob.alpha * f.p2 - zu)


def gd_step(prob: OCPProblem, f: Control, lr,
            use_line_search: bool = False) -> GDStepResult:
    """One full gradient-descent iteration without line search.

    As in the reference, J is recorded with the OLD u_values and the NEW
    control, and the learning rate is the caller's."""
    if use_line_search:
        raise NotImplementedError(
            "ocean_torch: the Armijo line search is not ported yet")
    lr = float(lr)
    fwd = _forward(prob, f.quad)
    z, adj_ok = _solve_adjoint_flagged(prob, fwd)
    g = reduced_gradient(prob, f, z)
    f_new = f.axpy(-lr, g)
    j_rec = cost(prob, fwd.u_values, f_new.quad)
    u, _ = prob.space.split(fwd.w)
    div_u = assemble.divergence_l2(prob.space, u)
    diverged = (not math.isfinite(fwd.newton.residual_norm)
                or not bool(torch.isfinite(j_rec)) or not adj_ok)
    return GDStepResult(f_new, lr, j_rec, div_u, fwd, z, g, 0.0, 0,
                        diverged)
