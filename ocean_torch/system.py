"""The coupled OCP system: problem container and the stage functions of
the gradient-descent iteration (port of ``ocean_jax/system.py``: the
dense and the multigrid linear solvers, reference and consistent adjoint
modes, on the [0,2]² square and the L-shape, either diagonal).

    build_problem      the problem: mesh, space, the dense Stokes factor
                       (float64 LU, float32 LU or explicit float32
                       inverse) or the multigrid hierarchy
                       (build_mg_hierarchy)
    solve_ns           primal Navier–Stokes Newton solve (dense or mg),
                       behind a viscosity-continuation ladder below ν = 1
                       unless warm-started (w_start)
    forward            NS + primal buoy ODE
    cost               J(u_values, f)
    adjoint_rhs        ∇u projection + adjoint ODE + point sources (the
                       buoy-axis part: _adjoint_rhs_body)
    _solve_adjoint_flagged   adjoint RHS + adjoint NS solve
                       (adjoint_operators, solve_adjoint_system)
    reduced_gradient   αf − z on Γ₁
    gd_step            one full GD iteration, with or without the Armijo
                       backtracking line search; its hooks ode_impl,
                       adjoint_rhs_impl and matvec_of are the sharded
                       steps' (parallel/sharding.py)
    sum_mask           escaped-buoy count, padding lanes left out
    gd_multi_step      n iterations of gd_step with the LR carried along
    make_differentiable_ns_solver   f_quad → w with the implicit-function
                       VJP, for autograd through the whole forward map
    make_staged_pair   the stages of one iteration for a host loop (the
                       driver's loop; the ladder a rung at a time,
                       warm begin/probe)
    make_newton_stager, run_newton_staged   the multigrid Newton a step
                       at a time: re-freeze on a stall, stagnation break
    make_adjoint_stager, run_adjoint_staged   the multigrid adjoint a
                       refinement round at a time, with the plateau rule

PyTorch runs eagerly, so host loops and Python ``if`` on ``.item()``
values replace ``lax.while_loop``/``lax.scan``/``lax.cond``. The pipe
meshes have no problem constructor here, as in the JAX package: they
reach the mesh, ODE and point-source functions directly.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
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
from .mesh import rectangle_mesh, l_shape_mesh, mark_boundary_facets
from .ode import (solve_primal_ode, solve_adjoint_ode,
                  solve_adjoint_ode_consistent, solve_primal_ode_cuda,
                  solve_primal_ode_table_cuda,
                  solve_adjoint_ode_cuda)
from .ode.grideval import GridEval, make_grideval
from .ops import linalg
from .solve import (newton_solve, solve_operator, solve_operator_reuse_t,
                    GradProjector, NewtonResult)
from .solve import mg as mg_mod
from .solve.newton import chord_solve
from .solve.mg import MGContext
from .utils import timing

_EPS = 1e-12

# past this many mixed dofs linear_solver="auto" picks the multigrid
# Krylov path (the JAX package's rule; "dense" is honoured at any size)
AUTO_MG_DOF_THRESHOLD = 25000

# the coarsest multigrid level's velocity block gets an explicit dense
# inverse (~20k velocity dofs: 3.2 GB in float64 while it is built, 1.6 GB
# kept in float32); the levels above it are corrected recursively, so the
# resolution is not capped by any dense factorization
DENSE_INV_VEL_DOF_BUDGET = 20000


@dataclasses.dataclass(frozen=True)
class OCPProblem:
    """All device tables and constants of one OCP experiment."""

    space: TaylorHoodSpace
    bq: BoundaryQuad                 # Γ₁ quadrature (the ds(1) measure)
    bc_dofs: torch.Tensor            # homogeneous Dirichlet velocity dofs Γ₂
    bc_vals: torch.Tensor
    projector: GradProjector         # P1 mass solves (dense LU or CG)
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
    # the chord's correction sweeps in float32 (with newton_reuse_lu)
    newton_chord_f32: bool = False
    # ν-continuation rungs before the Newton solve at ν < 1 (0: none)
    newton_continuation: int = 0
    # "scatter" | "binned" | "sorted" | "ozaki" | "ozaki_pallas" (the
    # segment-sum kernel) | "fused" (the point-source kernel)
    psrc_method: str = "scatter"
    # "gather" | "grid" (the half-grid stencil) | "pallas" (CUDA kernels)
    ode_backend: str = "gather"
    grid: Optional[GridEval] = None  # half-grid tables of the kernels
    adjoint_reuse_lu: bool = False   # adjoint through the transposed fac0
    adjoint_mode: str = "reference"  # "reference" | "consistent"
    # factors of the Stokes (w=0) Jacobian: the first matrix every Newton
    # solve factorizes is control-independent, so it is factorized once
    # per problem (dense solver only). A float64 linalg.LUSolver; float32
    # factors for the float32 chord; a linalg.InvSolver with
    # dense_apply="inverse"
    fac0: Optional[object] = None
    # the multigrid Krylov path (solve/mg.py) past the dense sizes
    linear_solver: str = "dense"     # "dense" | "mg"
    mg: Optional[MGContext] = None   # the hierarchy (mg solver only)
    mg_pre: int = 2                  # V-cycle pre-smoothing sweeps
    mg_post: int = 2                 # V-cycle post-smoothing sweeps
    mg_coarse_krylov: int = 0        # inner FGMRES on the coarse operator
    # per-buoy weights (K,): the padding lanes of the sharded steps carry
    # 0 and drop out of the cost, the adjoint sources and the escape count
    # (parallel/sharding.py::pad_buoys). None: all ones
    buoy_weights: Optional[torch.Tensor] = None
    # set-up seconds by part, filled by build_problem
    setup_seconds: dict = dataclasses.field(default_factory=dict)
    # a list to append one record per NS and adjoint solve to (iterations,
    # Krylov cycles, residuals), or None
    solve_log: Optional[list] = None

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
    gradj: float               # ⟨g, −g⟩_Γ₁ with line search, else 0
    inner_iterations: int      # line-search probes (the accepting one
                               # counts), 0 without line search
    diverged: bool             # non-finite Newton residual or cost, or a
                               # failed adjoint solve


# ---------------------------------------------------------------------------
# problem construction
# ---------------------------------------------------------------------------

def _domain_setup(cfg: OCPConfig, resolution: Optional[int] = None):
    """Mesh, domain center and boundary predicates of the [0,2]² square
    or, with ``cfg.L_shape``, of the L-shape (Γ₁ = {x=0} ∪ {y=2}), at the
    config's resolution or at ``resolution`` (a multigrid level)."""
    if cfg.L_shape:
        mesh = l_shape_mesh(resolution or cfg.L_shape_resolution,
                            diagonal=cfg.mesh_diagonal)
        center = np.array([1.0, 0.5])
        gamma1 = lambda x: ((np.abs(x[:, 0]) < _EPS)
                            | (np.abs(2.0 - x[:, 1]) < _EPS))
        gamma2 = lambda x: ((x[:, 0] > _EPS)
                            & (np.abs(2.0 - x[:, 1]) > _EPS))
        return mesh, center, gamma1, gamma2
    n = resolution or cfg.unit_square_resolution
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 2.0), n, n,
                          diagonal=cfg.mesh_diagonal)
    center = np.array([1.0, 1.0])
    gamma1 = lambda x: ((np.abs(x[:, 0]) < _EPS)
                        | (np.abs(2.0 - x[:, 0]) < _EPS))
    gamma2 = lambda x: ((x[:, 0] > _EPS)
                        & (np.abs(2.0 - x[:, 0]) > _EPS))
    return mesh, center, gamma1, gamma2


def resolve_adjoint_reuse(mode: str, nu: float, linear_solver: str) -> bool:
    """The ``adjoint_reuse_lu`` knob: "auto" means on exactly when ν = 1,
    where the adjoint operator is the transposed Jacobian, on the dense
    path (the multigrid path holds no factors)."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"adjoint_reuse_lu must be auto|on|off, got {mode!r}")
    return nu == 1.0 and linear_solver == "dense"


def _check_supported(cfg: OCPConfig) -> None:
    """Refuse a knob value that names no branch of the JAX package."""
    choices = {
        "adjoint_mode": (cfg.adjoint_mode, ("reference", "consistent")),
        "ode_backend": (cfg.ode_backend, ("gather", "grid", "pallas")),
        "psrc_method": (cfg.psrc_method, ("scatter", "binned", "sorted",
                                          "ozaki", "ozaki_pallas", "fused")),
        "linear_solver": (cfg.linear_solver, ("auto", "dense", "mg")),
        "mg_matvec": (cfg.mg_matvec, ("stencil", "scatter")),
        "dense_apply": (cfg.dense_apply, ("lu", "inverse")),
    }
    for key, (val, ok) in choices.items():
        if val not in ok:
            raise ValueError(f"ocean_torch: {key}={val!r}, expected one "
                             f"of {ok}")


def _as_f64(a, device) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.array(a))
    return a.to(device=device, dtype=torch.float64).contiguous()


def _lap(seconds: dict, name: str, t0: float, device) -> float:
    """Add the seconds since ``t0`` (device work included) to
    ``seconds[name]``; returns the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    seconds[name] = seconds.get(name, 0.0) + (t - t0)
    return t


def _make_mg_level(cfg: OCPConfig, n: int, device):
    mesh, _, g1, g2 = _domain_setup(cfg, resolution=n)
    space = make_space(mesh, device)
    tags = mark_boundary_facets(mesh, g1, tag=1)
    bq = make_boundary_quad(mesh, tags, tag=1, device=device)
    bc_dofs, _ = dirichlet_velocity_bc(mesh, space, g2)
    return space, bq, bc_dofs


def _stokes_velocity_operator(space, bq, bc_dofs, nu):
    """The frozen (w = 0) NS velocity block of a level: the smoothing
    operator of the intermediate multigrid levels."""
    op0 = assemble.ns_operator(
        space, bq, torch.zeros(space.ndof, dtype=torch.float64,
                               device=space.device), nu, bc_dofs)
    return mg_mod.velocity_block(op0, 2 * space.n_p2)


def build_mg_hierarchy(cfg: OCPConfig, space_f: TaylorHoodSpace,
                       bq_f: BoundaryQuad, bc_dofs_f: torch.Tensor,
                       n_fine: int, budget: Optional[int] = None,
                       seconds: Optional[dict] = None) -> MGContext:
    """The multigrid context chain: halve the resolution until the
    coarsest velocity block fits ``budget`` velocity dofs (default
    ``DENSE_INV_VEL_DOF_BUDGET``), freeze the Stokes velocity operator of
    every intermediate level, and invert the leaf's in float64 on the
    device, rounded to float32 once. Two levels up to Nx=96, three at
    Nx=192, four at Nx=256. ``seconds``, where given, receives the set-up
    seconds by part."""
    if budget is None:
        budget = DENSE_INV_VEL_DOF_BUDGET
    seconds = {} if seconds is None else seconds
    dev = space_f.device
    t = time.perf_counter()
    levels = [(space_f, bq_f, bc_dofs_f)]
    n = n_fine
    while True:
        n = max(n // 2, 4)
        levels.append(_make_mg_level(cfg, n, dev))
        if 2 * levels[-1][0].n_p2 <= budget or n <= 4:
            break
    t = _lap(seconds, "mg_levels", t, dev)

    space_l, bq_l, bc_l = levels[-1]
    a_l = _stokes_velocity_operator(space_l, bq_l, bc_l,
                                    cfg.viscosity).dense()
    ainv = torch.linalg.inv(a_l).to(torch.float32)
    del a_l
    t = _lap(seconds, "mg_leaf_inverse", t, dev)

    sub = None
    for i in range(len(levels) - 2, -1, -1):
        (sp_f, bq_i, _), (sp_c, bq_c, bc_c) = levels[i], levels[i + 1]
        # the finest level applies its mixed operator too; below it only
        # the velocity blocks are smoothed
        ctx = mg_mod.build_mg_context(
            sp_f, sp_c, bq_c, bc_c, cfg.viscosity, bq_f=bq_i,
            use_stencil=(cfg.mg_matvec != "scatter"),
            blocks=("mixed", "vel") if i == 0 else ("vel",))
        t = _lap(seconds, "mg_transfers_and_stencil_tables", t, dev)
        if i == len(levels) - 2:
            ctx = dataclasses.replace(ctx, ainv_c=ainv)
        else:
            ctx = dataclasses.replace(
                ctx, sub=sub, op_vel_c=_stokes_velocity_operator(
                    sp_c, bq_c, bc_c, cfg.viscosity))
            t = _lap(seconds, "mg_frozen_operators", t, dev)
        sub = ctx
    return sub


def _stokes_factors(cfg: OCPConfig, space: TaylorHoodSpace,
                    bq: BoundaryQuad, bc_dofs: torch.Tensor):
    """The problem-constant factors of the Stokes (w = 0) Jacobian:
    ``dense_apply="inverse"`` its explicit float32 inverse with A⁻ᵀ
    materialized for the transposed adjoint applies (as the JAX package
    builds it); else LU factors, float32 where the float32 chord sweeps
    run on them (``newton_chord_f32`` with ``newton_reuse_lu``: the JAX
    package's factors are float32 in every mode), float64 otherwise."""
    a = assemble.ns_operator(
        space, bq, torch.zeros(space.ndof, dtype=torch.float64,
                               device=space.device),
        cfg.viscosity, bc_dofs).dense()
    if cfg.dense_apply == "inverse":
        return linalg.invert32(a).with_transpose()
    f32 = cfg.newton_chord_f32 and cfg.newton_reuse_lu
    return linalg.factorize(a, torch.float32 if f32 else torch.float64)


def build_problem(cfg: OCPConfig, u_d=None, x0=None,
                  device="cuda") -> OCPProblem:
    """Build the problem on ``device`` from a config. Unless given, u_d/x0
    are the analytic 3-buoy measurements on the L-shape (``lshape_ud``)
    and are loaded from ``reference_runs/<ud_experiment>`` on the
    square.

    ``linear_solver="auto"`` picks the multigrid path above
    ``AUTO_MG_DOF_THRESHOLD`` mixed dofs and the dense one below; a forced
    "dense" or "mg" is honoured at any size (a dense problem too large
    for the device fails with PyTorch's out-of-memory error)."""
    dev = resolve_device(device)
    _check_supported(cfg)
    seconds = {}
    t = time.perf_counter()
    mesh, center, gamma1, gamma2 = _domain_setup(cfg)
    space = make_space(mesh, dev)
    tags = mark_boundary_facets(mesh, gamma1, tag=1)
    bq = make_boundary_quad(mesh, tags, tag=1, device=dev)
    bc_dofs, bc_vals = dirichlet_velocity_bc(mesh, space, gamma2)
    t = _lap(seconds, "mesh_and_space", t, dev)
    linear_solver = cfg.linear_solver
    if linear_solver == "auto":
        linear_solver = ("mg" if space.ndof > AUTO_MG_DOF_THRESHOLD
                         else "dense")
    mg_ctx = fac0 = None
    if linear_solver == "mg":
        n_fine = (cfg.L_shape_resolution if cfg.L_shape
                  else cfg.unit_square_resolution)
        mg_ctx = build_mg_hierarchy(cfg, space, bq, bc_dofs, n_fine,
                                    budget=cfg.mg_leaf_budget or None,
                                    seconds=seconds)
        t = time.perf_counter()
    else:
        fac0 = _stokes_factors(cfg, space, bq, bc_dofs)
        t = _lap(seconds, "fac0", t, dev)
    projector = GradProjector.build(space, dense_apply=cfg.dense_apply,
                                    solver=cfg.projector_solver)
    t = _lap(seconds, "projector", t, dev)
    grid = (make_grideval(space)
            if cfg.ode_backend != "gather" or cfg.psrc_method == "fused"
            else None)
    _lap(seconds, "grid_tables", t, dev)

    nt = cfg.num_time_steps
    if (u_d is None or x0 is None) and cfg.L_shape:
        u_d, x0 = lshape_ud(cfg)
    elif u_d is None or x0 is None:
        base = os.path.join(cfg.reference_runs_dir, cfg.ud_experiment)
        u_d = np.load(os.path.join(base, "u_d_array.npy"))
        x0 = np.load(os.path.join(base, "x_0_array.npy"))[:, 0, :]
    u_d, x0 = _as_f64(u_d, dev), _as_f64(x0, dev)
    if u_d.shape[1] != nt:
        raise ValueError(
            f"u_d has {u_d.shape[1]} time samples but int(T/dt) = {nt}")
    return OCPProblem(
        space=space, bq=bq, bc_dofs=bc_dofs, bc_vals=bc_vals,
        projector=projector, u_d=u_d, x0=x0,
        center=torch.as_tensor(center, dtype=torch.float64, device=dev),
        nu=cfg.viscosity, alpha=cfg.alpha_scaled, h=cfg.dt, nt=nt,
        refine_iters=cfg.refine_iters,
        newton_reuse_lu=cfg.newton_reuse_lu,
        newton_correction_iters=cfg.newton_correction_iters,
        newton_chord_f32=cfg.newton_chord_f32,
        newton_continuation=cfg.newton_continuation,
        psrc_method=cfg.psrc_method,
        ode_backend=cfg.ode_backend,
        grid=grid,
        adjoint_reuse_lu=resolve_adjoint_reuse(
            cfg.adjoint_reuse_lu, cfg.viscosity, linear_solver),
        adjoint_mode=cfg.adjoint_mode,
        fac0=fac0, linear_solver=linear_solver, mg=mg_ctx,
        mg_pre=cfg.mg_pre, mg_post=cfg.mg_post,
        mg_coarse_krylov=cfg.mg_coarse_krylov, setup_seconds=seconds)


def lshape_ud(cfg: OCPConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic L-shape measurements for 3 buoys. Two quirks of the
    reference are kept: u_d is sampled on linspace(t0, T, nt), whose
    spacing is T/(nt−1), while the ODE steps with h = dt; and
    ``alpha_scaled`` takes its buoy count from the ``ud_experiment``
    string, whatever it says, while the problem holds these 3 buoys."""
    nt = cfg.num_time_steps
    t = np.linspace(cfg.t0, cfg.T, nt)
    ud1 = 0.5 * (np.cos(np.pi * (t - 0.5)) - 1 - np.cos(np.pi))
    u_d = np.zeros((3, nt, 2))
    u_d[0, :, 0] = ud1
    u_d[1, :, 0] = ud1
    u_d[1, :, 1] = ud1
    u_d[2, :, 1] = ud1
    x0 = np.array([[0.5, 0.5], [1.0, 0.5], [1.5, 1.0]])
    return u_d, x0


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


def fd_direction(prob: OCPProblem) -> Control:
    """df = (0.1, 0.1), the direction of the gradient check."""
    return ctrl_mod.constant(prob.space, prob.bq, [0.1, 0.1])


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def _log_solve(prob: OCPProblem, **record) -> None:
    if prob.solve_log is not None:
        prob.solve_log.append(record)


def continuation_viscosities(nu: float, n_rungs: int) -> list:
    """The ν-ladder below the solve at ν: ν_k = r^k for k = 0..n_rungs
    with r = ν^(1/(n_rungs+1)), from 1 down to ν/r. Empty when ν ≥ 1 or
    ``n_rungs`` is 0."""
    if n_rungs <= 0 or nu >= 1.0:
        return []
    ratio = (nu / 1.0) ** (1.0 / (n_rungs + 1))
    return [ratio ** k for k in range(n_rungs + 1)]


def _residual_at(prob: OCPProblem, f_quad: torch.Tensor, nu: float):
    return lambda w: assemble.ns_residual(prob.space, prob.bq, w, f_quad, nu)


def _operator_at(prob: OCPProblem, nu: float):
    return lambda w: assemble.ns_operator(prob.space, prob.bq, w, nu,
                                          prob.bc_dofs)


def _coarse_operator_at(prob: OCPProblem, nu: float):
    """The state-assembled coarse operator of the convection-aware inner
    Krylov (``solve/mg.py::make_block_preconditioner``), or None when
    ``mg_coarse_krylov`` is 0."""
    if prob.mg_coarse_krylov == 0:
        return None
    return lambda w: assemble.ns_operator(
        prob.mg.space_c, prob.mg.bq_c,
        mg_mod.inject_state(prob.mg, prob.space, w), nu, prob.mg.bc_dofs_c)


def _newton_at(prob: OCPProblem, f_quad: torch.Tensor, nu: float,
               w0: torch.Tensor, matvec_of=None) -> NewtonResult:
    """Newton from w0 at viscosity ν: full dense Newton, or on the
    multigrid path float32 FGMRES steps on the hierarchy frozen at the
    problem's ν with ``nu_scale`` = ν/prob.nu (one continuation rung)."""
    if prob.linear_solver == "mg":
        return mg_mod.newton_solve_mg(
            _residual_at(prob, f_quad, nu), _operator_at(prob, nu),
            _coarse_operator_at(prob, nu), prob.mg, prob.space, w0,
            prob.bc_dofs, prob.bc_vals, pre=prob.mg_pre, post=prob.mg_post,
            nu_scale=nu / prob.nu, coarse_krylov=prob.mg_coarse_krylov,
            matvec_of=matvec_of)
    return newton_solve(_residual_at(prob, f_quad, nu),
                        _operator_at(prob, nu), w0, prob.bc_dofs,
                        prob.bc_vals)


def solve_ns(prob: OCPProblem, f_quad: torch.Tensor,
             matvec_of=None, w_start=None) -> NewtonResult:
    """Primal NS Newton solve from w = 0: dense steps (chord on the
    Stokes factor with ``newton_reuse_lu``, its sweeps in float32 with
    ``newton_chord_f32``), or on the multigrid path float32 FGMRES steps
    preconditioned by the hierarchy frozen at w = 0
    (``solve/mg.py::newton_solve_mg``).

    With ``newton_continuation`` > 0 and ν < 1, Newton from w = 0 runs
    first at each viscosity of ``continuation_viscosities``, each rung
    warm-starting the next, and the solve at ν starts from the last
    rung's state: at the reference's ν = 0.01 Newton from w = 0 diverges.
    Dense rungs and the dense final solve are full Newton (the Stokes
    factor belongs to w = 0); multigrid rungs run on the hierarchy frozen
    at ν with ``nu_scale`` = ν_k/ν. Each rung appends an "ns_rung" record
    to ``solve_log``. Only the final solve's float64 test decides the
    accuracy of the result. ``matvec_of`` (op → matvec) replaces the
    multigrid Krylov matvec (the dof-sharded one of
    ``parallel/dof_sharding.py``); the dense path ignores it.

    ``w_start``: the Newton initial guess, a state already in the
    solution's basin (the staged runner's warm-started probes). It skips
    the ladder, which only finds the basin; below ν = 1 the dense path
    then factorizes J(w_start) each step rather than reusing the Stokes
    factor of w = 0. The "ns_newton" record says ``warm_start``.

    The chord runs on the problem's Stokes factor ``fac0`` (a
    ``ValueError`` without one) through ``solve/newton.py::chord_solve``:
    on a CUDA device each step is a replay of a CUDA graph, the numbers
    of the eager chord bit for bit. The "ns_newton" record and span give
    ``graph_steps``, the steps that ran so (0 elsewhere)."""
    with timing.span("ns_newton") as span:
        warm = w_start is not None
        w = (w_start if warm
             else torch.zeros(prob.space.ndof, dtype=torch.float64,
                              device=prob.device))
        ladder = ([] if warm
                  else continuation_viscosities(prob.nu,
                                                prob.newton_continuation))
        iterations = 0
        for nu_k in ladder:
            res = _newton_at(prob, f_quad, nu_k, w, matvec_of=matvec_of)
            iterations += res.iterations
            _log_solve(prob, solve="ns_rung", nu=nu_k,
                       iterations=res.iterations,
                       residual_norm=res.residual_norm,
                       converged=res.converged,
                       krylov_cycles=list(res.krylov_cycles))
            w = res.w

        if ladder or prob.linear_solver == "mg" or (warm and prob.nu < 1.0):
            res = _newton_at(prob, f_quad, prob.nu, w, matvec_of=matvec_of)
        elif prob.newton_reuse_lu:
            if prob.fac0 is None:
                raise ValueError("the chord Newton (newton_reuse_lu) runs "
                                 "on the problem's Stokes factor; fac0 is "
                                 "None")
            res = chord_solve(prob.space, prob.bq, f_quad, prob.nu, w,
                              prob.bc_dofs, prob.bc_vals, prob.fac0,
                              prob.newton_correction_iters,
                              float32=prob.newton_chord_f32)
        else:
            res = newton_solve(_residual_at(prob, f_quad, prob.nu),
                               _operator_at(prob, prob.nu), w,
                               prob.bc_dofs, prob.bc_vals, fac0=prob.fac0)
        _log_solve(prob, solve="ns_newton", iterations=res.iterations,
                   residual_norm=res.residual_norm, converged=res.converged,
                   krylov_cycles=list(res.krylov_cycles), warm_start=warm,
                   graph_steps=res.graph_steps)
        span.set(iterations=iterations + res.iterations,
                 graph_steps=res.graph_steps)
        return res


class _DifferentiableNS(torch.autograd.Function):
    """f_quad → w. The backward pass is the implicit function theorem:
    J(w*)ᵀ λ = w̄ with λ = 0 on the Dirichlet dofs, then f̄ = Lᵀ λ with L
    the Γ₁ load operator ∫ f·v ds."""

    @staticmethod
    def forward(ctx, f_quad, prob):
        w = solve_ns(prob, f_quad).w
        ctx.prob = prob
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, w_bar):
        prob = ctx.prob
        (w,) = ctx.saved_tensors
        op = assemble.ns_operator(prob.space, prob.bq, w, prob.nu,
                                  prob.bc_dofs)
        a_t = op.dense().T
        lam = linalg.solve_refined(linalg.factorize(a_t),
                                   lambda x: a_t @ x, w_bar, iters=8)
        lam = lam.index_fill(0, prob.bc_dofs, 0.0)
        lam_u, _ = prob.space.split(lam)
        dofs = prob.space.cell_dofs_p2[prob.bq.cells]
        f_bar = torch.einsum("fq,fqa,fai->fqi", prob.bq.weights,
                             prob.bq.phi2, lam_u[dofs])
        return f_bar, None


def make_differentiable_ns_solver(prob: OCPProblem):
    """Return f_quad → w, differentiable by ``torch.autograd`` through the
    implicit-function VJP: the exact discrete gradient of anything
    computed from w (the port's counterpart of the JAX custom VJP)."""
    return lambda f_quad: _DifferentiableNS.apply(f_quad, prob)


def _primal_ode(prob: OCPProblem, u: torch.Tensor):
    """Primal buoy ODE on the configured backend: the CUDA kernel
    ("pallas", the JAX name of the fused path), the half-grid stencil in
    plain PyTorch ("grid", the kernel's plain version) or the table path
    ("gather"), whose steps run in the table kernel where u is on the card
    (the span's ``table_kernel`` is then 1) and in plain PyTorch on the
    CPU. The adjoint of "grid" runs on the table path, as in the JAX
    package."""
    with timing.span("primal_ode", steps=prob.nt - 1, table_kernel=0) as s:
        if prob.ode_backend == "pallas":
            return solve_primal_ode_cuda(prob.grid, u, prob.x0, prob.h,
                                         prob.nt, prob.center)
        if prob.ode_backend == "gather" and u.is_cuda:
            s.set(table_kernel=1)
            return solve_primal_ode_table_cuda(prob.space, u, prob.x0,
                                               prob.h, prob.nt, prob.center)
        return solve_primal_ode(prob.space, u, prob.x0, prob.h, prob.nt,
                                prob.center,
                                grid=(prob.grid if prob.ode_backend == "grid"
                                      else None))


def forward(prob: OCPProblem, f_quad: torch.Tensor, ode_impl=None,
            matvec_of=None, w_start=None) -> ForwardState:
    """NS solve + primal buoy ODE. ``ode_impl`` replaces the ODE stage
    (the buoy-sharded ``_primal_ode`` of ``parallel/sharding.py``),
    ``matvec_of`` the multigrid Krylov matvec; ``w_start`` is a warm
    Newton start that skips the ladder (``solve_ns``)."""
    res = solve_ns(prob, f_quad, matvec_of=matvec_of, w_start=w_start)
    u, _ = prob.space.split(res.w)
    ode = (ode_impl or _primal_ode)(prob, u)
    return ForwardState(res.w, ode.x, ode.u_values, ode.mask, res,
                        ode.x_raw, ode.kfail)



@timing.span("cost")
def cost(prob: OCPProblem, u_values: torch.Tensor,
         f_quad: torch.Tensor) -> torch.Tensor:
    """J = 0.5 Σ_k Σ_t h‖u − u_d‖² + α/2 ∫_{Γ₁}|f|² ds (masked buoys
    still contribute their partial u_values, as in the reference).
    ``buoy_weights`` scale the tracking term per buoy."""
    track = prob.h * torch.sum((u_values - prob.u_d) ** 2, dim=-1)
    if prob.buoy_weights is not None:
        track = track * prob.buoy_weights[:, None]
    part_a = 0.5 * torch.sum(track)
    part_b = 0.5 * prob.alpha * torch.sum(
        prob.bq.weights * torch.sum(f_quad ** 2, dim=-1))
    return part_a + part_b


@timing.span("adjoint_ode")
def _adjoint_mu(prob: OCPProblem, grad_u: torch.Tensor, x: torch.Tensor,
                u_values: torch.Tensor, mask: torch.Tensor,
                x_raw: torch.Tensor, kfail: torch.Tensor) -> torch.Tensor:
    """The costate μ (K, nt, 2). The "pallas" backend runs the CUDA
    adjoint kernel. "consistent" mode runs the recursion on the raw
    trajectory over each escaped buoy's window t ≤ kfail−1."""
    if prob.adjoint_mode == "consistent":
        if prob.ode_backend == "pallas":
            vlimit = torch.where(mask, kfail.to(torch.int64) - 1, prob.nt)
            return solve_adjoint_ode_cuda(prob.grid, grad_u, x_raw, u_values,
                                          prob.u_d, torch.zeros_like(mask),
                                          prob.h, vlimit=vlimit)
        return solve_adjoint_ode_consistent(prob.space, grad_u, x_raw,
                                            u_values, prob.u_d, mask, kfail,
                                            prob.h)
    if prob.ode_backend == "pallas":
        return solve_adjoint_ode_cuda(prob.grid, grad_u, x, u_values,
                                      prob.u_d, mask, prob.h)
    return solve_adjoint_ode(prob.space, grad_u, x, u_values, prob.u_d, mask,
                             prob.h)


def _source_points(prob: OCPProblem, x: torch.Tensor, mask: torch.Tensor,
                   x_raw: torch.Tensor, kfail: torch.Tensor):
    """Where the point sources sit, (K, nt, 2), and which (buoy, time)
    slots carry one, (K, nt) bool. "consistent" mode keeps escaped buoys'
    pre-escape sources at the raw positions, plus the u(center) quirk
    term at kfail+1; otherwise an escaped buoy carries none."""
    if prob.adjoint_mode != "consistent":
        return x, (~mask)[:, None].expand(prob.K, prob.nt)
    t = torch.arange(prob.nt, device=x.device)[None, :]
    kf = kfail.to(torch.int64)[:, None]
    pre = t <= kf - 1
    quirk = t == kf + 1                         # u_values[kf+1] = u(center)
    m = mask[:, None]
    x = torch.where(m[..., None],
                    torch.where(pre[..., None], x_raw, prob.center), x)
    active_t = torch.where(m, pre | quirk, True)
    if prob.buoy_weights is not None:
        active_t = active_t & (prob.buoy_weights[:, None] > 0)
    return x, active_t


@timing.span("point_sources")
def _adjoint_sources(prob: OCPProblem, u: torch.Tensor, mu: torch.Tensor,
                     x: torch.Tensor, u_values: torch.Tensor,
                     mask: torch.Tensor, x_raw: torch.Tensor,
                     kfail: torch.Tensor) -> torch.Tensor:
    """The point-source RHS b from μ."""
    x, active_t = _source_points(prob, x, mask, x_raw, kfail)
    return point_source_rhs(prob.space, u, x, mu, prob.u_d, mask, prob.h,
                            prob.center, method=prob.psrc_method,
                            active_t=active_t, grid=prob.grid,
                            u_values=u_values)


def _adjoint_rhs_body(prob: OCPProblem, u: torch.Tensor,
                      grad_u: torch.Tensor, x: torch.Tensor,
                      u_values: torch.Tensor, mask: torch.Tensor,
                      x_raw: torch.Tensor, kfail: torch.Tensor
                      ) -> torch.Tensor:
    """Adjoint ODE + point-source RHS over explicit buoy-axis arrays: the
    stage the buoy-sharded step runs on each rank's lanes. Lanes of
    weight 0 (``buoy_weights``) are dropped like escaped buoys in
    "reference" mode and carry no source in "consistent" mode."""
    if prob.buoy_weights is not None and prob.adjoint_mode != "consistent":
        mask = mask | (prob.buoy_weights == 0)
    state = (x, u_values, mask, x_raw, kfail)
    mu = _adjoint_mu(prob, grad_u, *state)
    return _adjoint_sources(prob, u, mu, *state)


@timing.span("adjoint_rhs")
def adjoint_rhs(prob: OCPProblem, fwd: ForwardState,
                adjoint_rhs_impl=None) -> torch.Tensor:
    """∇u projection + adjoint ODE + point-source RHS: the adjoint solve's
    load vector b. ``adjoint_rhs_impl`` replaces the buoy-axis stage
    ``_adjoint_rhs_body`` (the buoy-sharded one of
    ``parallel/sharding.py``)."""
    u, _ = prob.space.split(fwd.w)
    grad_u = prob.projector.project(prob.space, u)
    return (adjoint_rhs_impl or _adjoint_rhs_body)(
        prob, u, grad_u, fwd.x, fwd.u_values, fwd.mask, fwd.x_raw,
        fwd.kfail)


@timing.span("adjoint_assemble")
def adjoint_operators(prob: OCPProblem, w: torch.Tensor):
    """(fine adjoint operator, coarse adjoint operator or None). The
    coarse one, at the injected state, feeds the inner Krylov of the
    coarse correction when ``mg_coarse_krylov`` > 0."""
    op = assemble.adjoint_operator(prob.space, prob.bq, w, prob.bc_dofs)
    op_c = None
    if prob.linear_solver == "mg" and prob.mg_coarse_krylov > 0:
        op_c = assemble.adjoint_operator(
            prob.mg.space_c, prob.mg.bq_c,
            mg_mod.inject_state(prob.mg, prob.space, w), prob.mg.bc_dofs_c)
    return op, op_c


@timing.span("adjoint_solve")
def solve_adjoint_system(prob: OCPProblem, fwd: ForwardState,
                         b: torch.Tensor, op, op_c=None, matvec_of=None
                         ) -> Tuple[torch.Tensor, bool]:
    """The adjoint NS solve op z = b on the problem's linear solver:
    (z, converged). The dense paths are accurate unconditionally (the
    reuse path falls back to a fresh factorization), so there the flag is
    True; on the multigrid path it says whether the float64 refinement
    rounds reached 1e-11·‖b‖. ``matvec_of`` replaces the multigrid
    path's float64 refinement matvec (``solve_operator_mg``)."""
    if prob.linear_solver == "mg":
        # the adjoint Laplacian has unit viscosity (the reference's form)
        # while the frozen hierarchy is assembled at ν: the rung scaling
        # nu_scale = 1/ν applies
        sol = mg_mod.solve_operator_mg(
            op, op_c, prob.mg, prob.space, b, prob.bc_vals,
            pre=prob.mg_pre, post=prob.mg_post,
            coarse_krylov=prob.mg_coarse_krylov, nu_scale=1.0 / prob.nu,
            matvec_of=matvec_of)
        timing.count(rounds=sol.rounds)
        _log_solve(prob, solve="adjoint", rounds=sol.rounds,
                   krylov_cycles=sol.iterations,
                   relative_residual=sol.residual_norm / max(sol.b_norm,
                                                             1e-300),
                   converged=sol.converged)
        return sol.x, sol.converged
    if prob.adjoint_reuse_lu and fwd.newton.fac is not None:
        z, swept = solve_operator_reuse_t(op, b, prob.bc_vals,
                                          fwd.newton.fac,
                                          refine_iters=prob.refine_iters)
        _log_solve(prob, solve="adjoint", converged=True,
                   transposed_factor_sweeps_converged=swept)
        return z, True
    _log_solve(prob, solve="adjoint", converged=True)
    return solve_operator(op, b, prob.bc_vals,
                          refine_iters=prob.refine_iters), True


@timing.span("adjoint")
def _solve_adjoint_flagged(prob: OCPProblem, fwd: ForwardState,
                           adjoint_rhs_impl=None, matvec_of=None
                           ) -> Tuple[torch.Tensor, bool]:
    """Adjoint RHS + adjoint NS solve: (mixed adjoint state z, converged)
    (``adjoint_rhs``, ``solve_adjoint_system``)."""
    b = adjoint_rhs(prob, fwd, adjoint_rhs_impl=adjoint_rhs_impl)
    op, op_c = adjoint_operators(prob, fwd.w)
    return solve_adjoint_system(prob, fwd, b, op, op_c, matvec_of=matvec_of)


def sum_mask(prob: OCPProblem, mask: torch.Tensor) -> torch.Tensor:
    """Escaped-buoy count; lanes of weight 0 never count."""
    if prob.buoy_weights is None:
        return torch.sum(mask)
    return torch.sum(mask * prob.buoy_weights)


@timing.span("gradient")
def reduced_gradient(prob: OCPProblem, f: Control,
                     z: torch.Tensor) -> Control:
    """g = αf − z restricted to Γ₁."""
    zu, _ = prob.space.split(z)
    z_quad = boundary_eval_velocity(prob.space, prob.bq, zu)
    return Control(prob.alpha * f.quad - z_quad, prob.alpha * f.p2 - zu)


def line_search(prob: OCPProblem, f: Control, g: Control, fwd: ForwardState,
                lr: float, tau: float = 0.5, c_armijo: float = 1e-4,
                lr_min: float = 1e-6, max_ls_iters: int = 80, ode_impl=None,
                matvec_of=None):
    """Armijo backtracking along df = −g from ``lr``, a host loop over
    forward solves. Returns (lr, probes, gradj).

    A probe at lr accepts when J(f) − J(f + lr·df) ≥ lr·(−c·gradj) with
    gradj = ⟨g, df⟩_Γ₁; else lr ← max(τ·lr, lr_min). The search stops
    after the one failed probe at the floor (a further probe would be the
    identical computation) and after ``max_ls_iters`` decrements.
    ``probes`` counts the accepting (or last) probe too. A probe's
    forward runs with ``ode_impl`` and ``matvec_of`` (``forward``)."""
    df = Control(-g.quad, -g.p2)
    gradj = timing.to_host(ctrl_mod.boundary_inner(prob.bq, g, df))
    cond_thresh = -c_armijo * gradj
    j_old = timing.to_host(cost(prob, fwd.u_values, f.quad))
    it = 0
    while True:
        with timing.span("probe"):
            f_ls = f.quad + lr * df.quad
            fwd_ls = forward(prob, f_ls, ode_impl=ode_impl,
                             matvec_of=matvec_of)
            j_new = timing.to_host(cost(prob, fwd_ls.u_values, f_ls))
        accept = j_old - j_new >= lr * cond_thresh
        if accept or not (it < max_ls_iters and lr > lr_min):
            return lr, it + 1, gradj
        lr = max(tau * lr, lr_min)
        it += 1


def gd_step(prob: OCPProblem, f: Control, lr,
            use_line_search: bool = False, tau: float = 0.5,
            c_armijo: float = 1e-4, lr_min: float = 1e-6,
            max_ls_iters: int = 80, ode_impl=None, adjoint_rhs_impl=None,
            matvec_of=None) -> GDStepResult:
    """One full gradient-descent iteration, with the Armijo backtracking
    line search (``line_search``) when ``use_line_search``.

    As in the reference, the learning rate is the caller's and is not
    reset (pass the returned one back in), the accepted line-search state
    is discarded, and J is recorded with the OLD u_values and the NEW
    control.

    The three hooks are the sharded steps' (``parallel/sharding.py``):
    ``ode_impl`` runs the primal ODE on each rank's buoys,
    ``adjoint_rhs_impl`` the adjoint ODE and point sources, and
    ``matvec_of`` shards the multigrid matvec over cells; one line
    search and update serve every layout. Unset, the step is the
    single-device one."""
    lr = float(lr)
    fwd = forward(prob, f.quad, ode_impl=ode_impl, matvec_of=matvec_of)
    z, adj_ok = _solve_adjoint_flagged(prob, fwd,
                                       adjoint_rhs_impl=adjoint_rhs_impl,
                                       matvec_of=matvec_of)
    g = reduced_gradient(prob, f, z)
    gradj, inner = 0.0, 0
    if use_line_search:
        lr, inner, gradj = line_search(prob, f, g, fwd, lr, tau, c_armijo,
                                       lr_min, max_ls_iters,
                                       ode_impl=ode_impl,
                                       matvec_of=matvec_of)
    f_new = f.axpy(-lr, g)
    j_rec = cost(prob, fwd.u_values, f_new.quad)
    u, _ = prob.space.split(fwd.w)
    div_u = assemble.divergence_l2(prob.space, u)
    diverged = (not math.isfinite(fwd.newton.residual_norm)
                or not timing.to_host(torch.isfinite(j_rec)) or not adj_ok)
    return GDStepResult(f_new, lr, j_rec, div_u, fwd, z, g, gradj, inner,
                        diverged)


class GDTrajectory(NamedTuple):
    """Per-iteration scalars of ``gd_multi_step``, (n_steps,) each."""
    J: torch.Tensor
    lr: torch.Tensor                 # accepted LR per iteration
    div_u: torch.Tensor
    inner_iterations: torch.Tensor
    mask_count: torch.Tensor         # escaped buoys
    diverged: torch.Tensor


def gd_multi_step(prob: OCPProblem, f: Control, lr, n_steps: int,
                  use_line_search: bool = True, tau: float = 0.5,
                  c_armijo: float = 1e-4, lr_min: float = 1e-6,
                  max_ls_iters: int = 80, ode_impl=None,
                  adjoint_rhs_impl=None, matvec_of=None):
    """``n_steps`` iterations of ``gd_step`` with the control and the LR
    carried along: (f_final, lr_final, GDTrajectory). No divergence or
    convergence check happens between the steps; the per-step
    ``diverged`` flags are returned for the caller. The three hooks go to
    every step (``gd_step``), so a sharded layout runs N iterations in
    one call; ``mask_count`` sums the mask over every lane, padding
    included, as the JAX package does."""
    rows = []
    for _ in range(n_steps):
        res = gd_step(prob, f, lr, use_line_search=use_line_search, tau=tau,
                      c_armijo=c_armijo, lr_min=lr_min,
                      max_ls_iters=max_ls_iters, ode_impl=ode_impl,
                      adjoint_rhs_impl=adjoint_rhs_impl,
                      matvec_of=matvec_of)
        rows.append((float(res.J), res.lr, float(res.div_u),
                     res.inner_iterations, int(res.fwd.mask.sum()),
                     res.diverged))
        f, lr = res.f_new, res.lr
    cols = list(zip(*rows)) if rows else [()] * 6
    dtypes = (torch.float64, torch.float64, torch.float64, torch.int64,
              torch.int64, torch.bool)
    return f, lr, GDTrajectory(*(torch.tensor(c, dtype=d)
                                 for c, d in zip(cols, dtypes)))


# ---------------------------------------------------------------------------
# the host-stepped layer: staged programs, stepped Newton, staged adjoint
# ---------------------------------------------------------------------------
#
# The JAX package packs each of these into one compiled device program; in
# PyTorch each is a plain function over the stages above. What they carry
# is numerics: warm starts, the stepped multigrid Newton with its re-freeze
# and stagnation break, the staged adjoint with its plateau rule, and the
# host loops of ``opt/driver.py::run_gradient_descent`` and
# ``scripts/hires_mg_run_torch.py``.

class StagedPrograms(NamedTuple):
    """The stages of one GD iteration, split so that a host Armijo loop
    can drive them; the accepted probe's forward state may carry into the
    next iteration (the ``reuse_ls_forward`` trade)."""
    begin: object    # f_quad → (fwd, J)
    grad: object     # (f, fwd) → (z, g, gradj, div_u, adj_ok)
    probe: object    # (f, g, lr) → (f_new, fwd_new, J_new)
    record: object   # (u_values, f_quad) → J             [J(old u, new f)]
    # the ν-ladder one rung at a time (multigrid only), and the warm
    # begin/probe that skip the ladder from a state in the basin
    rung: object = None        # (f_quad, w, nu_k) → w'
    begin_warm: object = None  # (f_quad, w) → (fwd, J)
    probe_warm: object = None  # (f, g, lr, w) → (f_new, fwd_new, J_new)


def make_staged_pair(prob: OCPProblem, ode_impl=None, adjoint_rhs_impl=None,
                     matvec_of=None) -> StagedPrograms:
    """The staged-iteration functions: the math of ``gd_step``, the hooks
    of ``gd_step`` passed to every stage. ``rung`` exists on the
    multigrid path only (its hierarchy is frozen)."""
    def begin_warm(f_quad, w_start):
        fwd = forward(prob, f_quad, ode_impl=ode_impl, matvec_of=matvec_of,
                      w_start=w_start)
        return fwd, cost(prob, fwd.u_values, f_quad)

    def grad(f: Control, fwd: ForwardState):
        z, adj_ok = _solve_adjoint_flagged(
            prob, fwd, adjoint_rhs_impl=adjoint_rhs_impl,
            matvec_of=matvec_of)
        g = reduced_gradient(prob, f, z)
        gradj = ctrl_mod.boundary_inner(prob.bq, g, Control(-g.quad, -g.p2))
        u, _ = prob.space.split(fwd.w)
        return z, g, gradj, assemble.divergence_l2(prob.space, u), adj_ok

    def probe_warm(f: Control, g: Control, lr, w_start):
        with timing.span("probe"):
            f_new = f.axpy(-lr, g)
            fwd_new, j_new = begin_warm(f_new.quad, w_start)
            return f_new, fwd_new, j_new

    def rung(f_quad, w, nu_k):
        return _newton_at(prob, f_quad, float(nu_k), w,
                          matvec_of=matvec_of).w

    return StagedPrograms(
        lambda f_quad: begin_warm(f_quad, None), grad,
        lambda f, g, lr: probe_warm(f, g, lr, None),
        lambda u_values, f_quad: cost(prob, u_values, f_quad),
        rung=rung if prob.linear_solver == "mg" else None,
        begin_warm=begin_warm, probe_warm=probe_warm)


def _require_mg(prob: OCPProblem, what: str) -> None:
    if prob.linear_solver != "mg":
        raise ValueError(f"{what} runs on the multigrid path "
                         f"(linear_solver='mg'), not "
                         f"{prob.linear_solver!r}")


class NewtonStager(NamedTuple):
    """The multigrid Newton of ``newton_solve_mg`` split at step
    granularity, so that the host drives the convergence test."""
    init: object     # (f_quad, w0, nu) → (op0, op0_c, r, rnorm); op0_c the
    #                  coarse operator at w0 (mg_coarse_krylov > 0) or None
    step: object     # (f_quad, w, r, rnorm, op0, op0_c, nu, nu_scale,
    #                  tol) → (w', r', rnorm')
    finish: object   # (f_quad, w, it, rnorm, conv) → (fwd, J)
    axpy: object     # (f, g, lr) → f_new


def make_newton_stager(prob: OCPProblem, ode_impl=None, matvec_of=None,
                       restart: int = 60, max_restarts: int = 4,
                       step_tol: float = 1e-6) -> NewtonStager:
    """The stepped-Newton functions (multigrid path; the math of
    ``solve/mg.py::newton_solve_mg``: the preconditioner frozen at the
    state ``init`` saw, residual-monotone damping with the full step
    preferred). ν and ``nu_scale`` are arguments, so one stager serves
    every continuation rung and the solve at the problem's ν."""
    _require_mg(prob, "make_newton_stager")
    n = prob.space.ndof

    def init(f_quad, w0, nu):
        nu = float(nu)
        op0 = _operator_at(prob, nu)(w0)
        coarse = _coarse_operator_at(prob, nu)
        op0_c = coarse(w0) if coarse is not None else None
        r0 = mg_mod.bc_residual_fn(_residual_at(prob, f_quad, nu),
                                   prob.bc_dofs, prob.bc_vals, n)(w0)
        return op0, op0_c, r0, timing.to_host(torch.linalg.norm(r0))

    def step(f_quad, w, r, rnorm, op0, op0_c, nu, nu_scale, tol):
        nu = float(nu)
        M32 = mg_mod.make_block_preconditioner(
            prob.mg, prob.space, op0, op0_c, dtype=torch.float32,
            pre=prob.mg_pre, post=prob.mg_post, nu_scale=float(nu_scale),
            coarse_krylov=prob.mg_coarse_krylov)
        bc_residual = mg_mod.bc_residual_fn(
            _residual_at(prob, f_quad, nu), prob.bc_dofs, prob.bc_vals, n)
        w, r, rnorm, _ = mg_mod.newton_step_mg(
            _operator_at(prob, nu)(w), bc_residual, M32, prob.mg, w, r,
            float(rnorm), float(tol), restart=restart,
            max_restarts=max_restarts, matvec_of=matvec_of)
        return w, r, rnorm

    def finish(f_quad, w, it, rnorm, conv):
        newton = NewtonResult(w, int(it), float(rnorm), bool(conv))
        u, _ = prob.space.split(w)
        ode = (ode_impl or _primal_ode)(prob, u)
        fwd = ForwardState(w, ode.x, ode.u_values, ode.mask, newton,
                           ode.x_raw, ode.kfail)
        return fwd, cost(prob, fwd.u_values, f_quad)

    return NewtonStager(init, step, finish, lambda f, g, lr: f.axpy(-lr, g))


def run_newton_staged(stager: NewtonStager, f_quad, w0, nu: float,
                      nu_scale: float = 1.0, rtol: float = 1e-9,
                      atol: float = 1e-10, max_iter: int = 50,
                      polish: int = 1, step_tol: float = 1e-6,
                      sync=None, max_refreeze: int = 0,
                      stall_ratio: float = 0.5, on_step=None,
                      stagnation_break: int = 0):
    """Drive the stepped Newton from the host: the ``newton_solve_mg``
    loop, one ``stager.step`` a step. Returns (w, it, rnorm, converged).
    ``sync``: a callable given w after each step.

    ``max_refreeze`` > 0: when a step reduces the residual by less than
    the factor ``stall_ratio``, re-freeze the preconditioner at the
    current iterate (``stager.init``), at most that many times. 0 = off.
    ``on_step(it, rn, event)`` observes each step (event "") and each
    re-freeze (event "refreeze").

    ``stagnation_break`` > 0: give up after that many consecutive steps
    that contract by less than 3% (rn > 0.97·previous), unless the
    tolerance is met on that step. 0 = off. The caller sees
    converged=False and applies its own fallback.

    After the loop, ``polish`` steps with the Krylov tolerance
    min(step_tol, 1e-8) count as iterations, and a polish step that
    meets the tolerance counts as converged."""
    op0, op0_c, r, rn = stager.init(f_quad, w0, nu)
    r0norm = rn = float(rn)
    w, it = w0, 0
    refrozen = 0
    flat = 0
    while rn > atol and rn > rtol * r0norm and it < max_iter:
        prev = rn
        w, r, rn = stager.step(f_quad, w, r, rn, op0, op0_c, nu, nu_scale,
                               step_tol)
        rn = float(rn)
        it += 1
        if on_step is not None:
            on_step(it, rn, "")
        if sync is not None:
            sync(w)
        flat = flat + 1 if rn > 0.97 * prev else 0
        # a solve that meets the tolerance on the N-th flat step is not
        # a failure (the caller would retry it for nothing)
        if (stagnation_break and flat >= stagnation_break
                and rn > atol and rn > rtol * r0norm):
            return w, it, rn, False
        if (refrozen < max_refreeze and rn > stall_ratio * prev
                and rn > atol and rn > rtol * r0norm):
            op0, op0_c, r, rn = stager.init(f_quad, w, nu)
            rn = float(rn)
            refrozen += 1
            if on_step is not None:
                on_step(it, rn, "refreeze")
    converged = (rn <= atol) or (rn <= rtol * r0norm)
    tight = min(step_tol, 1e-8)
    for _ in range(polish):
        w, r, rn = stager.step(f_quad, w, r, rn, op0, op0_c, nu, nu_scale,
                               tight)
        rn = float(rn)
        it += 1
    converged = converged or (rn <= atol) or (rn <= rtol * r0norm)
    return w, it, rn, converged


class AdjointStager(NamedTuple):
    """The multigrid adjoint solve of ``solve_operator_mg`` split at
    refinement-round granularity."""
    rhs: object      # (f, fwd) → (b, op, op_c, div_u, bnorm)
    round: object    # (op, op_c, b, x) → (x', rnorm)
    finish: object   # (f, z) → (g, gradj)


def make_adjoint_stager(prob: OCPProblem, adjoint_rhs_impl=None,
                        matvec_of=None, tol: float = 1e-11,
                        restart: int = 60, max_restarts: int = 4,
                        inner_tol: float = 1e-6) -> AdjointStager:
    """The staged adjoint functions (multigrid path; the operation order
    of ``solve_operator_mg`` + ``reduced_gradient``, hence the same
    results). The preconditioner takes ``nu_scale`` = 1/ν: the adjoint
    Laplacian has unit viscosity while the hierarchy is frozen at ν.
    ``tol`` is ``run_adjoint_staged``'s; it is accepted here as in the
    JAX package."""
    _require_mg(prob, "make_adjoint_stager")
    del tol

    def rhs(f: Control, fwd: ForwardState):
        b = adjoint_rhs(prob, fwd, adjoint_rhs_impl=adjoint_rhs_impl)
        op, op_c = adjoint_operators(prob, fwd.w)
        b = assemble.apply_bc_vector(b, op.bc_dofs, prob.bc_vals)
        u, _ = prob.space.split(fwd.w)
        return (b, op, op_c, assemble.divergence_l2(prob.space, u),
                timing.to_host(torch.linalg.norm(b)))

    def round_(op, op_c, b, x):
        ops = mg_mod.refinement_operators(
            op, op_c, prob.mg, prob.space, pre=prob.mg_pre,
            post=prob.mg_post, coarse_krylov=prob.mg_coarse_krylov,
            nu_scale=1.0 / prob.nu, matvec_of=matvec_of)
        x, rnorm, _ = mg_mod.refinement_round(b, x, *ops, restart=restart,
                                              max_restarts=max_restarts,
                                              inner_tol=inner_tol)
        return x, rnorm

    def finish(f: Control, z):
        g = reduced_gradient(prob, f, z)
        return g, ctrl_mod.boundary_inner(prob.bq, g,
                                          Control(-g.quad, -g.p2))

    return AdjointStager(rhs, round_, finish)


def run_adjoint_staged(stager: AdjointStager, f: Control,
                       fwd: ForwardState, tol: float = 1e-11,
                       max_rounds: int = 4, sync=None, on_round=None,
                       accept_rel: float = 1e-9):
    """Drive the staged adjoint solve from the host. Returns (z, g, gradj,
    div_u, converged), the quintuple of ``StagedPrograms.grad``.
    ``on_round(round, relative residual)`` observes each round; ``sync``
    is given x after each round.

    A round that contracts the residual by less than 3× ends the loop:
    the float64 refinement is at its floor κ(A)·ε, which grows with the
    resolution (near 3e-11 of ‖b‖ at Nx=256, above ``tol``). The solve
    then counts as converged iff that plateau is at or below
    ``accept_rel``·‖b‖, far below what the gradient needs, while a
    preconditioner that stalls (3.6e-2 at ν = 0.01 on the Stokes coarse
    level) still reports non-convergence."""
    b, op, op_c, div_u, bnorm = stager.rhs(f, fwd)
    bnorm = float(bnorm)
    target = tol * max(bnorm, 1e-300)
    x = torch.zeros_like(b)
    rn, rounds, prev = bnorm, 0, None
    while rn > target and rounds < max_rounds:
        x, rn = stager.round(op, op_c, b, x)
        rn = float(rn)
        rounds += 1
        if on_round is not None:
            on_round(rounds, rn / max(bnorm, 1e-300))
        if sync is not None:
            sync(x)
        if prev is not None and rn > prev / 3.0:
            break                      # at the refinement floor
        prev = rn
    g, gradj = stager.finish(f, x)
    ok = rn <= max(target, accept_rel * max(bnorm, 1e-300))
    return x, g, gradj, div_u, ok
