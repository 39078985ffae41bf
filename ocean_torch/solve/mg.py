"""Geometric multigrid block preconditioning for the saddle-point solves
(port of ``ocean_jax/solve/mg.py``, without the ELL matvec tables).

FGMRES on the exact matrix-free mixed operator, right-preconditioned by
the block-triangular preconditioner

    P = [[Â, Bᵀ], [0, Ŝ]],   Ŝ = the ν-scaled lumped pressure mass,

where Â⁻¹ is one geometric V-cycle on the P2 velocity block: damped
Jacobi smoothing on each level, the coarse correction through the
transfer tables of the next coarser grid, and at the leaf an explicit
inverse of the Stokes velocity block (float64 on the device, once per
problem, rounded to float32 once). The levels below the finest are
frozen at w = 0, so the whole hierarchy is problem-constant.

Transfers are FE interpolation between two meshes of the same domain,
built once through the locator: the coarse grid need not be nested, and
odd L-shape resolutions snap their staircase dofs (``_clamp_to_domain``).

Precision, as in the JAX package: the inner FGMRES, the V-cycle and the
leaf solve run in float32; Newton residuals and the refinement rounds of
``solve_operator_mg`` are exact float64. Every reduction is a gather
over a precomputed incidence (no atomics), so a solve is reproducible on
the card. On the card the float32 FGMRES cycles of ``newton_solve_mg``
and ``solve_operator_mg`` replay one CUDA graph a solve
(``krylov.fgmres``'s ``graph``), which changes no number.

Spans (``utils/timing.py``): ``mg.precond`` (a preconditioner's build),
``newton.step`` (``cycles``, the damping ``theta``) with its
``newton.residual`` reads, ``mg.refine`` (``cycles``); each FGMRES call
is an ``fgmres`` span inside them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..fem import reference as ref
from ..fem.assemble import Operator, apply_bc_vector, gather_sum
from ..fem.spaces import TaylorHoodSpace, BoundaryQuad, incidence
from ..mesh.locate import locate_points
from ..ops import stencil as stencil_mod
from ..utils import timing
from . import krylov
from .newton import NewtonResult


# ---------------------------------------------------------------------------
# velocity sub-block of a mixed operator
# ---------------------------------------------------------------------------

def _velocity_incidence(inc: torch.Tensor, n_vel: int) -> torch.Tensor:
    """The incidence of the first 12 of 15 local dofs, from the mixed one:
    flat index e·15 + a becomes e·12 + a (velocity dofs have a < 12; the
    sentinel n·15 becomes n·12)."""
    inc = inc[:, :n_vel]
    return torch.div(inc, 15, rounding_mode="floor") * 12 + inc % 15


def velocity_block(op: Operator, n_vel: int) -> Operator:
    """The (2·n_p2)² velocity block of a mixed operator: local velocity
    dofs are columns 0..11 of the mixed element matrices, and the
    Dirichlet dofs are velocity dofs."""
    facet_mats = facet_dofs = facet_inc = None
    if op.facet_mats is not None:
        facet_mats = op.facet_mats[:, :12, :12]
        facet_dofs = op.facet_dofs[:, :12]
        facet_inc = _velocity_incidence(op.facet_inc, n_vel)
    return Operator(op.cell_mats[:, :12, :12], op.cell_dofs[:, :12],
                    facet_mats, facet_dofs, op.bc_dofs, n_vel,
                    inc=_velocity_incidence(op.inc, n_vel),
                    facet_inc=facet_inc)


# ---------------------------------------------------------------------------
# inter-mesh interpolation tables (built once)
# ---------------------------------------------------------------------------

def _clamp_to_domain(loc, points: np.ndarray) -> np.ndarray:
    """Snap points onto the analytic domain of ``loc``: staircase meshes
    (the L-shape where the inner corner is not a grid line) carry boundary
    dofs up to one cell outside the other grid's domain; snapping moves
    them at most one mesh width."""
    xmin, ymin, xmax, ymax = loc.extent
    p = np.clip(np.asarray(points, dtype=np.float64),
                [xmin, ymin], [xmax, ymax])
    if loc.domain == "lshape":
        cx, cy = loc.lshape_corner
        notch = (p[:, 0] < cx) & (p[:, 1] > cy)
        p[notch, 1] = cy
    return p


def _p2_interpolation_table(space_src: TaylorHoodSpace, points: np.ndarray):
    """(dofs (n, 6), weights (n, 6)) with a P2 field's value at
    ``points[i]`` = Σ_a w[i, a]·u[dofs[i, a]] (exact for P2 fields).
    Located on the source space's device."""
    pts = torch.as_tensor(_clamp_to_domain(space_src.locator, points),
                          dtype=torch.float64, device=space_src.device)
    cell, xi, inside = locate_points(space_src.locator, pts)
    if not bool(inside.all()):
        raise ValueError("interpolation point outside the source mesh")
    w = torch.as_tensor(ref.p2_basis(xi.cpu().numpy()),
                        dtype=torch.float64, device=space_src.device)
    return space_src.cell_dofs_p2[cell], w


def _interp(dofs: torch.Tensor, w: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """Apply an interpolation table: (n_src, k) → (n_dst, k)."""
    return torch.einsum("ia,iak->ik", w, vals[dofs])


def _interp_t(w: torch.Tensor, vals: torch.Tensor,
              inc: torch.Tensor) -> torch.Tensor:
    """Transpose application (restriction of dual vectors), reduced
    through the table's incidence: (n_dst, k) → (n_src, k)."""
    return gather_sum(torch.einsum("ia,ik->iak", w, vals), inc)


# ---------------------------------------------------------------------------
# the multigrid context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MGContext:
    """What the preconditioner needs besides the fine operator: the coarse
    level's tables, the transfers, and the coarse correction (the leaf
    inverse ``ainv_c``, or ``op_vel_c`` and ``sub`` for a recursive
    V-cycle on the frozen coarse Stokes velocity block)."""

    space_c: TaylorHoodSpace
    bq_c: Optional[BoundaryQuad]
    bc_dofs_c: torch.Tensor
    # prolongation: coarse P2 → fine P2 (per scalar dof), and the
    # incidence of pro_dofs that reduces its transpose
    pro_dofs: torch.Tensor         # (n_f2, 6)
    pro_w: torch.Tensor            # (n_f2, 6)
    pro_inc: torch.Tensor          # (max_inc, n_c2)
    # state injection: fine P2 → coarse P2
    inj_dofs: torch.Tensor         # (n_c2, 6)
    inj_w: torch.Tensor            # (n_c2, 6)
    pm_inv: torch.Tensor           # (n_f1,) Ŝ⁻¹ = ν / lumped pressure mass
    nu: float
    # "stencil" (ops/stencil.py tables for this context's FINE space) or
    # "scatter" (element matvecs: mg_matvec="scatter", or a domain whose
    # table build failed)
    matvec: str = "scatter"
    st_mixed: Optional[stencil_mod.StencilTables] = None
    st_vel: Optional[stencil_mod.StencilTables] = None
    ainv_c: Optional[torch.Tensor] = None    # float32 leaf inverse
    op_vel_c: Optional[Operator] = None      # frozen coarse velocity block
    sub: Optional["MGContext"] = None


def build_mg_context(space_f: TaylorHoodSpace, space_c: TaylorHoodSpace,
                     bq_c: Optional[BoundaryQuad], bc_dofs_c: torch.Tensor,
                     nu: float, bq_f: Optional[BoundaryQuad] = None,
                     use_stencil: bool = True,
                     blocks: tuple = ("mixed", "vel")) -> MGContext:
    """Transfer tables between a fine and a coarse space of one domain,
    and the stencil tables of the fine space for ``blocks``. Where the
    tables cannot be built (``ValueError``), the context falls back to
    element scatter matvecs and records it in ``matvec``."""
    pro_dofs, pro_w = _p2_interpolation_table(
        space_c, space_f.dof_coords_p2.cpu().numpy())
    inj_dofs, inj_w = _p2_interpolation_table(
        space_f, space_c.dof_coords_p2.cpu().numpy())
    pro_inc = torch.as_tensor(incidence(pro_dofs.cpu().numpy(),
                                        space_c.n_p2),
                              dtype=torch.int64, device=space_f.device)
    pm = krylov.pressure_mass_lumped(space_f, nu)
    st = {}
    if use_stencil:
        try:
            st = {b: stencil_mod.build_stencil_tables(space_f, bq_f, b)
                  for b in blocks}
        except ValueError:
            st = {}
    return MGContext(space_c=space_c, bq_c=bq_c, bc_dofs_c=bc_dofs_c,
                     pro_dofs=pro_dofs, pro_w=pro_w, pro_inc=pro_inc,
                     inj_dofs=inj_dofs, inj_w=inj_w, pm_inv=1.0 / pm, nu=nu,
                     matvec="stencil" if st else "scatter",
                     st_mixed=st.get("mixed"), st_vel=st.get("vel"))


def inject_state(mg: MGContext, space_f: TaylorHoodSpace,
                 w_f: torch.Tensor) -> torch.Tensor:
    """A fine mixed state's velocity sampled at the coarse P2 dofs, as a
    coarse mixed state with pressure 0 (only the velocity enters the
    convection terms of the Jacobian)."""
    u_f, _ = space_f.split(w_f)
    u_c = _interp(mg.inj_dofs, mg.inj_w, u_f)
    return torch.cat([u_c.reshape(-1), u_c.new_zeros(mg.space_c.n_p1)])


# ---------------------------------------------------------------------------
# the preconditioner
# ---------------------------------------------------------------------------

def op_matvec(op: Operator, dtype=torch.float64
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Element-scatter operator application in ``dtype`` (the element
    matrices are cast once); float64 is ``Operator.matvec64``."""
    cm = op.cell_mats.to(dtype)
    fm = None if op.facet_mats is None else op.facet_mats.to(dtype)

    def mv(x):
        y = gather_sum(torch.einsum("cab,cb->ca", cm, x[op.cell_dofs]),
                       op.inc)
        if fm is not None:
            y = y + gather_sum(torch.einsum("fab,fb->fa", fm,
                                            x[op.facet_dofs]), op.facet_inc)
        return y.index_copy(0, op.bc_dofs, x[op.bc_dofs])

    return mv


def _stencil_or_scatter(st, op: Operator, dtype) -> Callable:
    """Operator application: stencil form where tables exist, element
    scatter otherwise."""
    if st is not None:
        return stencil_mod.matvec_of(st, dtype)(op)
    return op_matvec(op, dtype)


def _jacobi_dinv(vel_op: Operator, omega: float, dtype) -> torch.Tensor:
    d = krylov.operator_diagonal(vel_op)
    return (omega / torch.where(d.abs() > 1e-30, d,
                                torch.ones_like(d))).to(dtype)


def _make_vcycle(mg: MGContext, vel_mv: Callable, dinv: torch.Tensor,
                 bc_f: torch.Tensor, dtype, pre: int, post: int,
                 coarse_solve: Callable) -> Callable:
    """One V-cycle on a level's velocity block: ``pre`` damped-Jacobi
    sweeps (``dinv`` = ω / diagonal), the coarse correction through
    ``coarse_solve`` over the transfers of ``mg``, ``post`` sweeps."""
    pro_w = mg.pro_w.to(dtype)
    bc_c = mg.bc_dofs_c

    def vcycle(r):
        e = dinv * r
        for _ in range(pre - 1):
            e = e + dinv * (r - vel_mv(e))
        res = (r - vel_mv(e)).reshape(-1, 2)
        rc = _interp_t(pro_w, res, mg.pro_inc).reshape(-1)
        ec = coarse_solve(rc.index_fill(0, bc_c, 0.0))
        ef = _interp(mg.pro_dofs, pro_w, ec.reshape(-1, 2)).reshape(-1)
        e = e + ef.index_fill(0, bc_f, 0.0)
        for _ in range(post):
            e = e + dinv * (r - vel_mv(e))
        return e

    return vcycle


def _coarse_solver(mg: MGContext, dtype, omega: float, pre: int,
                   post: int) -> Callable:
    """The coarse correction of a context: the leaf inverse as one float32
    matrix-vector product, or a recursive V-cycle on the frozen coarse
    velocity block over ``mg.sub``."""
    if mg.ainv_c is not None:
        ainv_c = mg.ainv_c
        return lambda rc: (ainv_c @ rc.to(torch.float32)).to(dtype)
    if mg.sub is not None:
        if mg.op_vel_c is None:
            raise ValueError("a multi-level context needs the frozen coarse "
                             "velocity operator op_vel_c")
        dinv_c = _jacobi_dinv(mg.op_vel_c, omega, dtype)
        mv_c = _stencil_or_scatter(mg.sub.st_vel, mg.op_vel_c, dtype)
        sub_solve = _coarse_solver(mg.sub, dtype, omega, pre, post)
        return _make_vcycle(mg.sub, mv_c, dinv_c, mg.bc_dofs_c, dtype,
                            pre, post, sub_solve)
    raise NotImplementedError(
        "ocean_torch: a legacy multigrid context (neither ainv_c nor sub, "
        "the coarse velocity block inverted per solve) is not ported; "
        "build the hierarchy with system.build_mg_hierarchy")


@timing.span("mg.precond")
def make_block_preconditioner(mg: MGContext, space_f: TaylorHoodSpace,
                              op_mixed: Operator,
                              op_mixed_c: Optional[Operator] = None,
                              omega: float = 0.6, pre: int = 2,
                              post: int = 2, dtype=torch.float64,
                              nu_scale: float = 1.0,
                              coarse_krylov: int = 0
                              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """M ≈ P⁻¹ from a (possibly frozen) fine mixed operator and the
    context's hierarchy:

      M(r): p = −Ŝ⁻¹ r_p;  u = V-cycle_Â(r_u − Bᵀp);  return (u, p)

    ``nu_scale`` = (operator's viscosity) / (hierarchy ν): the frozen
    coarse blocks are ν-linear, so the coarse correction is divided and
    the Schur term multiplied by it (the adjoint, whose Laplacian has unit
    viscosity, passes 1/ν). ``coarse_krylov`` > 0 demotes the frozen
    Stokes coarse solve to the preconditioner of a short inner FGMRES on
    the velocity block of ``op_mixed_c``, the coarse operator at the
    caller's linearization state."""
    n_vel = 2 * space_f.n_p2
    vel_f = velocity_block(op_mixed, n_vel)
    dinv = _jacobi_dinv(vel_f, omega, dtype)
    vel_mv = _stencil_or_scatter(mg.st_vel, vel_f, dtype)
    mixed_mv = _stencil_or_scatter(mg.st_mixed, op_mixed, dtype)

    coarse_solve = _coarse_solver(mg, dtype, omega, pre, post)
    if nu_scale != 1.0:
        stokes = coarse_solve
        coarse_solve = lambda rc: stokes(rc) * (1.0 / nu_scale)
    if coarse_krylov > 0:
        if op_mixed_c is None:
            raise ValueError("coarse_krylov needs the state-assembled "
                             "coarse operator op_mixed_c")
        vel_c = velocity_block(op_mixed_c, 2 * mg.space_c.n_p2)
        mv_c = _stencil_or_scatter(
            mg.sub.st_vel if mg.sub is not None else None, vel_c,
            torch.float32)
        stokes_solve = coarse_solve

        def coarse_solve(rc):
            sol = krylov.fgmres(
                mv_c, rc.to(torch.float32),
                M=lambda v: stokes_solve(v).to(torch.float32),
                restart=coarse_krylov, max_restarts=1, tol=1e-3)
            return sol.x.to(dtype)

    pm_inv = (mg.pm_inv * nu_scale).to(dtype)
    vcycle = _make_vcycle(mg, vel_mv, dinv, op_mixed.bc_dofs, dtype, pre,
                          post, coarse_solve)

    def M(r):
        ru, rp = r[:n_vel], r[n_vel:]
        p = -pm_inv * rp
        # Bᵀp through the mixed matvec of (0, p): the gradient block does
        # not depend on the state, so the frozen operator is exact here
        btp = mixed_mv(torch.cat([p.new_zeros(n_vel), p]))[:n_vel]
        return torch.cat([vcycle(ru - btp), p])

    return M


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

class MGSolveResult(NamedTuple):
    x: torch.Tensor
    residual_norm: float           # exact float64 ‖b − A x‖
    iterations: int                # FGMRES restart cycles, all rounds
    converged: bool
    rounds: int                    # float64 refinement rounds
    b_norm: float                  # ‖b‖ (BC values applied)


def refinement_operators(op: Operator, op_c: Optional[Operator],
                         mg: MGContext, space_f: TaylorHoodSpace,
                         pre: int = 2, post: int = 2,
                         coarse_krylov: int = 0, nu_scale: float = 1.0,
                         matvec_of: Optional[Callable] = None):
    """(M32, mv64, mv32) of the mixed-precision refinement of op x = b:
    the float32 block preconditioner, the float64 residual matvec and the
    float32 Krylov matvec. ``matvec_of`` (op → matvec, the dof-sharded
    one of ``parallel/dof_sharding.py``) replaces the float64 matvec
    only; the float32 Krylov matvec is then the element matvec
    ``op_matvec``, not the stencil (the JAX package's rule)."""
    M32 = make_block_preconditioner(mg, space_f, op, op_c,
                                    dtype=torch.float32, pre=pre, post=post,
                                    coarse_krylov=coarse_krylov,
                                    nu_scale=nu_scale)
    if matvec_of is not None:
        return M32, matvec_of(op), op_matvec(op, torch.float32)
    mv64 = (op.matvec64 if mg.st_mixed is None
            else _stencil_or_scatter(mg.st_mixed, op, torch.float64))
    return M32, mv64, _stencil_or_scatter(mg.st_mixed, op, torch.float32)


def refinement_round(b: torch.Tensor, x: torch.Tensor, M32: Callable,
                     mv64: Callable, mv32: Callable, restart: int = 60,
                     max_restarts: int = 4, inner_tol: float = 1e-6,
                     graph: bool = False):
    """One float64 refinement round: the exact residual b − A x, a
    float32 FGMRES correction (``graph`` as ``krylov.fgmres``'s), and the
    exact residual norm after it. Returns (x', ‖b − A x'‖, FGMRES
    cycles); the span ``mg.refine``."""
    with timing.span("mg.refine") as span:
        r = b - mv64(x)
        sol = krylov.fgmres(mv32, r.to(torch.float32), M=M32,
                            restart=restart, max_restarts=max_restarts,
                            tol=inner_tol, graph=graph)
        x = x + sol.x.to(torch.float64)
        rnorm = timing.to_host(torch.linalg.norm(b - mv64(x)))
        span.set(cycles=sol.iterations)
    return x, rnorm, sol.iterations


def solve_operator_mg(op: Operator, op_c: Optional[Operator],
                      mg: MGContext, space_f: TaylorHoodSpace,
                      b: torch.Tensor, bc_vals: torch.Tensor,
                      tol: float = 1e-11, restart: int = 60,
                      max_restarts: int = 4, inner_tol: float = 1e-6,
                      max_rounds: int = 4, pre: int = 2, post: int = 2,
                      coarse_krylov: int = 0, nu_scale: float = 1.0,
                      matvec_of: Optional[Callable] = None) -> MGSolveResult:
    """op x = b by mixed-precision FGMRES with the multigrid block
    preconditioner: float32 inner solves inside float64 refinement
    rounds (``refinement_round``), until ‖b − A x‖ ≤ tol·‖b‖ or
    ``max_rounds``. ``op_c`` (the coarse assembly of the same form) is
    needed for ``coarse_krylov`` > 0 only; ``matvec_of`` as in
    ``refinement_operators``. Without either, the rounds replay one CUDA
    graph of the Krylov cycle on a CUDA device (``krylov.fgmres``)."""
    b = apply_bc_vector(b, op.bc_dofs, bc_vals)
    M32, mv64, mv32 = refinement_operators(
        op, op_c, mg, space_f, pre=pre, post=post,
        coarse_krylov=coarse_krylov, nu_scale=nu_scale, matvec_of=matvec_of)
    bnorm = timing.to_host(torch.linalg.norm(b))
    target = tol * max(bnorm, 1e-300)
    graph = coarse_krylov == 0 and matvec_of is None
    x = torch.zeros_like(b)
    rnorm, rounds, inner = bnorm, 0, 0
    while rnorm > target and rounds < max_rounds:
        x, rnorm, cycles = refinement_round(b, x, M32, mv64, mv32, restart,
                                            max_restarts, inner_tol, graph)
        rounds += 1
        inner += cycles
    return MGSolveResult(x, rnorm, inner, rnorm <= target, rounds, bnorm)


def bc_residual_fn(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                   bc_dofs: torch.Tensor, bc_vals: torch.Tensor, n: int
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """w → the residual with its Dirichlet rows replaced by w − g."""
    dev = bc_vals.device
    is_bc = torch.zeros(n, dtype=torch.bool, device=dev)
    is_bc[bc_dofs] = True
    g_full = torch.zeros(n, dtype=torch.float64,
                         device=dev).index_copy(0, bc_dofs, bc_vals)
    return lambda w: torch.where(is_bc, w - g_full, residual_fn(w))


def newton_step_mg(op: Operator, bc_residual: Callable, M32: Callable,
                   mg: MGContext, w: torch.Tensor, r: torch.Tensor,
                   rnorm: float, tol: float, restart: int = 60,
                   max_restarts: int = 4,
                   matvec_of: Optional[Callable] = None,
                   graph: bool = False):
    """One Newton step on the Jacobian ``op`` at w: a float32 FGMRES solve
    of op·dw = −r preconditioned by ``M32`` (``graph`` as
    ``krylov.fgmres``'s), then residual-monotone damping with the full
    step preferred (θ = 1, ½, ¼, ⅛: the first that lowers ‖r‖, else the
    full step). ``matvec_of`` (op → matvec, in the dtype of its input)
    replaces the Krylov matvec. Returns (w', r', ‖r'‖, FGMRES cycles);
    the span ``newton.step``."""
    with timing.span("newton.step") as span:
        mv32 = (_stencil_or_scatter(mg.st_mixed, op, torch.float32)
                if matvec_of is None else matvec_of(op))
        sol = krylov.fgmres(mv32, (-r).to(torch.float32), M=M32,
                            restart=restart, max_restarts=max_restarts,
                            tol=tol, graph=graph)
        dw = sol.x.to(torch.float64)
        best = None
        for theta in (1.0, 0.5, 0.25, 0.125):
            cand = w + theta * dw
            with timing.span("newton.residual"):
                r_c = bc_residual(cand)
                n_c = timing.to_host(torch.linalg.norm(r_c))
            if best is None or n_c < rnorm:
                best = (cand, r_c, n_c, theta)
            if n_c < rnorm:
                break
        span.set(cycles=sol.iterations, theta=best[3])
    return (*best[:3], sol.iterations)


def newton_solve_mg(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                    operator_fn: Callable[[torch.Tensor], Operator],
                    coarse_operator_fn: Optional[Callable[[torch.Tensor],
                                                          Operator]],
                    mg: MGContext, space_f: TaylorHoodSpace,
                    w0: torch.Tensor, bc_dofs: torch.Tensor,
                    bc_vals: torch.Tensor,
                    rtol: float = 1e-9, atol: float = 1e-10,
                    max_iter: int = 50, step_tol: float = 1e-6,
                    restart: int = 60, max_restarts: int = 4,
                    polish: int = 1, pre: int = 2, post: int = 2,
                    nu_scale: float = 1.0, coarse_krylov: int = 0,
                    matvec_of: Optional[Callable] = None) -> NewtonResult:
    """BC-aware Newton with float32 FGMRES steps (the convergence criteria
    of ``newton_solve``).

    The block preconditioner is built once at w0 (a Stokes preconditioner
    for w0 = 0) and reused by every step: each step's matvec is the exact
    current Jacobian and the test is the exact float64 residual, so
    staleness costs Krylov iterations, not accuracy. A step is damped as
    ``newton_step_mg`` says. After the test passes, ``polish`` more steps
    with a Krylov tolerance of min(step_tol, 1e-8) push the residual well
    below it; they count as iterations. ``krylov_cycles`` lists each
    step's FGMRES cycles. ``matvec_of`` (op → matvec, in the dtype of its
    input) replaces the Krylov matvec of every step. Without it and
    without ``coarse_krylov``, the steps replay one CUDA graph of the
    Krylov cycle on a CUDA device (``krylov.fgmres``): the stencil
    Jacobian of each step is loaded into one ``ReloadableMatvec``."""
    graph = coarse_krylov == 0 and matvec_of is None
    step_matvec = matvec_of
    if graph and mg.st_mixed is not None:
        step_matvec = stencil_mod.ReloadableMatvec(mg.st_mixed).load
    bc_residual = bc_residual_fn(residual_fn, bc_dofs, bc_vals, w0.shape[0])
    op0 = operator_fn(w0)
    op0_c = coarse_operator_fn(w0) if coarse_operator_fn is not None else None
    M32 = make_block_preconditioner(mg, space_f, op0, op0_c,
                                    dtype=torch.float32, pre=pre, post=post,
                                    nu_scale=nu_scale,
                                    coarse_krylov=coarse_krylov)
    cycles: List[int] = []

    def step(w, r, rnorm, tol):
        w, r, rnorm, n_cyc = newton_step_mg(
            operator_fn(w), bc_residual, M32, mg, w, r, rnorm, tol,
            restart=restart, max_restarts=max_restarts,
            matvec_of=step_matvec, graph=graph)
        cycles.append(n_cyc)
        return w, r, rnorm

    with timing.span("newton.residual"):
        r = bc_residual(w0)
        r0norm = timing.to_host(torch.linalg.norm(r))
    w, rnorm, it = w0, r0norm, 0
    while rnorm > atol and rnorm > rtol * r0norm and it < max_iter:
        w, r, rnorm = step(w, r, rnorm, step_tol)
        it += 1
    converged = (rnorm <= atol) or (rnorm <= rtol * r0norm)
    for _ in range(polish):
        w, r, rnorm = step(w, r, rnorm, min(step_tol, 1e-8))
        it += 1
    return NewtonResult(w, it, rnorm, converged, None, tuple(cycles))
