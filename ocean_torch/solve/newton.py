"""Newton solver for the stationary Navier–Stokes system (port of
``ocean_jax/solve/newton.py``).

A host loop replaces ``lax.while_loop``. Convergence criteria are
dolfin's ``NewtonSolver`` defaults (residual criterion, rtol 1e-9, atol
1e-10, 50 iterations). Dirichlet rows follow dolfin: the residual entry
at a constrained dof is ``w[dof] - g`` and the Jacobian row is identity.

The chord Newton of the Navier–Stokes problem (``chord_solve``) runs on
static buffers. On a CUDA device its step and the residual norm that
follows are one CUDA graph (``ChordGraph``), captured once for the
factors, tables and boundary values it reads and replayed for every step
of every solve with them: the kernels of the eager step on the same
values in the same order, so the numbers are the eager loop's, and the
host launches a step once instead of once a kernel. The convergence
test stays on the host, one norm read a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jvp

from ..fem import assemble
from ..ops import linalg
from ..utils import graphs, timing


class NewtonResult(NamedTuple):
    w: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool
    # factors (an LUSolver or InvSolver) of the last Jacobian the solver
    # factorized (J(w0) under reuse_factorization); the adjoint solve
    # reuses them transposed
    fac: Optional[object] = None
    # FGMRES restart cycles of each step (the multigrid Newton,
    # solve/mg.py::newton_solve_mg); empty for the dense Newton
    krylov_cycles: tuple = ()
    # steps that ran as a replay of the chord's CUDA graph
    graph_steps: int = 0


def newton_solve(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                 operator_fn: Callable[[torch.Tensor], "object"],
                 w0: torch.Tensor,
                 bc_dofs: torch.Tensor,
                 bc_vals: torch.Tensor,
                 rtol: float = 1e-9,
                 atol: float = 1e-10,
                 max_iter: int = 50,
                 reuse_factorization: bool = False,
                 correction_iters: int = 1,
                 fac0=None,
                 residual_fn32: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None
                 ) -> NewtonResult:
    """Solve residual(w) = 0 with BC-aware Newton.

    residual_fn: raw float64 residual (no BC rows); operator_fn: w →
    ``fem.assemble.Operator`` (the Jacobian with BC rows).

    ``reuse_factorization=True`` is the chord Newton: only J(w0) is
    factorized (or ``fac0`` is taken as its factors — for w0 = 0 that is
    the problem-constant Stokes operator), and each step solves
    J(w) δ = −r through those stale factors with ``correction_iters``
    Richardson sweeps δ ← δ + M⁻¹(−r − J(w) δ) against the exact J(w)·δ,
    taken as the forward-mode tangent of the BC-aware residual
    (``torch.func.jvp``; the assembled operator is jacfwd of the same
    element residuals, so it is the same linear map).

    ``fac0``: an ``linalg.LUSolver`` or ``linalg.InvSolver`` of J(w0).
    Without reuse each later step refactors in ``fac0``'s kind
    (``refactor``): float64 LU factors by default.

    ``residual_fn32``: the float32 twin of ``residual_fn`` (the same form
    on float32 tables). Given it and ``reuse_factorization``, the
    correction sweeps (tangent, applies) run in float32 through
    ``fac0.solve32_raw``; the float64 residual stays the only convergence
    test, so the accepted state differs only below the 1e-9·‖r0‖
    threshold.
    """
    is_bc, g_full = _bc_vectors(w0, bc_dofs, bc_vals)

    def bc_residual(w):
        return torch.where(is_bc, w - g_full, residual_fn(w))

    bc_residual32 = None
    if residual_fn32 is not None:
        g_full32 = g_full.to(torch.float32)

        def bc_residual32(w32):
            return torch.where(is_bc, w32 - g_full32, residual_fn32(w32))

    def residual_and_norm(w):
        with timing.span("newton.residual"):
            r = bc_residual(w)
            return r, timing.to_host(torch.linalg.norm(r))

    r, r0norm = residual_and_norm(w0)
    if fac0 is None:
        with timing.span("newton.factor"):
            fac0 = linalg.factorize(operator_fn(w0).dense())

    w, rnorm, it, fac = w0, r0norm, 0, fac0
    while rnorm > atol and rnorm > rtol * r0norm and it < max_iter:
        if not reuse_factorization and it > 0:
            with timing.span("newton.factor"):
                fac = fac.refactor(operator_fn(w).dense())
        with timing.span("newton.step"):
            if reuse_factorization:
                w = _chord_step(fac0, bc_residual, bc_residual32, w, r,
                                correction_iters)
            else:
                w = w + fac.solve(-r)
        r, rnorm = residual_and_norm(w)
        it += 1
    converged = (rnorm <= atol) or (rnorm <= rtol * r0norm)
    return NewtonResult(w, it, rnorm, converged, fac)


def float32_tables(tables):
    """A copy of a space or a quadrature with its floating tables cast to
    float32 (index tables and the locator as they are)."""
    return dataclasses.replace(tables, **{
        f.name: getattr(tables, f.name).to(torch.float32)
        for f in dataclasses.fields(tables)
        if torch.is_tensor(getattr(tables, f.name))
        and getattr(tables, f.name).is_floating_point()})


def _bc_vectors(w0: torch.Tensor, bc_dofs: torch.Tensor,
                bc_vals: torch.Tensor):
    """The Dirichlet mask and values as full vectors (no host sync)."""
    is_bc = torch.zeros(w0.shape[0], dtype=torch.bool,
                        device=w0.device).index_fill(0, bc_dofs, True)
    return is_bc, torch.zeros_like(w0).index_copy(0, bc_dofs, bc_vals)


def _chord_step(fac0, bc_residual, bc_residual32, w: torch.Tensor,
                r: torch.Tensor, correction_iters: int) -> torch.Tensor:
    """w + δ, δ from the stale factors ``fac0`` refined by
    ``correction_iters`` Richardson sweeps against the ``jvp`` tangent of
    the BC-aware residual; in float32 where its float32 twin
    ``bc_residual32`` is given."""
    if bc_residual32 is not None:
        w32, r32 = w.to(torch.float32), r.to(torch.float32)
        dw32 = fac0.solve32_raw(-r32)
        for _ in range(correction_iters):
            _, jdw = jvp(bc_residual32, (w32,), (dw32,))
            dw32 = dw32 + fac0.solve32_raw(-(r32 + jdw))
        return w + dw32.to(torch.float64)
    dw = fac0.solve(-r)
    for _ in range(correction_iters):
        _, jdw = jvp(bc_residual, (w,), (dw,))
        dw = dw + fac0.solve(-(r + jdw))
    return w + dw


class ChordGraph:
    """The chord step of ``newton_solve`` for the Navier–Stokes residual
    on static buffers: ``step()`` runs w ← w + δ (``_chord_step``), then
    r ← bc_residual(w) and ``nrm`` ← ‖r‖; ``residual()`` runs the last
    two alone. The Dirichlet vectors, the float32 tables of the float32
    branch and ``f_quad``'s buffers are made once here, not every solve.

    ``capture`` (``utils/graphs.py::cached``) makes both CUDA graphs on a
    CUDA device, replayed (``graphed``), and leaves them eager on the
    CPU. The graphs read the tensors of ``fac0``, ``space`` and ``bq`` as
    they were captured, at ν with ``correction_iters`` sweeps."""

    def __init__(self, fac0, space, bq, nu: float, bc_dofs: torch.Tensor,
                 bc_vals: torch.Tensor, f_quad: torch.Tensor, float32: bool,
                 correction_iters: int, capture):
        dev = f_quad.device
        self.w = torch.zeros(space.ndof, dtype=torch.float64, device=dev)
        self.r = torch.zeros_like(self.w)
        self.nrm = self.w.new_zeros(())
        self.f_quad = torch.zeros_like(f_quad)
        self.is_bc, self.g_full = _bc_vectors(self.w, bc_dofs, bc_vals)
        # the float32 branch's load, boundary values and tables
        self.f_quad32 = self.f_quad.to(torch.float32) if float32 else None
        self.f32 = ((float32_tables(space), float32_tables(bq),
                     self.g_full.to(torch.float32)) if float32 else None)
        step, residual = self._bodies(fac0, space, bq, nu, correction_iters)
        self.graphed = dev.type == "cuda"
        self.graphs = capture((step, residual), warm_up=step)

    def _bodies(self, fac0, space, bq, nu: float, correction_iters: int):
        w, r, nrm, is_bc, g_full, f_quad = (self.w, self.r, self.nrm,
                                            self.is_bc, self.g_full,
                                            self.f_quad)

        def bc_residual(x):
            return torch.where(is_bc, x - g_full, assemble.ns_residual(
                space, bq, x, f_quad, nu))

        bc_residual32 = None
        if self.f32 is not None:
            (space32, bq32, g_full32), f_quad32 = self.f32, self.f_quad32

            def bc_residual32(x32):
                return torch.where(is_bc, x32 - g_full32, assemble.ns_residual(
                    space32, bq32, x32, f_quad32, nu))

        def residual():
            r.copy_(bc_residual(w))
            nrm.copy_(torch.linalg.norm(r))

        def step():
            w.copy_(_chord_step(fac0, bc_residual, bc_residual32, w, r,
                                correction_iters))
            residual()

        return step, residual

    def load(self, w0: torch.Tensor, f_quad: torch.Tensor) -> None:
        """Copy a solve's start and load into the static buffers."""
        self.w.copy_(w0)
        self.f_quad.copy_(f_quad)
        if self.f_quad32 is not None:
            self.f_quad32.copy_(f_quad)

    def step(self) -> None:
        self.graphs[0]()

    def residual(self) -> None:
        self.graphs[1]()


def chord_solve(space, bq, f_quad: torch.Tensor, nu: float,
                w0: torch.Tensor, bc_dofs: torch.Tensor,
                bc_vals: torch.Tensor, fac0, correction_iters: int = 1,
                float32: bool = False, rtol: float = 1e-9,
                atol: float = 1e-10, max_iter: int = 50) -> NewtonResult:
    """The chord Newton of ``newton_solve`` (``reuse_factorization`` on
    the factors ``fac0``) for ``assemble.ns_residual`` of ``space``,
    ``bq`` and ``f_quad`` at ν, from w0, on the device's newest
    ``ChordGraph``, made anew unless it serves these objects and
    constants (``utils/graphs.py::cached``): the iterations, residual norms and state of ``newton_solve`` bit for
    bit. ``float32`` runs the sweeps on the float32 twin of the residual,
    as ``residual_fn32`` does there. ``graph_steps`` counts the steps
    that ran as a graph replay: all of them on a CUDA device, none on
    the CPU. A step is the span ``newton.step`` (``graph`` 1 where it is
    a replay), each norm read the span ``newton.residual``."""
    g = graphs.cached(
        "chord", f_quad.device, (fac0, space, bq, bc_dofs, bc_vals),
        (nu, float32, correction_iters, f_quad.shape, f_quad.dtype),
        lambda capture: ChordGraph(fac0, space, bq, nu, bc_dofs, bc_vals,
                                   f_quad, float32, correction_iters,
                                   capture))
    g.load(w0, f_quad)
    with timing.span("newton.residual"):
        g.residual()
        r0norm = timing.to_host(g.nrm)
    rnorm, it = r0norm, 0
    while rnorm > atol and rnorm > rtol * r0norm and it < max_iter:
        with timing.span("newton.step", graph=int(g.graphed)):
            g.step()
        with timing.span("newton.residual"):
            rnorm = timing.to_host(g.nrm)
        it += 1
    converged = (rnorm <= atol) or (rnorm <= rtol * r0norm)
    return NewtonResult(g.w.clone(), it, rnorm, converged, fac0,
                        graph_steps=it if g.graphed else 0)
