"""Matrix-free Krylov solvers for the saddle-point systems (port of
``ocean_jax/solve/krylov.py``).

FGMRES runs on a matrix-free operator application, right-preconditioned;
``solve_operator_krylov`` pairs it with the Jacobi / lumped-pressure-mass
block diagonal. The multigrid preconditioner of the high-resolution path
is ``solve/mg.py``.

The restart cycles are a host loop, the Arnoldi steps of a cycle are
queued without a host sync, and each cycle's small least-squares problem
is solved on the host in float64 by SVD (as ``jnp.linalg.lstsq`` does),
one device-to-host copy a cycle. Each call is one ``fgmres`` span
(``utils/timing.py``), and its norm reads and the copy are counted host
syncs. With ``graph=True`` on a CUDA device the Arnoldi steps of a cycle
are one CUDA graph (``_CycleGraph``): captured once, then replayed for
every cycle, and for later calls with the same operator and
preconditioner objects, whose tensors may change in place in between
(``utils/graphs.py``).
Replay launches the kernels of the eager steps on the same buffers, so
the numbers are the eager loop's; the host dispatches a cycle once
instead of once a cycle. The operator and the preconditioner must then
make no host sync and no collective.

One departure from the JAX Arnoldi: each step orthogonalizes twice
(classical Gram–Schmidt with one re-orthogonalization, CGS2). In float32
a single pass loses orthogonality on the ill-conditioned preconditioned
saddle systems: on the L-shape at resolution 13 the JAX package's FGMRES
reaches only 1e-4 to 3e-3 of a Newton step's right-hand side in its 4
cycles, and the port's Newton with a single pass stalls at 9.3e-9 with
8 CPU threads; with CGS2 every step reaches 3e-7 to 1.1e-6 and Newton
ends at 5e-16 in 4 iterations (``scripts/fgmres_orthogonalization_torch.py``).
The restart, tolerance and cycle-count semantics are the JAX package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..fem.assemble import Operator, apply_bc_vector, gather_sum
from ..fem.spaces import TaylorHoodSpace
from ..utils import graphs, timing


def operator_diagonal(op: Operator) -> torch.Tensor:
    """Diagonal of the assembled operator (with identity BC rows)."""
    d = gather_sum(torch.diagonal(op.cell_mats, dim1=1, dim2=2), op.inc)
    if op.facet_mats is not None:
        d = d + gather_sum(torch.diagonal(op.facet_mats, dim1=1, dim2=2),
                           op.facet_inc)
    return d.index_fill(0, op.bc_dofs, 1.0)


def jacobi_preconditioner(op: Operator,
                          pressure_scale: Optional[torch.Tensor] = None
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Block-diagonal preconditioner: 1/diag on the velocity block and
    1/``pressure_scale`` (the lumped pressure mass, the Schur
    approximation) on the pressure block, whose raw diagonal is 0; without
    a scale, zero-diagonal rows fall back to identity."""
    d = operator_diagonal(op)
    nonzero = d.abs() > 1e-30
    inv = 1.0 / torch.where(nonzero, d, torch.ones_like(d))
    if pressure_scale is not None:
        inv[-pressure_scale.shape[0]:] = 1.0 / pressure_scale
    else:
        inv = torch.where(nonzero, inv, torch.ones_like(inv))
    return lambda x: inv * x


def pressure_mass_lumped(space: TaylorHoodSpace,
                         nu: float = 1.0) -> torch.Tensor:
    """Lumped P1 pressure mass diagonal scaled by 1/ν."""
    cell_mass = torch.einsum("q,qa->a", space.qw, space.phi1)
    vals = cell_mass[None, :] * space.cell_detj[:, None]
    return gather_sum(vals, space.inc_p1) / nu


class FGMRESResult(NamedTuple):
    x: torch.Tensor
    residual_norm: float
    iterations: int            # restart cycles
    converged: bool


def _lstsq64(H: torch.Tensor, beta: float) -> np.ndarray:
    """argmin ‖β e₁ − H y‖ in float64 on the host (SVD, rcond = eps·m)."""
    h = timing.to_host(H.detach()).astype(np.float64)
    e1 = np.zeros(h.shape[0])
    e1[0] = beta
    return np.linalg.lstsq(h, e1, rcond=None)[0]


def _arnoldi(matvec, M, V, Z, H, tiny: float, steps: int) -> None:
    """``steps`` Arnoldi steps from V[0] into V, Z (the preconditioned
    directions) and H, Gram–Schmidt as CGS2."""
    for j in range(steps):
        z = M(V[j])
        w = matvec(z)
        hs = V[: j + 1] @ w
        w = w - hs @ V[: j + 1]
        h2 = V[: j + 1] @ w            # second pass (CGS2)
        w = w - h2 @ V[: j + 1]
        hs = hs + h2
        hnew = torch.linalg.norm(w)
        V[j + 1] = w / hnew.clamp_min(tiny)
        H[: j + 1, j] = hs
        H[j + 1, j] = hnew
        Z[j] = z


class _CycleGraph:
    """One Arnoldi cycle captured as a CUDA graph on static V, Z, H, by
    ``capture`` (``utils/graphs.py::cached``). The graph reads the
    tensors that ``matvec`` and ``M`` read when it was captured."""

    def __init__(self, matvec, M, v0: torch.Tensor, restart: int, capture):
        n = v0.shape[0]
        self.V = v0.new_zeros((restart + 1, n))
        self.Z = v0.new_zeros((restart, n))
        self.H = v0.new_zeros((restart + 1, restart))
        tiny = torch.finfo(v0.dtype).tiny
        self.V[0] = v0
        (self.replay,) = capture(
            (lambda: _arnoldi(matvec, M, self.V, self.Z, self.H, tiny,
                              restart),),
            warm_up=lambda: _arnoldi(matvec, M, self.V, self.Z, self.H,
                                     tiny, 1))

    def run(self, v0: torch.Tensor):
        self.V[0] = v0
        self.replay()
        return self.V, self.Z, self.H


def fgmres(matvec: Callable[[torch.Tensor], torch.Tensor],
           b: torch.Tensor,
           M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
           x0: Optional[torch.Tensor] = None,
           restart: int = 60,
           max_restarts: int = 10,
           tol: float = 1e-10,
           graph: bool = False) -> FGMRESResult:
    """Right-preconditioned restarted flexible GMRES in ``b.dtype``.

    The JAX semantics: every cycle runs all ``restart`` Arnoldi steps
    (Gram–Schmidt, here CGS2; norms guarded by the dtype's ``tiny``), a
    cycle's update is kept only if it lowers the true residual, and the
    loop stops once ‖b − A x‖ ≤ tol·‖b‖ or after ``max_restarts`` cycles.
    ``iterations`` counts the cycles. ``graph`` replays the cycle as a
    CUDA graph where ``b`` is on a CUDA device (the module's notes). The
    call is the span ``fgmres`` with ``cycles``, ``arnoldi_steps``
    (cycles × restart) and ``dtype`` (its bits)."""
    if M is None:
        M = lambda v: v
    graph = graph and b.is_cuda
    with timing.span("fgmres") as span:
        x = torch.zeros_like(b) if x0 is None else x0
        tiny = torch.finfo(b.dtype).tiny
        target = tol * max(timing.to_host(torch.linalg.norm(b)), tiny)
        r = b - matvec(x)
        rnorm = timing.to_host(torch.linalg.norm(r))
        it = 0
        while rnorm > target and it < max_restarts:
            beta = torch.linalg.norm(r)
            v0 = r / beta.clamp_min(tiny)
            if graph:
                V, Z, H = graphs.cached(
                    "cycle", b.device, (matvec, M),
                    (b.shape[0], v0.dtype, restart),
                    lambda capture: _CycleGraph(matvec, M, v0, restart,
                                                capture)).run(v0)
            else:
                V = b.new_zeros((restart + 1, b.shape[0]))
                Z = b.new_zeros((restart, b.shape[0]))
                H = b.new_zeros((restart + 1, restart))
                V[0] = v0
                _arnoldi(matvec, M, V, Z, H, tiny, restart)
            y = torch.as_tensor(_lstsq64(H, timing.to_host(beta)),
                                dtype=b.dtype, device=b.device)
            x_new = x + y @ Z
            r_new = b - matvec(x_new)
            rnorm_new = timing.to_host(torch.linalg.norm(r_new))
            if rnorm_new < rnorm:
                x, r, rnorm = x_new, r_new, rnorm_new
            it += 1
        span.set(cycles=it, arnoldi_steps=it * restart,
                 dtype=torch.finfo(b.dtype).bits)
    return FGMRESResult(x, rnorm, it, rnorm <= target)


def solve_operator_krylov(op: Operator, b: torch.Tensor,
                          bc_vals: torch.Tensor,
                          space: Optional[TaylorHoodSpace] = None,
                          nu: float = 1.0,
                          tol: float = 1e-10,
                          restart: int = 80,
                          max_restarts: int = 30) -> FGMRESResult:
    """Krylov counterpart of the dense ``solve_operator``: float64 FGMRES
    on ``op.matvec64`` with the Jacobi / lumped-pressure-mass
    preconditioner."""
    b = apply_bc_vector(b, op.bc_dofs, bc_vals)
    pm = pressure_mass_lumped(space, nu) if space is not None else None
    M = jacobi_preconditioner(op, pm)
    return fgmres(op.matvec64, b, M=M, restart=restart,
                  max_restarts=max_restarts, tol=tol)
