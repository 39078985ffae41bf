"""Gen-1 solver classes (port of ``ocean_jax/gen1/solvers.py``): the
structured API of the reference's ``old_dolfinx_files``.

``NavierStokesSolver`` ↔ ``solver_classes/Navier_stokes_solver.py`` and
``ODESolver`` ↔ ``solver_classes/ODE_solver.py``, with the gen-1 method
names and call contracts of ``old_dolfinx_files/main.py``:

    w_r   = ns.solve_stokes_step(q)
    w     = ns.state_solving_step(q, u_r, i)
    x     = ode.ode_solving_step(u)
    lam_2 = ode.adjoint_ode_solving_step(u)
    w_adj, J, u_vals = ns.adjoint_state_solving_step(u, lam_2, x, h, u_d,
                                                     q, u_r)

Gen-1 semantics kept: the tanh-regularized backflow term with δ from the
config, the viscous adjoint, J = tracking + (α/2)∫|q|²ds with no α·K
rescaling, the implicit adjoint ODE (I − h∇uᵀ)λ_k = λ_{k+1} −
h∇uᵀ(u_d[k] − u(x_k)) with ∇u and u at x[k], Newton at rtol 1e-10. The
gen-2 implicit adjoint of ``ode/adjoint.py::solve_adjoint_ode_implicit``
is another recursion ((I + h∇uᵀ), u at x[k+1]), so it is not reused.

As in the JAX package, ∇u is the L2 projection onto P1 (gen-1
interpolated it nodally through dolfinx). The solvers live on one device
(default ``"cuda"``; ``device="cpu"`` runs on the host) and take and
return tensors there. ``fem.make_space`` and ``fem.make_boundary_quad``
default to the card too, so the JAX way, ``NavierStokesSolver(
make_space(mesh), make_boundary_quad(mesh, tags), ...)``, runs there;
on the host, pass ``device="cpu"`` to all three. Gen-1 runs no CUDA
kernel of the port (its ODE and point sources are the table paths, as
in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import control as ctrl_mod
from ..adjoint import point_source_rhs
from ..device import resolve_device
from ..fem import assemble
from ..fem.assemble import Operator, gather_sum
from ..fem.interpolate import eval_p1_tensor, eval_velocity
from ..fem.spaces import TaylorHoodSpace, BoundaryQuad
from ..ode import solve_primal_ode
from ..solve import newton_solve, solve_operator, GradProjector
from . import forms as g1


def _on_device(space: TaylorHoodSpace, device) -> torch.device:
    """The solver's device; the space must live there."""
    dev = resolve_device(device)
    if space.device.type != dev.type or (
            dev.index is not None and space.device.index != dev.index):
        raise ValueError(f"the space lives on {space.device}, the solver "
                         f"was asked for {dev}")
    return space.device


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=device)


class NavierStokesSolver:
    """Gen-1 Navier–Stokes solver over the port's assembly and solves."""

    def __init__(self, space: TaylorHoodSpace, bq: BoundaryQuad, bc_dofs,
                 bc_vals, viscosity: float = 1.0, alpha: float = 1e-2,
                 delta: float = 0.1, device="cuda"):
        self.device = _on_device(space, device)
        self.space = space
        self.bq = bq
        self.bc_dofs = bc_dofs
        self.bc_vals = bc_vals
        self.viscosity = viscosity
        self.alpha = alpha
        self.delta = delta            # ψ_δ regularization width

    # -- forms ------------------------------------------------------------
    def _residual(self, w, q_quad):
        space, bq = self.space, self.bq
        cell_r = vmap(lambda wl, ji, dj: g1.gen1_ns_cell_residual(
            space, wl, ji, dj, self.viscosity))(
                w[space.cell_dofs_mixed], space.cell_jinv, space.cell_detj)
        facet_r = vmap(lambda wl, ph, nrm, wt, qv: g1.gen1_ns_facet_residual(
            wl, ph, nrm, wt, qv, self.delta))(
                w[bq.dofs_mixed], bq.phi2, bq.normals, bq.weights, q_quad)
        return (gather_sum(cell_r, space.inc_mixed)
                + gather_sum(facet_r, bq.inc_mixed))

    def _operator(self, w):
        space, bq = self.space, self.bq
        cell_jac = vmap(jacfwd(lambda wl, ji, dj: g1.gen1_ns_cell_residual(
            space, wl, ji, dj, self.viscosity)))(
                w[space.cell_dofs_mixed], space.cell_jinv, space.cell_detj)
        facet_mats = vmap(jacfwd(
            lambda wl, ph, nrm, wt: g1.gen1_ns_facet_residual(
                wl, ph, nrm, wt, None, self.delta)))(
                    w[bq.dofs_mixed], bq.phi2, bq.normals, bq.weights)
        return Operator(cell_jac, space.cell_dofs_mixed, facet_mats,
                        bq.dofs_mixed, self.bc_dofs, space.ndof,
                        inc=space.inc_mixed, facet_inc=bq.inc_mixed)

    # -- gen-1 API ----------------------------------------------------------
    def state_solving_step(self, q: ctrl_mod.Control, u_r=None,
                           opt_step: int = 0) -> torch.Tensor:
        """Nonlinear NS Newton solve at rtol 1e-10; asserts convergence
        like the gen-1 ``assert``."""
        res = newton_solve(
            lambda w: self._residual(w, q.quad), self._operator,
            torch.zeros(self.space.ndof, dtype=torch.float64,
                        device=self.device),
            self.bc_dofs, self.bc_vals, rtol=1e-10)
        assert res.converged, "gen-1 Newton did not converge"
        return res.w

    def solve_stokes_step(self, q: ctrl_mod.Control) -> torch.Tensor:
        """Linear Stokes warm-up solve (gen-1 used BCGS+Jacobi; here the
        port's direct solve)."""
        space = self.space
        w0 = torch.zeros(space.ndof, dtype=torch.float64, device=self.device)
        op = assemble.ns_operator(space, None, w0, self.viscosity,
                                  self.bc_dofs, convection=False)
        b = assemble.boundary_load(space, self.bq, q.quad)
        return solve_operator(op, b, self.bc_vals)

    def adjoint_state_solving_step(self, u, lam_2, x, h, u_d,
                                   q: ctrl_mod.Control, u_r=None):
        """Adjoint solve with point sources γ = h(u_d − u(x) + λ₂) at
        center (0.5, 0.5). Returns (w_adj, J, u_vals); J uses α/2 with no
        K rescaling."""
        space, bq, dev = self.space, self.bq, self.device
        u, lam_2 = _f64(u, dev), _f64(lam_2, dev)
        x, u_d = _f64(x, dev), _f64(u_d, dev)
        K = x.shape[0]
        w_bg = torch.cat([u.reshape(-1),
                          u.new_zeros(space.n_p1)])
        wl = w_bg[space.cell_dofs_mixed]
        cell_jac = vmap(jacfwd(
            lambda zl, wl_, ji, dj: g1.gen1_adjoint_cell_residual(
                space, zl, wl_, ji, dj, self.viscosity)))(
                    torch.zeros_like(wl), wl, space.cell_jinv,
                    space.cell_detj)
        wf = w_bg[bq.dofs_mixed]
        facet_mats = vmap(jacfwd(
            lambda zl, wl_, ph, nrm, wt: g1.gen1_adjoint_facet_residual(
                zl, wl_, ph, nrm, wt, self.delta)))(
                    torch.zeros_like(wf), wf, bq.phi2, bq.normals,
                    bq.weights)
        op = Operator(cell_jac, space.cell_dofs_mixed, facet_mats,
                      bq.dofs_mixed, self.bc_dofs, space.ndof,
                      inc=space.inc_mixed, facet_inc=bq.inc_mixed)

        center = torch.tensor([0.5, 0.5], dtype=torch.float64, device=dev)
        b = point_source_rhs(space, u, x, lam_2, u_d,
                             torch.zeros(K, dtype=torch.bool, device=dev),
                             h, center)
        w_adj = solve_operator(op, b, self.bc_vals)

        u_vals, _ = eval_velocity(space, u, x)
        part_a = 0.5 * float(torch.sum(
            h * torch.sum((u_vals - u_d) ** 2, dim=-1)))
        e = float(ctrl_mod.boundary_l2_sq(bq, q))
        J = part_a + 0.5 * self.alpha * e
        return w_adj, J, u_vals


class ODESolver:
    """Gen-1 buoy ODE (``solver_classes/ODE_solver.py``)."""

    def __init__(self, space: TaylorHoodSpace, K: int, t0=0.0, T=1.0,
                 dt=0.005, center=(0.5, 0.5), device="cuda"):
        self.device = dev = _on_device(space, device)
        self.space = space
        self.K = K
        self.h = dt
        self.nt = int(T / dt)
        self.time_interval = np.linspace(t0, T, self.nt)
        self.center = _f64(center, dev)
        # gen-1 measurement synthesis
        ud1 = 0.5 * (np.cos(np.pi * (self.time_interval - 0.5)) - 1
                     - np.cos(np.pi))
        u_d = np.zeros((K, self.nt, 2))
        u_d[:, :, 0] = ud1
        self.u_d = _f64(u_d, dev)
        # seeds
        self.x0 = _f64(np.stack([np.full(K, 0.2), np.linspace(0.2, 0.9, K)],
                                axis=1), dev)
        self.projector = GradProjector.build(space)
        self.x = None

    def ode_solving_step(self, u) -> torch.Tensor:
        """Explicit Euler. Gen-1 exits on a failed point location; this
        raises instead."""
        ode = solve_primal_ode(self.space, _f64(u, self.device), self.x0,
                               self.h, self.nt, self.center)
        if bool(ode.mask.any()):
            raise RuntimeError("no colliding cells (buoy left the domain)")
        self.x = ode.x
        return ode.x

    def adjoint_ode_solving_step(self, u) -> torch.Tensor:
        """The implicit recursion (I − h∇uᵀ)λ_k = λ_{k+1} −
        h∇uᵀ(u_d[k] − u(x_k)) for k = nt−2 … 0, ∇u and u at x[k]
        (clamped evaluation), the 2×2 system by its explicit inverse;
        λ[nt−1] = 0. Returns λ (K, nt, 2)."""
        assert self.x is not None, "run ode_solving_step first"
        u = _f64(u, self.device)
        grad_u = self.projector.project(self.space, u)
        x, h, nt = self.x, self.h, self.nt
        g_all, _ = eval_p1_tensor(self.space, grad_u, x[:, :nt - 1])
        uv_all, _ = eval_velocity(self.space, u, x[:, :nt - 1])
        lam = x.new_zeros(self.K, nt, 2)
        l0, l1 = x.new_zeros(self.K), x.new_zeros(self.K)
        for k in range(nt - 2, -1, -1):
            g = g_all[:, k]
            r = self.u_d[:, k] - uv_all[:, k]
            # a = I − h gᵀ and rhs = λ_{k+1} − (h gᵀ) r
            a00, a01 = 1.0 - h * g[:, 0, 0], -(h * g[:, 1, 0])
            a10, a11 = -(h * g[:, 0, 1]), 1.0 - h * g[:, 1, 1]
            b0 = l0 - (h * g[:, 0, 0] * r[:, 0] + h * g[:, 1, 0] * r[:, 1])
            b1 = l1 - (h * g[:, 0, 1] * r[:, 0] + h * g[:, 1, 1] * r[:, 1])
            det = a00 * a11 - a01 * a10
            l0, l1 = ((a11 / det) * b0 + (-a01 / det) * b1,
                      (-a10 / det) * b0 + (a00 / det) * b1)
            lam[:, k, 0] = l0
            lam[:, k, 1] = l1
        return lam
