"""The optimal-control iteration in plain PyTorch: forward solve, cost,
adjoint, reduced gradient and one Armijo step, written from the
equations and the reference program's rules alone.

    J(f) = ½ Σ_k Σ_t h |u(x_k(t)) − u_d,k(t)|² + ½ α ∫_Γ₁ |f|² ds
    g    = α f − z|_Γ₁               (z the adjoint velocity)
    f   ← f − lr g, lr from lr_in halved until
          J(f) − J(f − lr g) ≥ lr · c · ∫_Γ₁ |g|² ds

The control lives at the Γ₁ quadrature points (4 Gauss points a facet).
Below ν = 1 a configuration may give ``continuation``, the number of
rungs of a ν-ladder that each forward solve climbs down before the solve
at ν (``Reference.viscosities``).
``dtype`` sets the precision of everything; float32 makes the control of
the comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fem, mesh as mesh_mod, ode


class Reference:
    def __init__(self, cfg: dict, x0: np.ndarray, u_d: np.ndarray, device,
                 dtype=torch.float64):
        self.cfg = cfg
        m = mesh_mod.build(cfg["domain"], cfg["resolution"])
        self.sp = sp = fem.make_space(m, device, dtype)
        self.dtype, self.device = dtype, device
        self.nu = float(cfg["viscosity"])
        self.h = float(cfg["dt"])
        self.nt = int(round(cfg["T"] / cfg["dt"]))
        self.alpha = float(cfg["alpha"]) * int(cfg["alpha_buoys"])
        self.x0 = torch.as_tensor(x0, dtype=dtype, device=device)
        self.u_d = torch.as_tensor(u_d, dtype=dtype, device=device)
        self.center = torch.as_tensor(mesh_mod.center(cfg["domain"]),
                                      dtype=dtype, device=device)
        self.bc_vals = torch.zeros(sp.bc.shape[0], dtype=dtype, device=device)
        self.mass = fem.Solver(fem.p1_mass(sp))

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    def initial_control(self) -> torch.Tensor:
        x = self.sp.f_x
        c = self.cfg["initial_control"]
        if c == "taylor_green":
            pi = math.pi
            return torch.stack(
                [-torch.cos(pi * x[..., 0]) * torch.sin(pi * x[..., 1]),
                 torch.sin(pi * x[..., 0]) * torch.cos(pi * x[..., 1])], -1)
        return torch.zeros_like(x) + self.tensor(c)

    def viscosities(self) -> list:
        """The ν of each Newton solve of a forward pass. With the
        configuration's ``continuation`` = n > 0 and ν < 1: the ladder
        ν_k = r^k for k = 0..n, r = ν^(1/(n+1)), then ν itself."""
        n = int(self.cfg.get("continuation", 0))
        if n <= 0 or self.nu >= 1.0:
            return [self.nu]
        r = self.nu ** (1.0 / (n + 1))
        return [r ** k for k in range(n + 1)] + [self.nu]

    def forward(self, f_quad: torch.Tensor) -> dict:
        sp = self.sp
        w = torch.zeros(sp.ndof, dtype=self.dtype, device=self.device)
        ladder = self.viscosities()
        # a ladder's solves are full Newtons of at most 50 steps that take
        # every step, each from the last one's state
        extra = ({} if len(ladder) == 1
                 else dict(max_iter=50, stop_on_rise=False))
        its = 0
        for nu in ladder:
            w, n, rel = fem.newton(
                sp, lambda w, nu=nu: fem.ns_residual(sp, w, f_quad, nu),
                lambda w, nu=nu: fem.ns_jacobian(sp, w, nu, sp.bc),
                w, sp.bc, self.bc_vals, **extra)
            its += n
        u, _ = sp.split(w)
        x, uv, mask = ode.primal(sp, u, self.x0, self.h, self.nt,
                                 self.center)
        return dict(w=w, x=x, u_values=uv, mask=mask, newton_iters=its,
                    newton_rel=rel)

    def cost(self, u_values: torch.Tensor, f_quad: torch.Tensor):
        track = 0.5 * torch.sum(self.h * (u_values - self.u_d) ** 2)
        reg = 0.5 * self.alpha * torch.sum(self.sp.f_w[..., None] * f_quad ** 2)
        return track + reg

    def gradient(self, f_quad: torch.Tensor, fwd: dict) -> dict:
        sp = self.sp
        u, _ = sp.split(fwd["w"])
        grad_u = fem.project_grad(sp, u, self.mass)
        mu = ode.costate(sp, grad_u, fwd["x"], fwd["u_values"], self.u_d,
                         fwd["mask"], self.h)
        b = ode.point_sources(sp, u, fwd["x"], mu, self.u_d, fwd["mask"],
                              self.h, self.center)
        rhs = b.index_copy(0, sp.bc, self.bc_vals)
        z = fem.Solver(fem.adjoint_operator(sp, fwd["w"], sp.bc))(rhs)
        zu, _ = sp.split(z)
        g = self.alpha * f_quad - fem.facet_values(sp, zu)
        return dict(grad_u=grad_u, mu=mu, b=b, z=z, g=g)

    def iteration(self, f_quad: torch.Tensor, lr: float) -> dict:
        """One iteration of the GD loop from control ``f_quad`` with the
        learning rate carried in: the forward state, the adjoint stages,
        the accepted step and the new control."""
        cfg = self.cfg
        fwd = self.forward(f_quad)
        out = dict(fwd)
        out.update(self.gradient(f_quad, fwd))
        g = out["g"]
        j_old = float(self.cost(fwd["u_values"], f_quad))
        gradj = -float(torch.sum(self.sp.f_w[..., None] * g * g))
        cond = -cfg["c_armijo"] * gradj
        probes = 0
        while True:
            probes += 1
            f_c = f_quad + (-lr) * g
            j_new = float(self.cost(self.forward(f_c)["u_values"], f_c))
            if j_old - j_new >= lr * cond:
                break
            new_lr = max(cfg["tau"] * lr, cfg["LR_MIN"])
            if new_lr == lr:
                break
            lr = new_lr
            if probes >= cfg["max_line_search_iters"]:
                break
        out.update(lr=lr, probes=probes, f_new=f_c, J_old=j_old,
                   J=float(self.cost(fwd["u_values"], f_c)))
        return out


def dirichlet_flow(resolution: int, nu: float, inflow, device,
                   dtype=torch.float64) -> tuple:
    """The Dirichlet-driven NS flow on [0,2]² that makes the square's
    measurements: no slip on y = 0 and y = 2, the inflow on x = 0 and
    x = 2 (it wins at the corners), the pressure pinned to 0 along
    x = 0, no Γ₁ terms. Returns (space, w)."""
    m = mesh_mod.build("square", resolution)
    sp = fem.make_space(m, device, dtype)
    eps = mesh_mod.EPS
    walls = fem.velocity_dofs(m, mesh_mod.facets_where(
        m, lambda x: (np.abs(x[:, 1]) < eps) | (np.abs(x[:, 1] - 2) < eps)))
    ends = fem.velocity_dofs(m, mesh_mod.facets_where(
        m, lambda x: (np.abs(x[:, 0]) < eps) | (np.abs(x[:, 0] - 2) < eps)))
    left = mesh_mod.facets_where(m, lambda x: x[:, 0] < eps)
    pres = 2 * sp.n_p2 + np.unique(m.bf_vertices[left].reshape(-1))
    vals = {int(d): 0.0 for d in walls}
    vals.update({int(d): float(inflow[d % 2]) for d in ends})
    vals.update({int(d): 0.0 for d in pres})
    dofs = np.array(sorted(vals))
    bc = torch.as_tensor(dofs, device=device)
    bc_vals = torch.as_tensor([vals[d] for d in dofs], dtype=dtype,
                              device=device)
    w, _, _ = fem.newton(
        sp, lambda w: fem.ns_residual(sp, w, None, nu, gamma1=False),
        lambda w: fem.ns_jacobian(sp, w, nu, bc, gamma1=False),
        torch.zeros(sp.ndof, dtype=dtype, device=device), bc, bc_vals)
    return sp, w
