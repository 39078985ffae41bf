"""Taylor–Hood (P2 velocity, P1 pressure) finite elements in plain PyTorch.

Dense assembly of the forms the system solves, each element matrix
written out by hand (the system under test differentiates its element
residuals instead):

  primal  (ν ∇u:∇v + (∇u u)·v + div(u) q + div(v) p) dx
          − ½ (u·n)(u·v) ds(Γ₁) − f·v ds(Γ₁)
  adjoint (∇z:∇v + (∇u v)·z + (∇v u)·z + div(z) q + div(v) r) dx
          − ½ [(u·n)(v·z) + (v·n)(u·z)] ds(Γ₁)

Dof numbering: P2 scalar dof s is vertex s, then edge s − nv; the mixed
vector holds velocity component c of s at 2s + c and the pressure at
vertex v at 2·n_p2 + v. Every table is made in ``dtype`` (float64 for
the reference, float32 for the lower-precision control).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import mesh as mesh_mod

# Dunavant's symmetric 12-point rule on the reference triangle (degree 6)
_D6 = ((0.873821971016996, 0.063089014491502, 0.050844906370207),
       (0.501426509658179, 0.249286745170910, 0.116786275726379))
_D6_PERM = (0.636502499121399, 0.310352451033785, 0.053145049844816,
            0.082851075618374)


def triangle_rule():
    bary, wts = [], []
    for a, b, w in _D6:
        bary += [(a, b, b), (b, a, b), (b, b, a)]
        wts += [w] * 3
    a, b, c, w = _D6_PERM
    for p in ((a, b, c), (a, c, b), (b, a, c), (c, a, b), (b, c, a),
              (c, b, a)):
        bary.append(p)
        wts.append(w)
    return np.array(bary)[:, 1:], 0.5 * np.array(wts)


def p1(xi):
    x, y = xi[..., 0], xi[..., 1]
    return np.stack([1 - x - y, x, y], axis=-1)


def p2(xi):
    """P2 basis: vertices 0–2, then the midpoints of the edges opposite
    vertices 0, 1, 2."""
    l0, l1, l2 = np.moveaxis(p1(xi), -1, 0)
    return np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                     4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1], axis=-1)


_G1 = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def p2_grad(xi):
    lam = p1(xi)
    g = [(4 * lam[..., a] - 1)[..., None] * _G1[a] for a in range(3)]
    for i, j in ((1, 2), (0, 2), (0, 1)):
        g.append(4 * (lam[..., i, None] * _G1[j] + lam[..., j, None] * _G1[i]))
    return np.stack(g, axis=-2)


def p2_torch(xi: torch.Tensor) -> torch.Tensor:
    x, y = xi[..., 0], xi[..., 1]
    l0 = 1 - x - y
    return torch.stack([l0 * (2 * l0 - 1), x * (2 * x - 1), y * (2 * y - 1),
                        4 * x * y, 4 * l0 * y, 4 * l0 * x], dim=-1)


def p1_torch(xi: torch.Tensor) -> torch.Tensor:
    x, y = xi[..., 0], xi[..., 1]
    return torch.stack([1 - x - y, x, y], dim=-1)


@dataclasses.dataclass(frozen=True)
class Space:
    mesh: mesh_mod.Mesh
    n_p2: int
    n_p1: int
    dofs2: torch.Tensor      # (nc, 6)
    dofs1: torch.Tensor      # (nc, 3)
    mixed: torch.Tensor      # (nc, 15): 2a + i velocity, 12 + m pressure
    W: torch.Tensor          # (nc, nq) quadrature weight × |det J|
    G: torch.Tensor          # (nc, nq, 6, 2) physical P2 gradients
    P2: torch.Tensor         # (nq, 6)
    P1: torch.Tensor         # (nq, 3)
    jinv: torch.Tensor       # (nc, 2, 2)
    v0: torch.Tensor         # (nc, 2) first vertex
    s2c: torch.Tensor        # (n, n, 2)
    # Γ₁ quadrature: owning cell, P2 values, normals, weights, points
    f_cells: torch.Tensor    # (nf,)
    f_P2: torch.Tensor       # (nf, 4, 6)
    f_n: torch.Tensor        # (nf, 2)
    f_w: torch.Tensor        # (nf, 4)
    f_x: torch.Tensor        # (nf, 4, 2)
    bc: torch.Tensor         # Γ₂ velocity dofs (mixed numbering)

    @property
    def ndof(self) -> int:
        return 2 * self.n_p2 + self.n_p1

    @property
    def dtype(self):
        return self.W.dtype

    def split(self, w):
        return w[: 2 * self.n_p2].reshape(-1, 2), w[2 * self.n_p2:]


def velocity_dofs(m: mesh_mod.Mesh, facets: np.ndarray) -> np.ndarray:
    """Mixed velocity dofs of the P2 nodes on the given boundary facets."""
    edge = m.cell_edges[m.bf_cells[facets], m.bf_local[facets]]
    s = np.unique(np.concatenate([m.bf_vertices[facets].reshape(-1),
                                  m.vertices.shape[0] + edge]))
    return np.concatenate([2 * s, 2 * s + 1])


def make_space(m: mesh_mod.Mesh, device, dtype=torch.float64) -> Space:
    nv = m.vertices.shape[0]
    dofs2 = np.concatenate([m.cells, nv + m.cell_edges], axis=1)
    n_p2 = nv + m.edges.shape[0]
    mixed = np.empty((m.cells.shape[0], 15), dtype=np.int64)
    mixed[:, 0:12:2] = 2 * dofs2
    mixed[:, 1:12:2] = 2 * dofs2 + 1
    mixed[:, 12:] = 2 * n_p2 + m.cells
    v = m.vertices[m.cells]
    jac = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    jinv = np.linalg.inv(jac)
    qp, qw = triangle_rule()
    G = np.einsum("qad,cdi->cqai", p2_grad(qp), jinv)
    W = np.abs(np.linalg.det(jac))[:, None] * qw[None, :]

    sel = mesh_mod.facets_where(m, mesh_mod.gamma1(m.domain))
    fc = m.bf_cells[sel]
    a = m.vertices[m.bf_vertices[sel, 0]]
    b = m.vertices[m.bf_vertices[sel, 1]]
    gx, gw = np.polynomial.legendre.leggauss(4)
    gx, gw = 0.5 * (gx + 1), 0.5 * gw
    pts = a[:, None] + gx[None, :, None] * (b - a)[:, None]
    xi = np.einsum("fij,fqj->fqi", jinv[fc], pts - v[fc][:, None, 0])
    bc = velocity_dofs(m, mesh_mod.facets_where(m, mesh_mod.gamma2(m.domain)))

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    i64 = torch.int64
    return Space(m, n_p2, nv, t(dofs2, i64), t(m.cells, i64), t(mixed, i64),
                 t(W), t(G), t(p2(qp)), t(p1(qp)), t(jinv), t(v[:, 0]),
                 t(m.square_to_cell, i64), t(fc, i64), t(p2(xi)),
                 t(m.bf_normals[sel]),
                 t(np.linalg.norm(b - a, axis=1)[:, None] * gw[None, :]),
                 t(pts), t(bc, i64))


# ---------------------------------------------------------------------------
# fields at quadrature points
# ---------------------------------------------------------------------------

def cell_fields(sp: Space, u: torch.Tensor):
    """u at the quadrature points (nc, nq, 2) and ∇u (nc, nq, 2, 2) with
    [i, j] = ∂u_i/∂x_j."""
    ul = u[sp.dofs2]
    return (torch.einsum("qa,cai->cqi", sp.P2, ul),
            torch.einsum("cai,cqaj->cqij", ul, sp.G))


def facet_values(sp: Space, u: torch.Tensor) -> torch.Tensor:
    """A P2 velocity at the Γ₁ quadrature points (nf, 4, 2)."""
    return torch.einsum("fqa,fai->fqi", sp.f_P2, u[sp.dofs2[sp.f_cells]])


# ---------------------------------------------------------------------------
# primal residual, Jacobian, adjoint operator
# ---------------------------------------------------------------------------

def ns_residual(sp: Space, w: torch.Tensor, f_quad: Optional[torch.Tensor],
                nu: float, gamma1: bool = True) -> torch.Tensor:
    """The NS residual without Dirichlet rows; ``gamma1=False`` drops the
    Γ₁ terms (the Dirichlet-driven flow of the measurements)."""
    u, p = sp.split(w)
    uq, gu = cell_fields(sp, u)
    pq = torch.einsum("qm,cm->cq", sp.P1, p[sp.dofs1])
    conv = torch.einsum("cqij,cqj->cqi", gu, uq)
    rv = (nu * torch.einsum("cq,cqij,cqaj->cai", sp.W, gu, sp.G)
          + torch.einsum("cq,cq,cqai->cai", sp.W, pq, sp.G)
          + torch.einsum("cq,cqi,qa->cai", sp.W, conv, sp.P2))
    div = gu[..., 0, 0] + gu[..., 1, 1]
    rp = torch.einsum("cq,cq,qm->cm", sp.W, div, sp.P1)
    r = torch.zeros(sp.ndof, dtype=w.dtype, device=w.device)
    r.index_add_(0, sp.mixed[:, :12].reshape(-1), rv.reshape(-1))
    r.index_add_(0, sp.mixed[:, 12:].reshape(-1), rp.reshape(-1))
    if gamma1:
        uf = facet_values(sp, u)
        un = torch.einsum("fqi,fi->fq", uf, sp.f_n)
        fv = -0.5 * torch.einsum("fq,fq,fqi,fqa->fai", sp.f_w, un, uf,
                                 sp.f_P2)
        if f_quad is not None:
            fv = fv - torch.einsum("fq,fqi,fqa->fai", sp.f_w, f_quad, sp.f_P2)
        r.index_add_(0, sp.mixed[sp.f_cells, :12].reshape(-1), fv.reshape(-1))
    return r


def _eye2(like):
    return torch.eye(2, dtype=like.dtype, device=like.device)


def _velocity_block(scalar, full):
    """(c, a, i, b, k) from a component-blind (c, a, b) part and a full
    (c, a, i, b, k) part."""
    return scalar[:, :, None, :, None] * _eye2(scalar)[None, None, :, None,
                                                       :] + full


def _dense(sp: Space, vv, facet_vv, bc: torch.Tensor) -> torch.Tensor:
    """Dense operator from velocity blocks (c, 6, 2, 6, 2) of cells and
    (f, 6, 2, 6, 2) of Γ₁ facets plus the pressure coupling, Dirichlet
    rows made identity rows."""
    nc = sp.dofs2.shape[0]
    B = torch.einsum("cq,qm,cqai->caim", sp.W, sp.P1, sp.G)   # (c, 6, 2, 3)
    E = torch.zeros(nc, 15, 15, dtype=sp.dtype, device=sp.W.device)
    E[:, :12, :12] = vv.reshape(nc, 12, 12)
    E[:, :12, 12:] = B.reshape(nc, 12, 3)
    E[:, 12:, :12] = B.reshape(nc, 12, 3).transpose(1, 2)
    n = sp.ndof
    A = torch.zeros(n * n, dtype=sp.dtype, device=sp.W.device)
    idx = sp.mixed[:, :, None] * n + sp.mixed[:, None, :]
    A.index_add_(0, idx.reshape(-1), E.reshape(-1))
    fd = sp.mixed[sp.f_cells, :12]
    fidx = fd[:, :, None] * n + fd[:, None, :]
    A.index_add_(0, fidx.reshape(-1), facet_vv.reshape(-1))
    A = A.reshape(n, n)
    A[bc, :] = 0.0
    A[bc, bc] = 1.0
    return A


def ns_jacobian(sp: Space, w: torch.Tensor, nu: float, bc: torch.Tensor,
                gamma1: bool = True) -> torch.Tensor:
    u, _ = sp.split(w)
    uq, gu = cell_fields(sp, u)
    lap = torch.einsum("cq,cqaj,cqbj->cab", sp.W, sp.G, sp.G)
    adv = torch.einsum("cq,qa,cqbj,cqj->cab", sp.W, sp.P2, sp.G, uq)
    react = torch.einsum("cq,qa,qb,cqik->caibk", sp.W, sp.P2, sp.P2, gu)
    vv = _velocity_block(nu * lap + adv, react)
    nf = sp.f_cells.shape[0]
    if gamma1:
        uf = facet_values(sp, u)
        un = torch.einsum("fqi,fi->fq", uf, sp.f_n)
        fvv = -0.5 * _velocity_block(
            torch.einsum("fq,fq,fqa,fqb->fab", sp.f_w, un, sp.f_P2, sp.f_P2),
            torch.einsum("fq,fqa,fqb,fk,fqi->faibk", sp.f_w, sp.f_P2,
                         sp.f_P2, sp.f_n, uf))
    else:
        fvv = torch.zeros(nf, 6, 2, 6, 2, dtype=sp.dtype, device=w.device)
    return _dense(sp, vv, fvv, bc)


def adjoint_operator(sp: Space, w: torch.Tensor, bc: torch.Tensor):
    """The adjoint form at the primal state w (unit viscosity in its
    Laplacian, as the reference writes it)."""
    u, _ = sp.split(w)
    uq, gu = cell_fields(sp, u)
    lap = torch.einsum("cq,cqaj,cqbj->cab", sp.W, sp.G, sp.G)
    adv = torch.einsum("cq,cqai,cqi,qb->cab", sp.W, sp.G, uq, sp.P2)
    react = torch.einsum("cq,qa,qb,cqkj->cajbk", sp.W, sp.P2, sp.P2, gu)
    vv = _velocity_block(lap + adv, react)
    uf = facet_values(sp, u)
    un = torch.einsum("fqi,fi->fq", uf, sp.f_n)
    fvv = -0.5 * _velocity_block(
        torch.einsum("fq,fq,fqa,fqb->fab", sp.f_w, un, sp.f_P2, sp.f_P2),
        torch.einsum("fq,fqa,fqb,fqk,fi->faibk", sp.f_w, sp.f_P2, sp.f_P2,
                     uf, sp.f_n))
    return _dense(sp, vv, fvv, bc)


# ---------------------------------------------------------------------------
# P1 mass and the L2 projection of ∇u
# ---------------------------------------------------------------------------

def p1_mass(sp: Space) -> torch.Tensor:
    M = torch.einsum("cq,qa,qb->cab", sp.W, sp.P1, sp.P1)
    n = sp.n_p1
    A = torch.zeros(n * n, dtype=sp.dtype, device=sp.W.device)
    idx = sp.dofs1[:, :, None] * n + sp.dofs1[:, None, :]
    A.index_add_(0, idx.reshape(-1), M.reshape(-1))
    return A.reshape(n, n)


def project_grad(sp: Space, u: torch.Tensor, mass_solve) -> torch.Tensor:
    """Nodal P1 values (n_p1, 2, 2) of the L2 projection of ∇u."""
    _, gu = cell_fields(sp, u)
    rhs = torch.einsum("cq,qm,cqij->cmij", sp.W, sp.P1, gu)
    b = torch.zeros(sp.n_p1, 4, dtype=sp.dtype, device=u.device)
    b.index_add_(0, sp.dofs1.reshape(-1), rhs.reshape(-1, 4))
    return mass_solve(b).reshape(sp.n_p1, 2, 2)


# ---------------------------------------------------------------------------
# dense solves
# ---------------------------------------------------------------------------

class Solver:
    """LU factors of a dense matrix with two sweeps of iterative
    refinement in the matrix's own precision."""

    def __init__(self, A: torch.Tensor):
        self.A = A
        self.lu, self.piv, _ = torch.linalg.lu_factor_ex(A)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        vec = b.dim() == 1
        b2 = b[:, None] if vec else b
        x = torch.linalg.lu_solve(self.lu, self.piv, b2)
        for _ in range(2):
            x = x + torch.linalg.lu_solve(self.lu, self.piv, b2 - self.A @ x)
        return x[:, 0] if vec else x


def newton(sp: Space, residual, jacobian, w0: torch.Tensor,
           bc: torch.Tensor, bc_vals: torch.Tensor, max_iter: int = 30,
           stop_on_rise: bool = True):
    """Full Newton with identity Dirichlet rows, a fresh factorization
    every step, carried until the residual stops falling by half a step
    (the precision's floor) or is 1e-14 of the first. With
    ``stop_on_rise`` a step that raises the residual ends the solve and
    is not taken; without it every step is taken (the rungs of a
    ν-continuation, which may climb before they fall)."""
    is_bc = torch.zeros(sp.ndof, dtype=torch.bool, device=w0.device)
    is_bc[bc] = True
    g = torch.zeros_like(w0).index_copy(0, bc, bc_vals)

    def res(w):
        return torch.where(is_bc, w - g, residual(w))

    w = w0
    r = res(w)
    r0 = float(torch.linalg.norm(r))
    rn, it = r0, 0
    while it < max_iter and rn > 1e-14 * r0:
        w_new = w + Solver(jacobian(w))(-r)
        r_new = res(w_new)
        rn_new = float(torch.linalg.norm(r_new))
        it += 1
        if stop_on_rise and not rn_new < rn:
            break
        stalled = rn_new > 0.5 * rn and rn < 1e-6 * r0
        w, r, rn = w_new, r_new, rn_new
        if stalled:
            break
    return w, it, rn / max(r0, 1e-300)
