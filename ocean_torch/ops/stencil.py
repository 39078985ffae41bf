"""Offset-stencil operator application on structured grids (port of
``ocean_jax/ops/stencil.py``).

Every P2/P1 dof of the structured triangulations sits on a half-grid
node, so an assembled operator is a position-dependent stencil: an entry
couples two dofs whose half-grid nodes differ by one of at most 25 fixed
offsets in [-2, 2]². The operator is stored as a coefficient image

    S[node, c, k]     k = o·C + c'   (offset o, row channel c, column c')

and applied as ONE gather of the 25 shifted windows of x through a
precomputed index table followed by ONE batched contraction:

    y[node, c] = Σ_k S[node, c, k] · x[G[node, k]]

with G[node, o·C + c'] the dof of channel c' at ``node + off_o`` (or a
zero slot where there is none). The coefficients are rebuilt per
operator from its element matrices by one sorted segment sum over
host-built permutation tables (deterministic: no atomics).

Channels: C = 3 for mixed operators (u_x, u_y, p; pressure dofs sit on
the even-even vertex nodes), C = 2 for velocity blocks. Dirichlet rows
are identity, as in ``Operator.matvec64``. Works on every structured
domain (square, L-shape staircase, pipe, graded tensor grids): nodes
without a dof are dead lanes, written and never read back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem.assemble import Operator
from ..fem.spaces import TaylorHoodSpace, BoundaryQuad


def _halfgrid_indices(space: TaylorHoodSpace):
    """(gx, gy) half-grid index of every scalar P2 dof, and the half-grid
    dimensions (the node map of ``ode/grideval.py``)."""
    loc = space.locator
    nx, ny = loc.grid_shape
    Hx, Hy = 2 * nx + 1, 2 * ny + 1
    coords = space.dof_coords_p2.cpu().numpy()
    if loc.uniform:
        x0, y0 = loc.origin
        hx, hy = loc.spacing
        gx = np.rint((coords[:, 0] - x0) / (0.5 * hx)).astype(np.int64)
        gy = np.rint((coords[:, 1] - y0) / (0.5 * hy)).astype(np.int64)
    else:
        def nearest(lines, p, n_half):
            half = np.empty(n_half)
            half[0::2] = lines
            half[1::2] = 0.5 * (lines[:-1] + lines[1:])
            g = np.clip(np.searchsorted(half, p), 1, n_half - 1)
            return np.where(p - half[g - 1] < half[g] - p, g - 1, g)
        gx = nearest(loc.xs_lines.cpu().numpy(), coords[:, 0], Hx)
        gy = nearest(loc.ys_lines.cpu().numpy(), coords[:, 1], Hy)
    if gx.min() < 0 or gx.max() >= Hx or gy.min() < 0 or gy.max() >= Hy:
        raise ValueError("a P2 dof lies off the half grid")
    return gx, gy, Hx, Hy


@dataclasses.dataclass(frozen=True)
class StencilTables:
    """Host-built index tables turning one (cell_dofs, facet_dofs)
    topology into stencil form; constant for a space and boundary."""

    perm: torch.Tensor       # (E,) sort order of the element entries
    lengths: torch.Tensor    # (M,) entries of each occupied coefficient
    slots: torch.Tensor      # (M,) flat coefficient index of each
    gather: torch.Tensor     # (H, n_off·C) dof feeding each window lane
                             #   (ndof: a dead lane, reads an appended 0)
    out_map: torch.Tensor    # (ndof,) flat (node, channel) of each dof
    offsets: tuple           # ((dy, dx), ...) of the n_off offsets
    C: int                   # channels (3 mixed / 2 velocity)
    Hy: int
    Hx: int
    ndof: int

    @property
    def n_off(self) -> int:
        return len(self.offsets)

    @property
    def s_shape(self):
        return (self.Hy * self.Hx, self.C, self.n_off * self.C)

    @property
    def s_size(self) -> int:
        """Coefficients of the stencil image, n_off·C²·Hy·Hx."""
        return self.n_off * self.C * self.C * self.Hy * self.Hx


def build_stencil_tables(space: TaylorHoodSpace,
                         bq: Optional[BoundaryQuad],
                         block: str = "mixed") -> StencilTables:
    """Tables for the mixed operator (``block="mixed"``) or its velocity
    block (``block="vel"``, the multigrid smoother's operand). Raises
    ``ValueError`` where a dof is off the half grid or an entry couples
    dofs beyond the 5×5 stencil."""
    gx, gy, Hx, Hy = _halfgrid_indices(space)
    H = Hy * Hx
    n_p2, n_p1 = space.n_p2, space.n_p1
    node_p2 = gy * Hx + gx
    cd = space.cell_dofs_mixed.cpu().numpy()
    if block == "mixed":
        C, ndof = 3, space.ndof
        dof_node = np.concatenate([np.repeat(node_p2, 2), node_p2[:n_p1]])
        dof_chan = np.concatenate([np.tile([0, 1], n_p2),
                                   np.full(n_p1, 2)])
    elif block == "vel":
        C, ndof = 2, 2 * n_p2
        dof_node = np.repeat(node_p2, 2)
        dof_chan = np.tile([0, 1], n_p2)
        cd = cd[:, :12]
    else:
        raise ValueError(block)

    entry_dofs = [cd]
    if bq is not None:
        entry_dofs.append(cd[bq.cells.cpu().numpy()])
    node_y, node_x = dof_node // Hx, dof_node % Hx
    off_index = np.full((5, 5), -1, dtype=np.int64)
    offsets = []
    parts = []
    for dofs in entry_dofs:
        rows, cols = dofs[:, :, None], dofs[:, None, :]
        dyv = node_y[cols] - node_y[rows]
        dxv = node_x[cols] - node_x[rows]
        if np.abs(dyv).max() > 2 or np.abs(dxv).max() > 2:
            raise ValueError("operator couples dofs beyond the 5×5 stencil")
        seen = np.bincount(((dyv + 2) * 5 + dxv + 2).ravel(), minlength=25)
        for oy, ox in zip(*np.divmod(np.flatnonzero(seen) , 5)):
            oy, ox = int(oy) - 2, int(ox) - 2
            if off_index[oy + 2, ox + 2] < 0:
                off_index[oy + 2, ox + 2] = len(offsets)
                offsets.append((oy, ox))
        parts.append((dofs, off_index[dyv + 2, dxv + 2]))
    K = len(offsets) * C
    targets = np.concatenate([
        (((dof_node[dofs[:, :, None]] * C + dof_chan[dofs[:, :, None]]) * K
          + oid * C + dof_chan[dofs[:, None, :]])).ravel()
        for dofs, oid in parts])
    perm = np.argsort(targets, kind="stable")
    ordered = targets[perm]
    start = np.flatnonzero(np.r_[True, ordered[1:] != ordered[:-1]])
    slots = ordered[start]
    lengths = np.diff(np.r_[start, ordered.size])

    # the window table: dof at (channel c', node + off_o), ndof if none
    img = np.full((C, Hy + 4, Hx + 4), ndof, dtype=np.int64)
    img[dof_chan, node_y + 2, node_x + 2] = np.arange(ndof)
    iy, ix = np.divmod(np.arange(H), Hx)
    gather = np.stack([img[:, iy + 2 + dy, ix + 2 + dx].T
                       for dy, dx in offsets], axis=1).reshape(H, K)

    dev = space.device
    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    return StencilTables(
        perm=i64(perm), lengths=i64(lengths), slots=i64(slots),
        gather=i64(gather), out_map=i64(dof_node * C + dof_chan),
        offsets=tuple(offsets), C=C, Hy=Hy, Hx=Hx, ndof=ndof)


def build_coefficients(st: StencilTables, op: Operator,
                       dtype=torch.float32) -> torch.Tensor:
    """Element matrices → stencil coefficient image (H, C, n_off·C): one
    sorted segment sum in float64, then one rounding to ``dtype``."""
    vals = op.cell_mats.reshape(-1)
    if op.facet_mats is not None:
        vals = torch.cat([vals, op.facet_mats.reshape(-1)])
    if vals.shape[0] != st.perm.shape[0]:
        raise ValueError(
            "operator facet layout does not match the stencil tables")
    sums = torch.segment_reduce(vals[st.perm], "sum", lengths=st.lengths,
                                unsafe=True)
    s = vals.new_zeros(int(np.prod(st.s_shape)))
    s.index_copy_(0, st.slots, sums)
    return s.reshape(st.s_shape).to(dtype)


def stencil_matvec(st: StencilTables, s: torch.Tensor,
                   bc_dofs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x with identity Dirichlet rows, in ``s.dtype`` (semantics of
    ``solve/mg.py::op_matvec`` and ``Operator.matvec64``)."""
    xs = x.to(s.dtype)
    xe = torch.cat([xs, xs.new_zeros(1)])
    y = torch.einsum("nck,nk->nc", s, xe[st.gather])
    return y.reshape(-1)[st.out_map].index_copy(0, bc_dofs, xs[bc_dofs])


def matvec_of(st: StencilTables, dtype=torch.float32):
    """(op → matvec) factory matching the ``matvec_of`` hooks of
    ``solve/mg.py``: the coefficient image is built once per operator."""
    def of(op: Operator):
        s = build_coefficients(st, op, dtype)
        bc = op.bc_dofs
        return lambda x: stencil_matvec(st, s, bc, x)
    return of


class ReloadableMatvec:
    """``matvec_of``'s operator application as one object for a sequence
    of operators of one topology: ``load(op)`` overwrites its coefficient
    image and Dirichlet dofs in place and returns it, so every operator
    is applied from the same tensors, which a replayed CUDA graph of the
    Krylov cycle reads (``solve/krylov.py``)."""

    def __init__(self, st: StencilTables, dtype=torch.float32):
        self.st, self.dtype = st, dtype
        self.s = self.bc = None

    def load(self, op: Operator) -> "ReloadableMatvec":
        s = build_coefficients(self.st, op, self.dtype)
        if self.s is None:
            self.s, self.bc = s, op.bc_dofs.clone()
        else:
            self.s.copy_(s)
            self.bc.copy_(op.bc_dofs)
        return self

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_matvec(self.st, self.s, self.bc, x)
