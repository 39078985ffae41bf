"""Cell-sharded operator application for the high-resolution solves (port
of ``ocean_jax/parallel/dof_sharding.py``).

The ``Operator`` is matrix-free (element matrices and dof tables), so the
natural decomposition shards the CELL axis: each rank of a process group
applies its contiguous block of cells (and of boundary facets) to the
replicated input vector, and the partial global vectors are summed with
``torch.distributed.all_reduce``. The JAX package does the same with a
``shard_map`` and a ``psum`` over a mesh axis.

Each rank reduces its block into the global vector through its own
transpose incidence (``fem.assemble.gather_sum``), so the local sum has
no atomics and every rank of the group receives the same bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..fem.assemble import Operator, gather_sum
from ..fem.spaces import incidence


class ShardTables(NamedTuple):
    """One rank's block of an operator's dof tables: cells
    ``[start, stop)`` of the table padded to a multiple of the group size,
    the same for facets, and the incidences of the blocks."""
    cells: slice
    cell_dofs: torch.Tensor
    cell_inc: torch.Tensor
    facets: Optional[slice]
    facet_dofs: Optional[torch.Tensor]
    facet_inc: Optional[torch.Tensor]


def _block(n_rows: int, size: int, rank: int) -> slice:
    per = -(-n_rows // size)
    return slice(rank * per, (rank + 1) * per)


def _pad_rows(a: torch.Tensor, rows: slice) -> torch.Tensor:
    """Rows ``rows`` of ``a``, zero rows past its end (the padding cells of
    the last block: a zero matrix on dof 0 adds nothing)."""
    blk = a[rows.start:rows.stop]
    pad = (rows.stop - rows.start) - blk.shape[0]
    if pad == 0:
        return blk
    return torch.cat([blk, blk.new_zeros((pad,) + tuple(a.shape[1:]))])


def _dof_block(dofs: torch.Tensor, rows: slice, n: int):
    d = _pad_rows(dofs, rows)
    inc = torch.as_tensor(incidence(d.cpu().numpy(), n), device=d.device)
    return d, inc


def shard_tables(op: Operator, group=None) -> ShardTables:
    """This rank's block of ``op``'s cells and facets in ``group``."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    cells = _block(op.cell_dofs.shape[0], size, rank)
    cell_dofs, cell_inc = _dof_block(op.cell_dofs, cells, op.n)
    facets = facet_dofs = facet_inc = None
    if op.facet_mats is not None:
        facets = _block(op.facet_dofs.shape[0], size, rank)
        facet_dofs, facet_inc = _dof_block(op.facet_dofs, facets, op.n)
    return ShardTables(cells, cell_dofs, cell_inc, facets, facet_dofs,
                       facet_inc)


def make_sharded_matvec(op: Operator, group=None,
                        tables: Optional[ShardTables] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The action of ``op`` with its cells sharded over ``group`` (default
    the world): each rank applies its block, the partial vectors are
    summed with ``all_reduce``, and the Dirichlet rows are reset to
    ``x[bc_dofs]``. It computes in the dtype of its input (float64 for
    the refinement residuals, float32 in the Krylov loop). ``tables``
    (``shard_tables``) may be passed for operators that share the dof
    tables of an earlier one. Raises without a process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_sharded_matvec needs an initialized "
                           "torch.distributed process group")
    t = shard_tables(op, group) if tables is None else tables
    mats = {}

    def local(dtype):
        if dtype not in mats:
            cm = _pad_rows(op.cell_mats, t.cells).to(dtype)
            fm = (None if t.facets is None
                  else _pad_rows(op.facet_mats, t.facets).to(dtype))
            mats[dtype] = (cm, fm)
        return mats[dtype]

    def matvec(x):
        cm, fm = local(x.dtype)
        y = gather_sum(torch.einsum("cab,cb->ca", cm, x[t.cell_dofs]),
                       t.cell_inc)
        if fm is not None:
            y = y + gather_sum(torch.einsum("fab,fb->fa", fm,
                                            x[t.facet_dofs]), t.facet_inc)
        dist.all_reduce(y, group=group)
        return y.index_copy(0, op.bc_dofs, x[op.bc_dofs])

    return matvec


def make_matvec_of(group=None) -> Callable[[Operator], Callable]:
    """The ``matvec_of`` hook of ``system.gd_step``: op → the sharded
    matvec of ``op``. The blocks' incidences are built once for the dof
    tables that the operators of a problem share."""
    cache = {}

    def matvec_of(op: Operator):
        key = (id(op.cell_dofs), id(op.facet_dofs))
        hit = cache.get(key)
        if hit is None:
            # the entry keeps the tables alive, so their ids stay unique
            hit = (op.cell_dofs, op.facet_dofs, shard_tables(op, group))
            cache.clear()
            cache[key] = hit
        return make_sharded_matvec(op, group, hit[2])

    return matvec_of
