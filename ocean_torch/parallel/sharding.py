"""Multi-device steps over ``torch.distributed`` process groups (port of
``ocean_jax/parallel/sharding.py``; process groups stand in for the JAX
device mesh).

The buoy axis is sharded across the ranks of a group:

  * the primal and adjoint buoy ODEs and the point sources run on each
    rank's contiguous block of lanes (what ``P("buoy")`` gives in JAX),
  * the point-source load vector is summed over the group
    (``all_reduce``, the ``psum`` of the JAX package),
  * the ODE outputs are gathered on every rank, so the cost, the Armijo
    test and the update run replicated, as under GSPMD,
  * the NS and adjoint saddle solves run replicated on a 1-D group; on a
    2-D ("dof", "buoy") layout the multigrid matvec is also sharded over
    cells (``dof_sharding.py``).

The sharded steps are ``system.gd_step`` itself with its three hooks
(``ode_impl``, ``adjoint_rhs_impl``, ``matvec_of``) set, so every option
of the problem and the line search are shared, not copied.

Every rank runs the replicated stages itself and takes its branches from
its own values; this holds because those stages give the same bits on
every rank (no atomics in the reductions, deterministic factorizations,
kernels that are bit-reproducible). The gathers are ``all_reduce`` sums
of zero-filled buffers into which each rank writes its block: ``v + 0``
is exact and keeps NaN and inf, and gloo has ``all_reduce`` (not
``all_gather``) for CUDA tensors, so one path serves gloo on the CPU and
the card and nccl.

Buoy counts are padded to a multiple of the group size; the padding lanes
sit at the domain center with weight 0 and drop out of the cost, the
adjoint and the escape count. Without an initialized process group the
builders raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .. import system as sys_mod
from ..control import Control
from .dof_sharding import make_matvec_of


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("the sharded steps need an initialized "
                           "torch.distributed process group "
                           "(parallel/launch.py, or torchrun)")


def make_buoy_group(group=None):
    """The group whose ranks share the buoy axis (the counterpart of
    ``make_buoy_mesh``): ``group``, or the world."""
    _require_group()
    return dist.group.WORLD if group is None else group


class Groups2D(NamedTuple):
    """This rank's place in a ("dof", "buoy") layout: rank r sits at
    (r // n_buoy, r % n_buoy). ``buoy`` is its row (the ranks that share
    the buoy axis), ``dof`` its column (the ranks that share the cells).
    Ranks past n_dof·n_buoy are outside the layout (``member`` False,
    groups None)."""
    n_dof: int
    n_buoy: int
    member: bool
    dof: Optional[object]
    buoy: Optional[object]


def make_2d_groups(n_dof: int, n_buoy: int) -> Groups2D:
    """The counterpart of ``make_2d_mesh``. Every rank of the world must
    call it: it creates every row and column group, in one order, on every
    rank (``dist.new_group`` requires that)."""
    _require_group()
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_dof * n_buoy > world:
        raise ValueError(f"a {n_dof}×{n_buoy} layout needs "
                         f"{n_dof * n_buoy} ranks, the world has {world}")
    rows = [dist.new_group([i * n_buoy + j for j in range(n_buoy)])
            for i in range(n_dof)]
    cols = [dist.new_group([i * n_buoy + j for i in range(n_dof)])
            for j in range(n_buoy)]
    if rank >= n_dof * n_buoy:
        return Groups2D(n_dof, n_buoy, False, None, None)
    return Groups2D(n_dof, n_buoy, True, cols[rank % n_buoy],
                    rows[rank // n_buoy])


def pad_buoys(u_d: torch.Tensor, x0: torch.Tensor, n_dev: int, center
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad the buoy axis to a multiple of ``n_dev``. Padding buoys sit at
    ``center`` with u_d = 0 and weight 0."""
    K = u_d.shape[0]
    pad = -K % n_dev
    center = torch.as_tensor(center, dtype=x0.dtype, device=x0.device)
    weights = torch.cat([torch.ones(K, dtype=torch.float64),
                         torch.zeros(pad, dtype=torch.float64)]).to(
                             u_d.device)
    u_d_p = torch.cat([u_d, u_d.new_zeros((pad,) + tuple(u_d.shape[1:]))])
    x0_p = torch.cat([x0, center.expand(pad, 2)])
    return u_d_p, x0_p, weights


def pad_problem(prob: "sys_mod.OCPProblem", n_dev: int
                ) -> "sys_mod.OCPProblem":
    """The problem with its buoy axis padded to a multiple of ``n_dev``
    and ``buoy_weights`` marking the real lanes."""
    u_d_p, x0_p, wts = pad_buoys(prob.u_d, prob.x0, n_dev, prob.center)
    return dataclasses.replace(prob, u_d=u_d_p, x0=x0_p, buoy_weights=wts)


def _lanes(prob, group) -> slice:
    """This rank's contiguous block of the (padded) buoy axis."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if prob.K % size:
        raise ValueError(f"{prob.K} lanes do not split over {size} ranks: "
                         "pad the problem first (pad_problem)")
    per = prob.K // size
    return slice(rank * per, (rank + 1) * per)


def _shard(prob, lanes: slice):
    w = prob.buoy_weights
    return dataclasses.replace(prob, u_d=prob.u_d[lanes], x0=prob.x0[lanes],
                               buoy_weights=None if w is None else w[lanes])


def _gather(block: torch.Tensor, K: int, lanes: slice, group
            ) -> torch.Tensor:
    """Every rank's block on every rank: the rank writes its block into a
    zero-filled buffer of all K lanes and the buffers are summed."""
    full = block.new_zeros((K,) + tuple(block.shape[1:]))
    full[lanes] = block
    dist.all_reduce(full, group=group)
    return full


def make_buoy_ode_impl(group=None):
    """``system._primal_ode`` on this rank's lanes, its outputs gathered
    on every rank (the ``ode_impl`` hook of ``system.gd_step``)."""
    group = make_buoy_group(group)

    def impl(prob, u):
        lanes = _lanes(prob, group)
        ode = sys_mod._primal_ode(_shard(prob, lanes), u)
        K = prob.K
        mask = _gather(ode.mask.to(torch.uint8), K, lanes, group)
        kfail = _gather(ode.kfail.to(torch.int64), K, lanes, group)
        return type(ode)(_gather(ode.x, K, lanes, group),
                         _gather(ode.u_values, K, lanes, group),
                         mask.bool(),
                         _gather(ode.x_raw, K, lanes, group),
                         kfail.to(ode.kfail.dtype))

    return impl


def make_buoy_adjoint_rhs_impl(group=None):
    """``system._adjoint_rhs_body`` on this rank's lanes, the partial load
    vectors summed over the group (the ``adjoint_rhs_impl`` hook)."""
    group = make_buoy_group(group)

    def impl(prob, u, grad_u, x, u_values, mask, x_raw, kfail):
        lanes = _lanes(prob, group)
        b = sys_mod._adjoint_rhs_body(
            _shard(prob, lanes), u, grad_u, x[lanes], u_values[lanes],
            mask[lanes], x_raw[lanes], kfail[lanes])
        dist.all_reduce(b, group=group)
        return b

    return impl


def _step(prob_p, use_line_search, tau, c_armijo, lr_min, max_ls_iters,
          **hooks):
    def step(f_quad, f_p2, lr):
        res = sys_mod.gd_step(prob_p, Control(f_quad, f_p2), lr,
                              use_line_search=use_line_search, tau=tau,
                              c_armijo=c_armijo, lr_min=lr_min,
                              max_ls_iters=max_ls_iters, **hooks)
        return (res.f_new.quad, res.f_new.p2, res.lr, res.J,
                sys_mod.sum_mask(prob_p, res.fwd.mask), res.diverged)
    return step


def make_sharded_step(prob: "sys_mod.OCPProblem", group=None,
                      use_line_search: bool = False, tau: float = 0.5,
                      c_armijo: float = 1e-4, lr_min: float = 1e-6,
                      max_ls_iters: int = 40):
    """The GD step with the buoy axis sharded over ``group`` (default the
    world): (f_quad, f_p2, lr) → (f_quad', f_p2', lr', J, mask_count,
    diverged), the same on every rank. The saddle solves run replicated;
    every option of ``prob`` travels with it."""
    group = make_buoy_group(group)
    prob_p = pad_problem(prob, dist.get_world_size(group))
    return _step(prob_p, use_line_search, tau, c_armijo, lr_min,
                 max_ls_iters, ode_impl=make_buoy_ode_impl(group),
                 adjoint_rhs_impl=make_buoy_adjoint_rhs_impl(group))


def make_sharded_step_2d(prob: "sys_mod.OCPProblem", groups: Groups2D,
                         use_line_search: bool = False, tau: float = 0.5,
                         c_armijo: float = 1e-4, lr_min: float = 1e-6,
                         max_ls_iters: int = 40):
    """The GD step over a ("dof", "buoy") layout (``make_2d_groups``): the
    multigrid Newton and adjoint solves take a matvec sharded over the
    cells of the "dof" group, and the buoy stages are sharded over the
    "buoy" group. The preconditioner hierarchy stays replicated. Needs
    ``prob.linear_solver == "mg"``. Same return contract as
    ``make_sharded_step``."""
    if prob.linear_solver != "mg" or prob.mg is None:
        raise ValueError("the 2-D sharded step runs the mg linear-solver "
                         "path (linear_solver=\"mg\")")
    if not groups.member:
        raise ValueError("this rank is outside the 2-D layout")
    prob_p = pad_problem(prob, groups.n_buoy)
    return _step(prob_p, use_line_search, tau, c_armijo, lr_min,
                 max_ls_iters, ode_impl=make_buoy_ode_impl(groups.buoy),
                 adjoint_rhs_impl=make_buoy_adjoint_rhs_impl(groups.buoy),
                 matvec_of=make_matvec_of(groups.dof))
