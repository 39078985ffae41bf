"""Rank functions of the sharded-step tests (``test_torch_parallel.py``,
``test_torch_cuda.py``): spawned ranks import them by module path, so they
live here, at top level, and import nothing of JAX."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ocean_torch import control as ctrl_mod, system
from ocean_torch.config import OCPConfig
from ocean_torch.fem import assemble
from ocean_torch.parallel import (make_2d_groups, make_sharded_matvec,
                                  make_sharded_step, make_sharded_step_2d,
                                  pad_problem)
from ocean_torch.parallel.dof_sharding import make_matvec_of
from ocean_torch.parallel.sharding import (make_buoy_adjoint_rhs_impl,
                                           make_buoy_ode_impl)

K = 6                 # pads to 8 on 4 ranks
LR = 5.0
LR_ARMIJO = 5000.0    # the search backtracks to 1250 in 3 probes
ESCAPE_PUSH = 4.0     # the outflow control of the escaping case ...
ESCAPER = 3           # ... ejects this lane (rank 1's on 4 ranks), seeded
ESCAPE_SEED = (1.98, 1.0)  # near the outflow, at step 2
NX_2D = 8             # the smallest square the mg hierarchy builds on
MULTI_STEPS = 2       # iterations of the gd_multi_step cases
MULTI_2D = "multi_2d"  # the one of them on the 2 × 2 layout


def tiny_problem(device, nx: int = 8, **over):
    """The JAX package's sharding problem (``tests/test_sharding.py``):
    Nx=8, 6 buoys, T=0.05."""
    rng = np.random.default_rng(0)
    cfg = OCPConfig(unit_square_resolution=nx, ud_experiment=f"{K}_buoys",
                    T=0.05, dt=0.005, **over)
    seeds = 0.3 + 1.4 * rng.random((K, 2))
    u_d = 0.05 * rng.standard_normal((K, cfg.num_time_steps, 2))
    return system.build_problem(cfg, u_d=u_d, x0=seeds, device=device)


def escaping_problem(device):
    """The problem with the exact segment sums and the consistent adjoint,
    one buoy seeded at the outflow, and the control that ejects it."""
    prob = tiny_problem(device, psrc_method="ozaki",
                        adjoint_mode="consistent")
    x0 = prob.x0.clone()
    x0[ESCAPER] = torch.tensor(ESCAPE_SEED, dtype=x0.dtype)
    prob = dataclasses.replace(prob, x0=x0)
    return prob, ctrl_mod.constant(prob.space, prob.bq, [ESCAPE_PUSH, 0.0])


def cases(device):
    """name → (problem, control, LR, step options) of the 1-D cases."""
    prob = tiny_problem(device)
    oz, f_oz = escaping_problem(device)
    return {
        "default": (prob, system.initial_control(prob, 0), LR, {}),
        "ozaki_consistent": (oz, f_oz, LR, {}),
        "armijo": (prob, system.initial_control(prob, 0), LR_ARMIJO,
                   dict(use_line_search=True, max_ls_iters=10)),
    }


def multi_step_cases(device):
    """name → (problem, control, LR, options) of the ``gd_multi_step``
    cases: line search off, on from an LR it backtracks from, and the mg
    problem of the 2-D step (``MULTI_2D``, run on the 2 × 2 layout)."""
    prob = tiny_problem(device)
    f = system.initial_control(prob, 0)
    return {
        "multi_fixed": (prob, f, LR, dict(use_line_search=False)),
        "multi_armijo": (prob, f, LR_ARMIJO,
                         dict(use_line_search=True, max_ls_iters=10)),
        MULTI_2D: problem_2d(device) + (dict(use_line_search=False),),
    }


def multi_out(f, lr, traj, hook_calls):
    """``gd_multi_step``'s (f_final, lr_final, GDTrajectory) on the host,
    beside the calls of each hook."""
    out = {k: v.cpu() for k, v in traj._asdict().items()}
    out.update(f_quad=f.quad.cpu(), f_p2=f.p2.cpu(), lr_final=float(lr),
               hook_calls=hook_calls)
    return out


def _counted(hooks):
    """The hooks with each call counted: (hooks, name → calls); a
    ``matvec_of`` counts the matvecs applied, not the operators."""
    calls = dict.fromkeys(hooks, 0)

    def count(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    out = {n: count(n, h) for n, h in hooks.items() if n != "matvec_of"}
    if "matvec_of" in hooks:
        out["matvec_of"] = lambda op: count("matvec_of",
                                            hooks["matvec_of"](op))
    return out, calls


def sharded_multi_step(prob, f, lr, opts, groups=None):
    """``system.gd_multi_step`` with the buoy hooks on the world group, or,
    given a 2-D layout (``make_2d_groups``), on its buoy group with the
    matvec sharded over its dof group; the problem padded to the buoy
    group's size. Returns its (f_final, lr_final, GDTrajectory) and the
    calls of each hook."""
    buoy = None if groups is None else groups.buoy
    hooks = dict(ode_impl=make_buoy_ode_impl(buoy),
                 adjoint_rhs_impl=make_buoy_adjoint_rhs_impl(buoy))
    if groups is not None:
        hooks["matvec_of"] = make_matvec_of(groups.dof)
    hooks, calls = _counted(hooks)
    return system.gd_multi_step(
        pad_problem(prob, dist.get_world_size(buoy)), f, lr, MULTI_STEPS,
        **hooks, **opts) + (calls,)


def problem_2d(device):
    prob = tiny_problem(device, nx=NX_2D, linear_solver="mg")
    return prob, system.initial_control(prob, 0), 1.0


def matvec_input(prob):
    """The operator and vector of the sharded matvec case."""
    op = assemble.ns_operator(prob.space, prob.bq,
                              torch.zeros(prob.space.ndof,
                                          dtype=torch.float64,
                                          device=prob.device),
                              prob.nu, prob.bc_dofs)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(prob.space.ndof),
                        device=prob.device)
    return op, x


def _out(t):
    f_quad, f_p2, lr, j, count, diverged = t
    return {"f_quad": f_quad.cpu(), "f_p2": f_p2.cpu(), "lr": float(lr),
            "J": float(j), "mask_count": float(count),
            "diverged": bool(diverged)}


def rank_all_cases(rank, world, device):
    """Every case of ``test_torch_parallel.py`` on one spawn of 4 ranks:
    the matvec on ranks 0–2, the three 1-D steps on the world group, the
    2-D step on a 2×2 layout, the ``gd_multi_step`` cases with the buoy
    hooks on the world group and, for ``MULTI_2D``, all three hooks on
    the 2×2 layout."""
    out = {}
    sub = dist.new_group([0, 1, 2])
    groups = make_2d_groups(2, 2)
    prob = tiny_problem(device)
    if rank < 3:
        op, x = matvec_input(prob)
        out["matvec"] = make_sharded_matvec(op, sub)(x).cpu()
    for name, (p, f, lr, opts) in cases(device).items():
        out[name] = _out(make_sharded_step(p, **opts)(f.quad, f.p2, lr))
    p2, f2, lr2 = problem_2d(device)
    out["2d"] = _out(make_sharded_step_2d(p2, groups)(f2.quad, f2.p2, lr2))
    for name, (p, f, lr, opts) in multi_step_cases(device).items():
        out[name] = multi_out(*sharded_multi_step(
            p, f, lr, opts, groups if name == MULTI_2D else None))
    return out


def rank_default_step(rank, world, device):
    """The default 1-D case on the world group (the one-rank nccl check)."""
    p, f, lr, opts = cases(device)["default"]
    return _out(make_sharded_step(p, **opts)(f.quad, f.p2, lr))
