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
                                  make_sharded_step, make_sharded_step_2d)

K = 6                 # pads to 8 on 4 ranks
LR = 5.0
LR_ARMIJO = 5000.0    # the search backtracks to 1250 in 3 probes
ESCAPE_PUSH = 4.0     # the outflow control of the escaping case ...
ESCAPER = 3           # ... ejects this lane (rank 1's on 4 ranks), seeded
ESCAPE_SEED = (1.98, 1.0)  # near the outflow, at step 2
NX_2D = 8             # the smallest square the mg hierarchy builds on


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
    2-D step on a 2×2 layout."""
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
    return out


def rank_default_step(rank, world, device):
    """The default 1-D case on the world group (the one-rank nccl check)."""
    p, f, lr, opts = cases(device)["default"]
    return _out(make_sharded_step(p, **opts)(f.quad, f.p2, lr))
