"""Reduced-gradient-descent driver (port of the ``ocean_jax.opt.driver``
module): the optimization loop of the reference with identical semantics:

  * fresh buoy mask every iteration,
  * optional Armijo backtracking line search whose LR is NOT reset between
    outer iterations (monotone non-increasing across the run),
  * control update f ← f − LR(αf − z),
  * J recorded as J(old u_values, new f),
  * convergence exit |ΔJ| < conv_crit only for i > 5,
  * buoy-escape exit when Σ mask exceeds a threshold (K/2 for the OCP
    pipeline, 10 for the limits pipeline),
  * outer/inner wall-clock timings per iteration.

One loop over the stages of ``system.make_staged_pair`` serves both
modes of the JAX package's two loops. The staged mode (``staged=True``,
the default, ``OCPConfig.staged_driver``, with ``reuse_ls_forward``)
and the per-stage mode (either one False) differ in three things:

  * the staged mode carries the last probe's forward state and J into
    the next iteration; the per-stage mode carries them only where the
    Armijo test accepted the probe and ``reuse_ls_forward`` is set (the
    probe's control is then the updated control exactly), and otherwise
    solves the forward problem anew;
  * where the line search stops at ``max_line_search_iters``, the staged
    mode takes the probe made at the LR before the last decrement while
    carrying the decremented LR; the per-stage mode updates the control
    with the decremented LR;
  * without the line search the staged mode makes one probe at the LR
    (the state it carries); the per-stage mode makes none.

The stepped multigrid Newton and the staged adjoint
(``system.run_newton_staged``, ``run_adjoint_staged``) are driven by the
high-resolution runner, ``scripts/hires_mg_run_torch.py``, not here.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import control as ctrl_mod
from .. import system as sys_mod
from ..config import OCPConfig
from ..control import Control
from ..utils import graphs, timing
from . import grad_check as grad_check_mod


@dataclasses.dataclass
class GDRunResult:
    j_array: List[float]
    divs_u: List[float]
    x_array: List[np.ndarray]
    outer_times: List[float]
    inner_times: List[float]
    inner_iterations: List[int]
    f: Control
    lr: float
    last_fwd: "sys_mod.ForwardState"
    last_z: torch.Tensor
    last_u_values: np.ndarray
    exit_reason: str
    iterations_run: int


def _clock(device: torch.device) -> float:
    """The host clock once the device has finished what was queued."""
    timing.sync(device)
    return time.perf_counter()


@timing.span("gd_job")
def run_gradient_descent(cfg: OCPConfig, prob: "sys_mod.OCPProblem",
                         f: Control,
                         escape_threshold: Optional[float] = None,
                         df: Optional[Control] = None,
                         on_iteration: Optional[Callable] = None,
                         grad_check_dir: Optional[str] = None,
                         reuse_ls_forward: bool = True,
                         staged: bool = True,
                         verbose: bool = True) -> GDRunResult:
    """Run up to cfg.num_steps GD iterations over the stages of
    ``system.make_staged_pair``. ``escape_threshold`` defaults to K/2
    (OCP pipeline); the limits pipeline passes 10.

    ``staged and reuse_ls_forward`` (the default) selects the staged
    mode, else the per-stage mode (module docstring).
    ``reuse_ls_forward`` skips one NS + ODE solve per iteration whose
    probe was accepted (its control is the updated control exactly and
    the solve is deterministic); False keeps the reference's
    per-iteration outer/inner timing split.

    A chord-Newton solve (``prob.newton_reuse_lu``) whose residual is not
    finite diverged on its stale factors and is re-solved with fresh
    factorizations. ``on_iteration(i, f, fwd, z, j_array)`` runs after
    each iteration's records. The whole run is the span ``gd_job``, each
    iteration a ``gd_iteration`` (``utils/timing.py``).

    On the card each iteration's trajectories are copied into page-locked
    host memory without a wait (span ``trajectory_copy``, ``pinned`` 1);
    one ``timing.sync`` before the return makes ``x_array`` safe to
    read."""
    if escape_threshold is None:
        escape_threshold = prob.K / 2
    if df is None:
        df = sys_mod.fd_direction(prob)
    carry = staged and reuse_ls_forward
    progs = sys_mod.make_staged_pair(prob)
    dev = prob.device
    lr = cfg.LR
    j_array: List[float] = []
    divs_u: List[float] = []
    x_array: List[np.ndarray] = []
    outer_times: List[float] = []
    inner_times: List[float] = []
    inner_iterations: List[int] = []
    exit_reason = "num_steps"
    last_fwd = last_z = None
    it_run = 0

    fwd, j_old = None, None
    for i in range(cfg.num_steps):
        with timing.span("gd_iteration", i=i):
            if verbose:
                print(f"Gradient descent iteration: {i}")
            t_outer = _clock(dev)
            if fwd is None:
                fwd, j_dev = progs.begin(f.quad)
                j_old = timing.to_host(j_dev)
            if (prob.newton_reuse_lu
                    and not math.isfinite(fwd.newton.residual_norm)):
                if verbose:
                    print("fast-path Newton diverged; re-solving with "
                          "fresh factorizations")
                fwd = sys_mod.forward(
                    dataclasses.replace(prob, newton_reuse_lu=False), f.quad)
                j_old = timing.to_host(progs.record(fwd.u_values, f.quad))
            z, g, gradj_dev, div_dev, adj_ok = progs.grad(f, fwd)
            gradj = timing.to_host(gradj_dev)
            outer_times.append(_clock(dev) - t_outer)
            if not fwd.newton.converged:
                print(f"WARNING: Newton did not converge at iteration {i} "
                      f"(residual {fwd.newton.residual_norm:.3e})")
            if not adj_ok:
                print(f"WARNING: adjoint refinement not converged at "
                      f"iteration {i}")
            last_fwd, last_z = fwd, z
            with timing.span("trajectory_copy",
                             bytes=fwd.x.numel() * fwd.x.element_size(),
                             pinned=int(fwd.x.is_cuda)):
                x_array.append(timing.to_host_async(fwd.x))
            it_run = i + 1

            # gradient check at i == 0
            if cfg.grad_check and i == 0:
                gradj0 = timing.to_host(
                    ctrl_mod.boundary_inner(prob.bq, g, df))
                grad_check_mod.grad_test(prob, f, df, j_old, gradj0, i,
                                         out_dir=grad_check_dir)

            # Armijo line search; j_old is the accepted state's J
            t_inner = _clock(dev)
            inner, accepted = 0, False
            if cfg.use_line_search:
                cond = -cfg.c_armijo * gradj
                while True:
                    if verbose:
                        print("line search at " + str(lr))
                    inner += 1
                    f_c, fwd_c, j_dev = progs.probe(f, g, lr)
                    j_new = timing.to_host(j_dev)
                    if j_old - j_new >= lr * cond:
                        accepted = True
                        break
                    new_lr = max(cfg.tau * lr, cfg.LR_MIN)
                    if new_lr == lr:
                        # floored at LR_MIN: re-probing is the identical
                        # solve; accept after the one failed probe
                        if verbose:
                            print("line search floored at LR_MIN; accepting")
                        break
                    lr = new_lr
                    if inner >= cfg.max_line_search_iters:
                        if verbose:
                            print("line search hit safety bound; accepting")
                        break
            elif carry:
                f_c, fwd_c, j_dev = progs.probe(f, g, lr)
                j_new = timing.to_host(j_dev)
            inner_times.append(_clock(dev) - t_inner)
            inner_iterations.append(inner)

            # control update + records
            fwd_i = fwd
            if carry or (accepted and reuse_ls_forward):
                # the last probe; in the staged mode at the safety bound
                # it was made at the LR before the last decrement
                f, fwd, j_old = f_c, fwd_c, j_new
            else:
                f, fwd = f.axpy(-lr, g), None
            j_array.append(timing.to_host(
                progs.record(fwd_i.u_values, f.quad)))
            divs_u.append(timing.to_host(div_dev))

            if on_iteration is not None:
                on_iteration(i, f, fwd_i, z, j_array)

            # exits
            if i > 5 and abs(j_array[i] - j_array[i - 1]) < cfg.conv_crit:
                if verbose:
                    print("cost small enough")
                exit_reason = "converged"
                break
            elif timing.to_host(fwd_i.mask.sum()) > escape_threshold:
                if verbose:
                    print("too many buoys out of domain .. exiting")
                exit_reason = "buoy_escape"
                break

    if dev.type != "cuda":
        graphs.release(dev)      # the CPU chord's value holds prob.fac0
    timing.sync(dev)     # the trajectory copies have landed in x_array
    last_u_values = (None if last_fwd is None
                     else timing.to_host(last_fwd.u_values))
    return GDRunResult(j_array, divs_u, x_array, outer_times, inner_times,
                       inner_iterations, f, lr, last_fwd, last_z,
                       last_u_values, exit_reason, it_run)
