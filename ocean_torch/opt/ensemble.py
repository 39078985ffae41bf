"""Ensembles of whole gradient-descent runs (port of
``ocean_jax/opt/ensemble.py``): the four initial-control cases of the
initial-control study, or a learning-rate grid, run side by side.

The JAX package runs the members as one program, a scan over iterations
of a vmapped ``gd_step``. Here a host loop over iterations calls
``system.gd_step`` for each member in turn: each member's Newton
iterations and Armijo probes depend on its data, so the members are not a
batch axis. The exit semantics are the JAX package's, member by member:
a member that converges, loses too many buoys or diverges is frozen, and
its J, LR and control stay as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import system as sys_mod
from ..control import Control


class EnsembleResult(NamedTuple):
    j_history: torch.Tensor        # (num_steps, C)
    lr_history: torch.Tensor       # (num_steps, C)
    escaped_history: torch.Tensor  # (num_steps, C)
    stopped_at: torch.Tensor       # (C,) iteration of first exit (or num_steps)
    f_final: Control               # stacked (C, ...) controls


def run_ensemble(prob: "sys_mod.OCPProblem", f0: Control, lr0,
                 num_steps: int, use_line_search: bool = False,
                 tau: float = 0.5, c_armijo: float = 1e-4,
                 lr_min: float = 1e-6, max_ls_iters: int = 40,
                 conv_crit: float = 1e-3,
                 escape_threshold: float = 1e30) -> EnsembleResult:
    """f0: Control with a leading ensemble axis C on quad and p2; lr0: (C,)
    initial learning rates.

    Each iteration i, for every member: one ``gd_step`` from its carried
    state, then, with ``frozen = stopped | diverged``, a frozen member
    keeps its control and LR and records ``j_prev``; the member stops on
    ``(i > 5) & |j_rec − j_prev| < conv_crit``, on
    ``escaped > escape_threshold`` or on divergence, and ``stopped_at``
    records the first exit. As in the JAX package, the escaped count of
    a stopped member is that of the step computed from its frozen state.
    That state and LR no longer change, so the step is computed once, at
    the first iteration after the stop, and its count is reused."""
    C = f0.quad.shape[0]
    fq = [f0.quad[c] for c in range(C)]
    fp2 = [f0.p2[c] for c in range(C)]
    lr = [float(v) for v in lr0]
    j_prev = [float("inf")] * C
    stopped = [False] * C
    stop_at = [num_steps] * C
    frozen_escaped = [None] * C
    js, lrs, escs = [], [], []
    for i in range(num_steps):
        j_row, esc_row = [], []
        for c in range(C):
            if stopped[c] and frozen_escaped[c] is not None:
                escaped, div = frozen_escaped[c], False
                j = nfq = nfp2 = nlr = None
            else:
                res = sys_mod.gd_step(prob, Control(fq[c], fp2[c]), lr[c],
                                      use_line_search=use_line_search,
                                      tau=tau, c_armijo=c_armijo,
                                      lr_min=lr_min,
                                      max_ls_iters=max_ls_iters)
                escaped, div = int(res.fwd.mask.sum()), res.diverged
                j, nfq, nfp2, nlr = (float(res.J), res.f_new.quad,
                                     res.f_new.p2, res.lr)
                if stopped[c]:
                    frozen_escaped[c] = escaped
            frozen = stopped[c] or div
            if not frozen:
                fq[c], fp2[c], lr[c] = nfq, nfp2, nlr
            j_rec = j_prev[c] if frozen else j
            conv = i > 5 and abs(j_rec - j_prev[c]) < conv_crit
            escape = escaped > escape_threshold
            if not stopped[c] and (conv or escape or div):
                stop_at[c] = i
            stopped[c] = stopped[c] or conv or escape or div
            j_prev[c] = j_rec
            j_row.append(j_rec)
            esc_row.append(escaped)
        js.append(j_row)
        lrs.append(list(lr))
        escs.append(esc_row)

    def table(rows, dtype):
        return torch.tensor(rows, dtype=dtype).reshape(num_steps, C)

    return EnsembleResult(table(js, torch.float64), table(lrs, torch.float64),
                          table(escs, torch.int64),
                          torch.tensor(stop_at, dtype=torch.int64),
                          Control(torch.stack(fq), torch.stack(fp2)))


def stack_controls(controls) -> Control:
    """[Control, ...] → Control with a leading ensemble axis."""
    return Control(torch.stack([c.quad for c in controls]),
                   torch.stack([c.p2 for c in controls]))
