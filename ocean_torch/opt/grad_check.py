"""FD-vs-adjoint gradient verification tables (port of
the ``ocean_jax.opt.grad_check`` module).

At iteration 0, re-solve the full forward pipeline at f ± h·df for
h = 10⁻¹ … 10⁻⁸ and tabulate one-sided and centred FD approximations
against the adjoint reduced gradient, writing ``grad_J_error_{i}.txt`` and
``grad_J_error_centered_{i}.txt``. Every probe is a fresh forward solve
(the reference's primal ODE re-integrates every buoy whatever mask it is
handed, so the probe costs are the same).
"""

from __future__ import annotations

import os
from typing import Optional

from .. import system as sys_mod
from ..control import Control
from ..io import artifacts


def _j_probe(prob, f_quad) -> float:
    """Forward solve + cost for one FD probe."""
    fwd = sys_mod.forward(prob, f_quad)
    return float(sys_mod.cost(prob, fwd.u_values, f_quad))


def grad_test(prob, f: Control, df: Control, j0: float, gradj: float,
              iteration: int, out_dir: Optional[str] = None,
              ks=range(1, 9)):
    """Returns (one_sided_rows, centred_rows), rows of (approximation,
    error against ``gradj``, h); optionally writes the two table files in
    the reference's format."""
    one_rows, cen_rows = [], []
    for k in ks:
        h = 10.0 ** (-k)
        jp = _j_probe(prob, f.quad + h * df.quad)
        ga = (jp - j0) / h
        one_rows.append((ga, abs(ga - gradj), h))
    for k in ks:
        h = 10.0 ** (-k)
        jp = _j_probe(prob, f.quad + h * df.quad)
        jm = _j_probe(prob, f.quad - h * df.quad)
        gc = (jp - jm) / (2 * h)
        cen_rows.append((gc, abs(gradj - gc), h))
    if out_dir is not None:
        artifacts.write_grad_table(
            os.path.join(out_dir, f"grad_J_error_{iteration}.txt"),
            gradj, one_rows)
        artifacts.write_grad_table(
            os.path.join(out_dir, f"grad_J_error_centered_{iteration}.txt"),
            gradj, cen_rows)
    return one_rows, cen_rows
