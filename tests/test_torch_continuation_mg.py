"""The port's multigrid ν-ladder (``newton_continuation`` with
``linear_solver="mg"``, ``ocean_torch/system.py::_solve_ns``) at the
reference's golden viscosity ν = 0.01 (mirrors
``tests/test_continuation.py::test_continuation_mg_coarse_mesh_stall_is_detected``,
at Nx = 8 where that test takes Nx = 16: the last rung stalls on either
mesh, cell Péclet ≈ 20–40, and a stalled solve runs 50 Newton steps of
four FGMRES cycles, 40 s on two CPU threads at Nx = 8, 90 s at Nx = 16).

It is held to honesty, not to a JAX stall: where it reports
``converged``, its state is the port's dense ladder's to 1e-8·max|w|;
where it does not, the residual is finite and the solve log names the
stalled solve (one "ns_rung" record a rung, then the "ns_newton" record
of the solve at ν). The inputs are those of ``test_torch_continuation.py``.
"""

import dataclasses
import math

import torch

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.pipelines import ud_construction

torch.set_num_threads(2)


def _problem(u_d, x0, **kw):
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment="10_buoys",
                    viscosity=0.01, newton_continuation=6, **kw)
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    return dataclasses.replace(prob, solve_log=[])


def test_multigrid_ladder_is_honest():
    """The mg ladder's last rungs are convection-dominated: where it
    stalls it says so, where it converges it is the dense ladder's
    state."""
    r = ud_construction.run(nx=8, K=10, viscosity=1.0, device="cpu")
    u_d, x0 = r["u_values"], r["x"][:, 0, :]
    pm = _problem(u_d, x0, linear_solver="mg")
    f = system.initial_control(pm, case=0)
    rm = system.solve_ns(pm, f.quad)
    rungs = [r for r in pm.solve_log if r["solve"] == "ns_rung"]
    assert len(rungs) == 7 and pm.solve_log[-1]["solve"] == "ns_newton"
    assert all(math.isfinite(r["residual_norm"]) for r in pm.solve_log)
    assert pm.solve_log[-1]["converged"] is rm.converged
    if rm.converged:
        pd = _problem(u_d, x0)
        wd = system.solve_ns(pd, f.quad).w
        assert (rm.w - wd).abs().max() < 1e-8 * wd.abs().max()
    else:
        assert math.isfinite(rm.residual_norm)
        assert not all(r["converged"] for r in pm.solve_log)
        assert bool(torch.isfinite(rm.w).all())
