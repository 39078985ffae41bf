"""Where the JAX package's ν = 0.01 hi-res record (results/hires_mg/
summary.json, "nx64_nu0.01") and the port part ways at iteration 1.

The study's first two recorded costs are J₀ = J(u(f₀), f₁) and
J₁ = J(u(f₁), f₂), with f_{k+1} = f_k − 2⁻⁷ g_k (the LR its line search
accepted from LR 1). This script computes them on a card at Nx=64 (mg,
6 rungs, 400 buoys synthesized at Nx=32) two ways:

* with each ODE backend and point-source method of the port (the CUDA
  kernels, the record's table ODE and scatter point sources, and the
  half-grid ODE), to show whether J₁ depends on them;
* with g₀ from the multigrid adjoint solve whose preconditioner is not
  scaled by 1/ν (``nu_scale=1``, 4 rounds: the solve as the JAX package
  ran it before that scaling was added) and from the scaled one.

    python scripts/hires_nu001_record_probe_torch.py

It prints one line a case. Imports only ``ocean_torch``.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECORD_J = (54.2790339299728, 50.5543340684992)
LR = 2.0 ** -7


def costs(prob, f0, adjoint):
    """(J₀, J₁, forward state at f₁) with g_k from ``adjoint(fwd)`` at
    iteration 0 and the problem's own adjoint solve at iteration 1."""
    from ocean_torch import system

    fw0 = system.forward(prob, f0.quad)
    f1 = f0.axpy(-LR, system.reduced_gradient(prob, f0, adjoint(fw0)))
    j0 = float(system.cost(prob, fw0.u_values, f1.quad))
    fw1 = system.forward(prob, f1.quad)
    z1, _ = system._solve_adjoint_flagged(prob, fw1)
    f2 = f1.axpy(-LR, system.reduced_gradient(prob, f1, z1))
    return j0, float(system.cost(prob, fw1.u_values, f2.quad)), fw1


def main():
    import torch
    from ocean_torch import kernels, system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.limits import ensure_ud
    from ocean_torch.solve import mg as mg_mod

    kernels.build(verbose=False)
    dev = torch.device("cuda")
    u_d, x0 = ensure_ud(OCPConfig(ud_experiment="400_buoys",
                                  unit_square_resolution=32),
                        cache_dir=os.path.join(ROOT, "data", "ud_torch"),
                        device=dev)

    def problem(**kw):
        cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=64,
                        viscosity=0.01, newton_continuation=6, **kw)
        prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
        return prob, system.initial_control(prob, case=4)

    def show(label, j0, j1, fw1, t0, extra=""):
        gaps = [abs(a - b) / b for a, b in zip((j0, j1), RECORD_J)]
        print(f"{label}: J0 {j0!r} J1 {j1!r} (the record's {RECORD_J}: "
              f"relative gaps {gaps[0]:.3e}, {gaps[1]:.3e}); escaped at f1 "
              f"{int(fw1.mask.sum())}; Newton at f1 "
              f"{fw1.newton.iterations}{extra}; "
              f"{time.perf_counter() - t0:.1f} s on "
              f"{torch.cuda.get_device_name(0)}", flush=True)

    for ode, psrc in (("pallas", "fused"), ("gather", "scatter"),
                      ("grid", "scatter")):
        t0 = time.perf_counter()
        prob, f0 = problem(ode_backend=ode, psrc_method=psrc)
        j0, j1, fw1 = costs(
            prob, f0, lambda fwd: system._solve_adjoint_flagged(prob, fwd)[0])
        show(f"ode_backend={ode} psrc_method={psrc}", j0, j1, fw1, t0)

    prob, f0 = problem(ode_backend="pallas", psrc_method="fused")
    for nu_scale in (1.0, 1.0 / prob.nu):
        t0 = time.perf_counter()
        sols = []

        def adjoint(fwd):
            b = system.adjoint_rhs(prob, fwd)
            op, op_c = system.adjoint_operators(prob, fwd.w)
            sols.append(mg_mod.solve_operator_mg(
                op, op_c, prob.mg, prob.space, b, prob.bc_vals,
                nu_scale=nu_scale))
            return sols[-1].x

        j0, j1, fw1 = costs(prob, f0, adjoint)
        s = sols[0]
        show(f"iteration 0's adjoint with nu_scale={nu_scale:g}", j0, j1,
             fw1, t0, f"; that adjoint: {s.rounds} rounds, relative "
             f"residual {s.residual_norm / s.b_norm:.3e}, converged "
             f"{s.converged}")


if __name__ == "__main__":
    main()
