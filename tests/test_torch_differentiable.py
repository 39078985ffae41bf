"""ocean_torch parity: ``system.make_differentiable_ns_solver`` (the
implicit-function VJP as a ``torch.autograd.Function``) against the JAX
package's custom VJP, and the exact-gradient check of
``tests/test_coupled_gradient.py`` at Nx=6 on the CPU.

* The VJP for a seeded w̄ against JAX's: 1e-10 relative.
* Autograd through the differentiable NS solve, the plain primal ODE and
  the cost is the exact discrete gradient: its directional derivative
  matches the centred finite difference of the forward map at h=1e-5 to
  1e-7 relative, and the reference-style adjoint gradient to its
  consistency floor, 5e-3 (the bounds of the JAX package's test, whose
  runs are ``slow`` there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system

from ocean_torch import control as ctrl_mod, convert, system
from ocean_torch.config import OCPConfig
from ocean_torch.ode import solve_primal_ode

torch.set_num_threads(2)

CFG = dict(unit_square_resolution=6, ud_experiment="2_buoys", viscosity=1.0)


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(3)
    nt = OCPConfig(**CFG).num_time_steps
    u_d = 0.05 * rng.standard_normal((2, nt, 2))
    x0 = 0.6 + 0.8 * rng.random((2, 2))
    pj = jax_system.build_problem(JaxConfig(**CFG), u_d=u_d, x0=x0)
    pt = system.build_problem(OCPConfig(**CFG), u_d=u_d, x0=x0,
                              device="cpu")
    return pj, pt, rng


def test_vjp_matches_jax_custom_vjp(problems):
    pj, pt, rng = problems
    fj = jax_system.initial_control(pj, case=0)
    w_bar = rng.standard_normal(pt.space.ndof)
    w_j, vjp = jax.vjp(jax_system.make_differentiable_ns_solver(pj), fj.quad)
    (g_j,) = vjp(jnp.asarray(w_bar))
    fq = convert.control(fj).quad.clone().requires_grad_(True)
    w_t = system.make_differentiable_ns_solver(pt)(fq)
    (g_t,) = torch.autograd.grad(w_t, fq, torch.as_tensor(w_bar))
    assert np.abs(w_t.detach().numpy() - np.asarray(w_j)).max() \
        < 1e-10 * np.abs(np.asarray(w_j)).max()
    g_j = np.asarray(g_j)
    assert np.abs(g_t.numpy() - g_j).max() < 1e-10 * np.abs(g_j).max()


def test_exact_gradient_vs_fd_and_adjoint(problems):
    _, prob, _ = problems
    f = system.initial_control(prob, case=0)
    df = system.fd_direction(prob)
    ns = system.make_differentiable_ns_solver(prob)

    def j_of(fq):
        u, _ = prob.space.split(ns(fq))
        ode = solve_primal_ode(prob.space, u, prob.x0, prob.h, prob.nt,
                               prob.center)
        return system.cost(prob, ode.u_values, fq)

    fq = f.quad.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(j_of(fq), fq)
    directional = float(torch.sum(g_auto * df.quad))

    def j_fd(fq):
        return float(system.cost(prob, system.forward(prob, fq).u_values,
                                 fq))

    h = 1e-5
    fd = (j_fd(f.quad + h * df.quad) - j_fd(f.quad - h * df.quad)) / (2 * h)
    assert abs(directional - fd) < 1e-7 * abs(fd), (directional, fd)

    step = system.gd_step(prob, f, 1.0)
    assert not bool(step.fwd.mask.any())
    gradj = float(ctrl_mod.boundary_inner(prob.bq, step.grad, df))
    assert abs(gradj) > 1e-8
    assert abs(directional - gradj) < 5e-3 * abs(directional)
