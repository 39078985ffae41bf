"""ocean_torch parity: the exits of ``opt.driver.run_gradient_descent``
(convergence, buoy escape, floored LR, safety bound), the re-solve of a
diverged chord Newton and the gradient check at iteration 0, against
ocean_jax. Inputs, helpers and tolerances are those of
``tests/test_torch_driver.py``; the file is apart so that two test
workers share the work.
"""

import dataclasses
import math
import os

import numpy as np
import torch
import jax.numpy as jnp

from ocean_jax import control as jax_ctrl, system as jax_system
from ocean_jax.opt.grad_check import grad_test as jax_grad_test

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.opt.driver import run_gradient_descent

from test_torch_driver import BASE, _both, _compare, _rel, setup  # noqa: F401


def test_conv_crit_exit_only_after_iteration_5(setup):
    kw = dict(use_line_search=False, num_steps=9, conv_crit=1e6, LR=5.0)
    rj, rt = _both(setup, kw, dict(staged=False))
    _compare(rj, rt)
    assert rt.exit_reason == "converged" and rt.iterations_run == 7


def test_escape_exit(setup):
    """Seeds next to the outflow edge and a constant outflow: both buoys
    leave, Σ mask = 2 > K/2. With the limits pipeline's threshold of 10
    the same run goes on."""
    pj, pt, _, _ = setup
    x0 = np.array([[1.9, 1.0], [1.95, 0.5]])
    near = (dataclasses.replace(pj, x0=jnp.asarray(x0)),
            dataclasses.replace(pt, x0=torch.as_tensor(x0)), None, None)
    kw = dict(use_line_search=False, num_steps=2, LR=1e-3)
    rj, rt = _both(near, kw, dict(staged=False), control=[6.0, 0.0])
    _compare(rj, rt)
    assert rt.exit_reason == "buoy_escape" and rt.iterations_run == 1
    assert int(rt.last_fwd.mask.sum()) == 2
    _, rt10 = _both(near, kw, dict(staged=False, escape_threshold=10),
                    dict(escape_threshold=10), control=[6.0, 0.0])
    assert rt10.exit_reason == "num_steps" and rt10.iterations_run == 2
    assert int(rt10.last_fwd.mask.sum()) == 2


def test_floored_lr_exit_of_the_search(setup):
    """LR_MIN = 500: from 1000 the search halves once, fails at the floor
    and stops; every later iteration takes its one failed probe there."""
    kw = dict(use_line_search=True, num_steps=2, LR=1000.0, LR_MIN=500.0)
    rj, rt = _both(setup, kw, dict(staged=False))
    _compare(rj, rt)
    # two iterations: steps that Armijo refused make J grow and amplify
    # the packages' rounding differences beyond 1e-10 by the third
    assert rt.inner_iterations == [2, 1] and rt.lr == 500.0
    assert rt.j_array[1] > rt.j_array[0]


def test_safety_bound_follows_the_per_stage_loop(setup):
    """max_line_search_iters = 1: the per-stage loop (``staged=False``)
    updates the control with the LR after the last decrement (500), as
    the JAX per-stage loop does; the staged loop updates with the probed
    LR (1000), ``tests/test_torch_staged.py``."""
    kw = dict(use_line_search=True, num_steps=2, LR=1000.0,
              max_line_search_iters=1)
    rj, rt = _both(setup, kw, dict(staged=False, reuse_ls_forward=True),
                   dict(staged=False))
    _compare(rj, rt)
    assert rt.inner_iterations[0] == 1 and rt.lr < 1000.0


def _stale_lu_run(setup, monkeypatch, staged):
    """A run whose first chord Newton is made non-finite, beside a clean
    run: (the newton_reuse_lu of each forward, the run, the clean run)."""
    _, pt, _, ft = setup
    pt = dataclasses.replace(pt, newton_reuse_lu=True)
    cfg = OCPConfig(**BASE, use_line_search=False, num_steps=2, LR=5.0,
                    newton_reuse_lu=True)
    clean = run_gradient_descent(cfg, pt, ft, verbose=False, staged=staged)
    real = system.forward
    seen = []

    def faulty(prob, f_quad, **kw):
        seen.append(prob.newton_reuse_lu)
        fwd = real(prob, f_quad, **kw)
        if prob.newton_reuse_lu and len(seen) == 1:
            fwd = fwd._replace(
                w=fwd.w * float("nan"),
                newton=fwd.newton._replace(residual_norm=float("nan"),
                                           converged=False))
        return fwd

    monkeypatch.setattr(system, "forward", faulty)
    res = run_gradient_descent(cfg, pt, ft, verbose=False, staged=staged)
    assert all(math.isfinite(j) for j in res.j_array)
    assert _rel(res.j_array, clean.j_array) < 1e-10
    assert _rel(res.f.quad, clean.f.quad) < 1e-8
    return seen


def test_stale_lu_resolve(setup, monkeypatch):
    """A chord Newton whose residual is not finite is re-solved with
    newton_reuse_lu=False; the run's records are those of a clean run.
    The staged loop (the default) takes one forward a probe, the last
    iteration's too."""
    seen = _stale_lu_run(setup, monkeypatch, staged=True)
    assert seen == [True, False, True, True]   # faulty, fresh, 2 probes


def test_stale_lu_resolve_per_stage(setup, monkeypatch):
    """The same in the per-stage loop: one forward an iteration."""
    seen = _stale_lu_run(setup, monkeypatch, staged=False)
    assert seen == [True, False, True]        # faulty, fresh, iteration 1


def test_grad_check_at_iteration_0_matches_jax(setup, tmp_path):
    """cfg.grad_check writes the two tables at i == 0, in the JAX
    package's format, with the JAX package's numbers (``grad_test`` there
    on the rows h = 1e-2 … 1e-4: below, the quotient amplifies the 1e-10
    agreement of J)."""
    pj, pt, fj, ft = setup
    kw = dict(use_line_search=False, num_steps=1, grad_check=True, LR=5.0)
    res = run_gradient_descent(OCPConfig(**BASE, **kw), pt, ft,
                               verbose=False, grad_check_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["grad_J_error_0.txt",
                                            "grad_J_error_centered_0.txt"]
    # the JAX package's rows at the same control and direction
    stepj = jax_system.gd_step(pj, fj, jnp.asarray(5.0),
                               use_line_search=False)
    dfj = jax_system.fd_direction(pj)
    gradj = float(jax_ctrl.boundary_inner(pj.bq, stepj.grad, dfj))
    j0 = float(jax_system.cost(pj, stepj.fwd.u_values, fj.quad))
    rows_j = dict(zip(("grad_J_error_0.txt", "grad_J_error_centered_0.txt"),
                      jax_grad_test(pj, fj, dfj, j0, gradj, 0,
                                    ks=range(2, 5))))
    header = ("reduced Gradient j \t \t approximated gradient J \t "
              "Error \t \t \t h_i ")
    for name, rows in rows_j.items():
        lines = (tmp_path / name).read_text().splitlines()
        assert lines[0] == header and len(lines) == 9
        for line, (approx, err, h) in zip(lines[2:5], rows):
            vt = [float(v) for v in line.split()]
            assert vt[3] == h
            assert abs(vt[0] - gradj) <= 1e-8 * abs(gradj)      # <g, df>
            assert abs(vt[1] - approx) <= 1e-5 * abs(approx)    # quotient
    # the reference adjoint closes to its consistency floor, as in
    # tests/test_coupled_gradient.py
    centred = [[float(v) for v in line.split()] for line in
               (tmp_path / "grad_J_error_centered_0.txt").read_text()
               .splitlines()[1:]]
    assert min(row[2] for row in centred) / abs(gradj) < 5e-3
    assert res.iterations_run == 1
