"""ocean_torch parity: ``opt.driver.run_gradient_descent`` against
ocean_jax, on the inputs of ``tests/test_driver_staged.py`` (unit square,
Nx=8, 2 buoys, nt=10). The exits, the stale-LU re-solve and the gradient
check are in ``tests/test_torch_driver_exits.py``.

The port has one loop; it is held to both JAX loops (the staged one, which
implies ``reuse_ls_forward``, and the per-stage one) where they agree, and
to the per-stage loop where they differ (the safety bound).

Tolerances: ``exit_reason``, ``inner_iterations``, LR and
``iterations_run`` equal; J 1e-10 relative; trajectories x 1e-10
absolute; div u and the control 1e-8 relative (Newton stops at rtol
1e-9 in both packages). LR starts at 1000 in the Armijo runs, where the
search backtracks on these inputs (at the reference's 5 its first probe
accepts); tests/test_torch_linesearch.py checks that no Armijo decision
on such inputs is within 1e-9 of its threshold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import control as jax_ctrl, system as jax_system
from ocean_jax.opt.driver import run_gradient_descent as jax_run

from ocean_torch import control as ctrl_mod, convert, system
from ocean_torch.config import OCPConfig
from ocean_torch.opt import driver
from ocean_torch.opt.driver import GDRunResult, run_gradient_descent
from ocean_torch.utils import graphs

# The suite runs in several worker processes on one machine; PyTorch's
# default of one thread a core in each of them oversubscribes it.
torch.set_num_threads(2)

BASE = dict(ud_experiment="2_buoys", unit_square_resolution=8, T=0.1,
            dt=0.01)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(4)
    nt = JaxConfig(**BASE).num_time_steps
    u_d = 0.05 * rng.standard_normal((2, nt, 2))
    x0 = 0.4 + 1.2 * rng.random((2, 2))
    pj = jax_system.build_problem(JaxConfig(**BASE), u_d=u_d, x0=x0)
    pt = system.build_problem(OCPConfig(**BASE), u_d=u_d, x0=x0,
                              device="cpu")
    fj = jax_system.initial_control(pj, case=0)
    return pj, pt, fj, convert.control(fj)


def _both(setup, kw, jax_kw=None, torch_kw=None, control=None):
    pj, pt, fj, ft = setup
    if control is not None:
        fj = jax_ctrl.constant(pj.space, pj.bq, control)
        ft = ctrl_mod.constant(pt.space, pt.bq, control)
    rj = jax_run(JaxConfig(**BASE, **kw), pj, fj, verbose=False,
                 **(jax_kw or {}))
    rt = run_gradient_descent(OCPConfig(**BASE, **kw), pt, ft,
                              verbose=False, **(torch_kw or {}))
    return rj, rt


def _compare(rj, rt):
    assert rt.exit_reason == rj.exit_reason
    assert rt.inner_iterations == rj.inner_iterations
    assert rt.lr == rj.lr and rt.iterations_run == rj.iterations_run
    assert len(rt.j_array) == len(rj.j_array)
    assert _rel(rt.j_array, rj.j_array) < 1e-10
    assert _rel(rt.divs_u, rj.divs_u) < 1e-8
    assert len(rt.x_array) == len(rj.x_array)
    for xt, xj in zip(rt.x_array, rj.x_array):
        assert np.abs(xt - np.asarray(xj)).max() < 1e-10
    assert _rel(rt.f.quad, rj.f.quad) < 1e-8
    assert _rel(rt.last_u_values, rj.last_u_values) < 1e-8
    n = rt.iterations_run
    assert len(rt.outer_times) == len(rt.inner_times) == n
    assert all(t >= 0 for t in rt.outer_times + rt.inner_times)


@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("use_line_search", [True, False])
def test_driver_matches_jax(setup, use_line_search, reuse):
    """reuse_ls_forward=True against the JAX staged loop, False against
    its per-stage loop."""
    kw = dict(use_line_search=use_line_search, num_steps=3,
              LR=1000.0 if use_line_search else 5.0)
    rj, rt = _both(setup, kw, dict(reuse_ls_forward=reuse, staged=reuse),
                   dict(reuse_ls_forward=reuse))
    _compare(rj, rt)
    assert rt.exit_reason == "num_steps" and rt.iterations_run == 3
    if use_line_search:
        assert rt.inner_iterations[0] == 3 and rt.lr <= 250.0
        assert all(b < a for a, b in zip(rt.j_array, rt.j_array[1:]))
    else:
        assert rt.inner_iterations == [0, 0, 0] and rt.lr == 5.0


def test_reuse_ls_forward_changes_nothing_but_the_solves(setup, monkeypatch):
    """With and without the reuse the records are identical; with it, each
    later iteration takes one forward solve less."""
    _, pt, _, ft = setup
    cfg = OCPConfig(**BASE, use_line_search=True, num_steps=3, LR=1000.0)
    calls = []
    real = system.forward
    monkeypatch.setattr(system, "forward",
                        lambda p, q, **kw: calls.append(1) or real(p, q,
                                                                   **kw))
    runs = {}
    for reuse in (True, False):
        calls.clear()
        runs[reuse] = (run_gradient_descent(cfg, pt, ft, verbose=False,
                                            reuse_ls_forward=reuse),
                       len(calls))
    (on, n_on), (off, n_off) = runs[True], runs[False]
    assert on.j_array == off.j_array and on.lr == off.lr
    assert on.inner_iterations == off.inner_iterations
    assert torch.equal(on.f.quad, off.f.quad)
    probes = sum(on.inner_iterations)
    assert n_on == 1 + probes and n_off == 3 + probes


def test_on_iteration_and_result_fields(setup):
    _, pt, _, ft = setup
    seen = []
    cfg = OCPConfig(**BASE, use_line_search=True, num_steps=2, LR=1000.0)
    res = run_gradient_descent(
        cfg, pt, ft, verbose=False,
        on_iteration=lambda i, f, fwd, z, j: seen.append(
            (i, f, fwd, z, list(j))))
    assert [s[0] for s in seen] == [0, 1]
    assert seen[1][4] == res.j_array and seen[1][1] is res.f
    assert seen[1][2] is res.last_fwd and seen[1][3] is res.last_z
    assert ([f.name for f in dataclasses.fields(GDRunResult)]
            == ["j_array", "divs_u", "x_array", "outer_times", "inner_times",
                "inner_iterations", "f", "lr", "last_fwd", "last_z",
                "last_u_values", "exit_reason", "iterations_run"])
    assert isinstance(res.x_array[0], np.ndarray)
    assert res.last_u_values.shape == (2, 10, 2)
    # J is recorded with the OLD u_values and the NEW control
    j_rec = float(system.cost(pt, res.last_fwd.u_values, res.f.quad))
    assert j_rec == res.j_array[-1]
    # the driver's clock waits for the device only on a card
    assert driver._clock(torch.device("cpu")) > 0


@pytest.mark.parametrize("search", ["accepts", "safety_bound", "off"])
def test_forward_solves_of_each_mode(setup, monkeypatch, search):
    """The forward solves (``system.forward``) of a 3-iteration run. The
    staged mode solves once and then carries the last probe. The
    per-stage mode with ``reuse_ls_forward`` carries a probe the Armijo
    test accepted and solves anew after one it did not (at the safety
    bound); without the reuse, or without the line search, it solves
    every iteration; without the line search it makes no probe. The per-stage records do not depend on the
    reuse."""
    _, pt, _, ft = setup
    kw = dict(accepts=dict(use_line_search=True, LR=1000.0),
              safety_bound=dict(use_line_search=True, LR=1000.0,
                                max_line_search_iters=1),
              off=dict(use_line_search=False, LR=5.0))[search]
    cfg = OCPConfig(**BASE, num_steps=3, **kw)
    calls = []
    real = system.forward
    monkeypatch.setattr(system, "forward",
                        lambda p, q, **kw: calls.append(1) or real(p, q,
                                                                   **kw))
    runs = {}
    for staged, reuse in ((True, True), (False, True), (False, False)):
        calls.clear()
        res = run_gradient_descent(cfg, pt, ft, verbose=False,
                                   staged=staged, reuse_ls_forward=reuse)
        runs[staged, reuse] = res, len(calls), sum(res.inner_iterations)
    (staged, n_staged, p_staged), (reuse, n_reuse, probes), \
        (fresh, n_fresh, p_fresh) = runs.values()
    assert p_fresh == probes
    assert n_fresh == 3 + probes
    assert n_reuse == (1 if search == "accepts" else 3) + probes
    assert n_staged == 1 + (3 if search == "off" else p_staged)
    assert probes == {"accepts": 6, "safety_bound": 3, "off": 0}[search]
    assert reuse.j_array == fresh.j_array and reuse.lr == fresh.lr
    assert reuse.inner_iterations == fresh.inner_iterations
    assert torch.equal(reuse.f.quad, fresh.f.quad)
    assert torch.equal(reuse.f.p2, fresh.f.p2)


def test_a_cpu_job_releases_its_chord_graph(setup):
    """On the CPU the chord's cached value (``utils/graphs.py``) holds
    the problem's Stokes factor; the job serves one value to all its
    solves and drops it when it ends."""
    _, pt, _, ft = setup
    prob = dataclasses.replace(pt, newton_reuse_lu=True)
    cfg = OCPConfig(**BASE, use_line_search=True, num_steps=2, LR=1000.0,
                    newton_reuse_lu=True)
    cpu = torch.device("cpu")
    seen = []
    res = run_gradient_descent(
        cfg, prob, ft, verbose=False,
        on_iteration=lambda *a: seen.append(graphs.newest("chord", cpu)))
    assert len(seen) == res.iterations_run == 2 and seen[0] is seen[1]
    with pytest.raises(KeyError):
        graphs.newest("chord", cpu)
