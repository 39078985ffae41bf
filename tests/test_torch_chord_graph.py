"""The chord Newton on static buffers (``solve/newton.py::chord_solve`` and
``ChordGraph``) on the CPU, where its step runs eagerly
(``tests/test_torch_cuda.py`` holds the replayed graph to the eager
chord on the card). On ``torch_parallel_cases.tiny_problem`` (Nx=8, 6
buoys; no JAX):

* ``newton_solve``'s chord loop, restructured around ``_chord_step``,
  gives w, iterations and residual norms bit for bit equal to a copy of
  the loop as it was (``_oracle``), in float64 and float32, with 1 and 2
  correction sweeps, on LU and explicit-inverse factors; its full Newton
  branch too;
* ``chord_solve``'s static-buffer body gives the same numbers as
  ``newton_solve``, from w = 0 and from a warm start, and counts no
  graph step on the CPU;
* one ``ChordGraph`` serves every solve with the same factors, tables
  and constants, a ``dataclasses.replace`` copy of the problem included,
  and another factor or viscosity gets its own;
* every ``ns_newton`` record carries ``graph_steps`` (0 on the CPU).
"""

import dataclasses

import pytest
import torch
from torch.func import jvp

from ocean_torch import system
from ocean_torch.ops import linalg
from ocean_torch.solve import newton
from ocean_torch.utils import graphs, timing

from torch_parallel_cases import tiny_problem

torch.set_num_threads(2)


def _oracle(residual_fn, operator_fn, w0, bc_dofs, bc_vals, rtol=1e-9,
            atol=1e-10, max_iter=50, reuse_factorization=False,
            correction_iters=1, fac0=None, residual_fn32=None):
    """``newton_solve`` as it was before the chord step became a function
    of its own (spans and sync counts left out)."""
    is_bc = torch.zeros(w0.shape[0], dtype=torch.bool, device=w0.device)
    is_bc[bc_dofs] = True
    g_full = torch.zeros_like(w0).index_copy(0, bc_dofs, bc_vals)

    def bc_residual(w):
        return torch.where(is_bc, w - g_full, residual_fn(w))

    if residual_fn32 is not None:
        g_full32 = g_full.to(torch.float32)

        def bc_residual32(w32):
            return torch.where(is_bc, w32 - g_full32, residual_fn32(w32))

    def residual_and_norm(w):
        r = bc_residual(w)
        return r, torch.linalg.norm(r).item()

    r, r0norm = residual_and_norm(w0)
    if fac0 is None:
        fac0 = linalg.factorize(operator_fn(w0).dense())
    w, rnorm, it, fac = w0, r0norm, 0, fac0
    while rnorm > atol and rnorm > rtol * r0norm and it < max_iter:
        if not reuse_factorization and it > 0:
            fac = fac.refactor(operator_fn(w).dense())
        if reuse_factorization and residual_fn32 is not None:
            w32, r32 = w.to(torch.float32), r.to(torch.float32)
            dw32 = fac0.solve32_raw(-r32)
            for _ in range(correction_iters):
                _, jdw = jvp(bc_residual32, (w32,), (dw32,))
                dw32 = dw32 + fac0.solve32_raw(-(r32 + jdw))
            dw = dw32.to(torch.float64)
        elif reuse_factorization:
            dw = fac0.solve(-r)
            for _ in range(correction_iters):
                _, jdw = jvp(bc_residual, (w,), (dw,))
                dw = dw + fac0.solve(-(r + jdw))
        else:
            dw = fac.solve(-r)
        w = w + dw
        r, rnorm = residual_and_norm(w)
        it += 1
    converged = (rnorm <= atol) or (rnorm <= rtol * r0norm)
    return newton.NewtonResult(w, it, rnorm, converged, fac)


# factor kinds: float64 LU, float32 LU (the float32 chord's), the explicit
# float32 inverse
FACTORS = {"lu64": dict(newton_reuse_lu=True),
           "lu32": dict(newton_reuse_lu=True, newton_chord_f32=True),
           "inverse": dict(newton_reuse_lu=True, dense_apply="inverse")}


@pytest.fixture(scope="module")
def problems():
    return {name: tiny_problem("cpu", **kw) for name, kw in FACTORS.items()}


def _controls(prob):
    """Three loads: two presets and a strong one (more Newton steps)."""
    return [system.initial_control(prob, 0).quad,
            system.initial_control(prob, 4).quad,
            40.0 * system.initial_control(prob, 2).quad]


def _args(prob, f_quad, float32):
    residual32 = None
    if float32:
        space32 = newton.float32_tables(prob.space)
        bq32 = newton.float32_tables(prob.bq)
        f_quad32 = f_quad.to(torch.float32)

        def residual32(w32):
            return system.assemble.ns_residual(space32, bq32, w32, f_quad32,
                                               prob.nu)
    return ((system._residual_at(prob, f_quad, prob.nu),
             system._operator_at(prob, prob.nu)),
            residual32)


def _zeros(prob):
    return torch.zeros(prob.space.ndof, dtype=torch.float64)


def _same(a, b):
    assert torch.equal(a.w, b.w)
    assert (a.iterations, a.residual_norm, a.converged) == \
        (b.iterations, b.residual_norm, b.converged)


CHORDS = pytest.mark.parametrize(
    "factor,float32",
    [("lu64", False), ("lu32", True), ("inverse", False), ("inverse", True)])


@CHORDS
@pytest.mark.parametrize("sweeps", [1, 2])
def test_the_chord_loop_is_the_old_loop(problems, factor, float32, sweeps):
    prob = problems[factor]
    for f_quad in _controls(prob):
        fns, residual32 = _args(prob, f_quad, float32)
        kw = dict(reuse_factorization=True, correction_iters=sweeps,
                  fac0=prob.fac0, residual_fn32=residual32)
        got = newton.newton_solve(*fns, _zeros(prob), prob.bc_dofs,
                                  prob.bc_vals, **kw)
        want = _oracle(*fns, _zeros(prob), prob.bc_dofs, prob.bc_vals, **kw)
        assert got.iterations >= 2 and got.converged
        _same(got, want)
        assert got.graph_steps == 0


def test_the_full_newton_is_the_old_loop(problems):
    prob = problems["lu64"]
    f_quad = _controls(prob)[2]
    fns, _ = _args(prob, f_quad, False)
    got = newton.newton_solve(*fns, _zeros(prob), prob.bc_dofs, prob.bc_vals)
    want = _oracle(*fns, _zeros(prob), prob.bc_dofs, prob.bc_vals)
    assert got.iterations >= 3
    _same(got, want)
    assert torch.equal(got.fac.lu, want.fac.lu)


@CHORDS
@pytest.mark.parametrize("sweeps", [1, 2])
def test_the_static_body_is_the_chord(problems, factor, float32, sweeps):
    prob = problems[factor]
    warm = None
    for f_quad in _controls(prob) + [None]:
        w0 = _zeros(prob)
        if f_quad is None:          # a warm start near the last solution
            f_quad, w0 = 0.9 * last, warm
        fns, residual32 = _args(prob, f_quad, float32)
        want = newton.newton_solve(
            *fns, w0, prob.bc_dofs, prob.bc_vals, reuse_factorization=True,
            correction_iters=sweeps, fac0=prob.fac0,
            residual_fn32=residual32)
        got = newton.chord_solve(prob.space, prob.bq, f_quad, prob.nu, w0,
                                 prob.bc_dofs, prob.bc_vals, prob.fac0,
                                 sweeps, float32=float32)
        _same(got, want)
        assert got.graph_steps == 0 and got.fac is prob.fac0
        warm, last = got.w, f_quad


def _graph_for(prob, f_quad):
    newton.chord_solve(prob.space, prob.bq, f_quad, prob.nu, _zeros(prob),
                       prob.bc_dofs, prob.bc_vals, prob.fac0,
                       prob.newton_correction_iters,
                       float32=prob.newton_chord_f32)
    return graphs.newest("chord", torch.device("cpu"))


def test_one_graph_serves_a_problem_and_its_copies(problems):
    prob = problems["inverse"]
    f1, f2, _ = _controls(prob)
    first = _graph_for(prob, f1)
    assert _graph_for(prob, f2) is first
    copy = dataclasses.replace(prob, solve_log=[])
    assert _graph_for(copy, f1) is first
    assert first.graphs[0] is not None and not first.graphed
    other = dataclasses.replace(prob, fac0=linalg.InvSolver(
        prob.fac0.ainv.clone(), prob.fac0.ainv_t))
    second = _graph_for(other, f1)
    assert second is not first
    assert _graph_for(dataclasses.replace(other, newton_correction_iters=2),
                      f1) is not second
    assert _graph_for(prob, f1) is not first       # the newest is kept


def test_a_solve_reuses_the_static_buffers(problems):
    prob = problems["lu64"]
    f1, f2, _ = _controls(prob)
    a = newton.chord_solve(prob.space, prob.bq, f1, prob.nu, _zeros(prob),
                           prob.bc_dofs, prob.bc_vals, prob.fac0)
    w_a = a.w.clone()
    newton.chord_solve(prob.space, prob.bq, f2, prob.nu, _zeros(prob),
                       prob.bc_dofs, prob.bc_vals, prob.fac0)
    assert torch.equal(a.w, w_a)          # the result is not the buffer


def test_the_solve_log_counts_graph_steps(problems):
    """A GD step with its line search: every "ns_newton" record and span
    carries ``graph_steps``, 0 on the CPU."""
    prob = dataclasses.replace(problems["inverse"], solve_log=[])
    f = system.initial_control(prob, 0)
    timing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = system.gd_step(prob, f, 1.0, use_line_search=True)
    rec = timing.recorded()
    timing.clear()
    assert not res.diverged
    logs = [r for r in prob.solve_log if r["solve"] == "ns_newton"]
    spans = [s for s in rec if s.name == "ns_newton"]
    assert len(logs) == len(spans) >= 2
    assert [r["graph_steps"] for r in logs] == [0] * len(logs)
    assert [s.attrs["graph_steps"] for s in spans] == [0] * len(spans)


def test_the_spans_and_syncs_of_a_chord_solve(problems):
    """A first norm read, then a step and a norm read an iteration, each a
    span of its own; one counted sync a norm read."""
    prob = problems["inverse"]
    f_quad = _controls(prob)[2]
    timing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span("ns_newton"):
            res = newton.chord_solve(prob.space, prob.bq, f_quad, prob.nu,
                                     _zeros(prob), prob.bc_dofs,
                                     prob.bc_vals, prob.fac0)
    rec = [s for s in timing.recorded() if s.name != "gc"]
    timing.clear()
    names = [s.name for s in rec]
    assert names == (["ns_newton", "newton.residual"]
                     + ["newton.step", "newton.residual"] * res.iterations)
    assert [s.attrs.get("graph") for s in rec[2::2]] == [0] * res.iterations
    assert [s.syncs for s in rec] == [0, 1] + [0, 1] * res.iterations


def test_a_chord_without_the_stokes_factor_is_refused(problems):
    """``solve_ns`` runs every chord on the problem's factor; without one
    it raises, and the full Newton of the same problem still solves."""
    prob = problems["lu32"]
    f_quad = _controls(prob)[0]
    with pytest.raises(ValueError, match="fac0"):
        system.solve_ns(dataclasses.replace(prob, fac0=None), f_quad)
    full = system.solve_ns(
        dataclasses.replace(prob, fac0=None, newton_reuse_lu=False), f_quad)
    fns, _ = _args(prob, f_quad, False)
    want = newton.newton_solve(*fns, _zeros(prob), prob.bc_dofs,
                               prob.bc_vals)
    assert full.converged
    _same(full, want)
