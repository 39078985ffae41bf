"""The program's spans and host-sync counter (``ocean_torch/utils/timing.py``)
on ``torch_parallel_cases.tiny_problem`` (Nx=8, 6 buoys; no JAX).

Without a profiler a whole ``run_gradient_descent`` records nothing.
Under ``torch.profiler`` (CPU activity) it records one ``gd_job``, a
``gd_iteration`` an iteration, a ``probe`` a line-search trial and an
``ns_newton`` span a primal solve, with the iterations of the solve log,
every span inside its parent; the counted syncs equal a hand count; and
the results are the same tensors either way. Both driver loops (staged
and per-stage). Each test leaves the record empty: other files run in the
same worker.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.opt.driver import run_gradient_descent
from ocean_torch.utils import timing

from torch_parallel_cases import K, LR_ARMIJO, tiny_problem

torch.set_num_threads(2)

STEPS = 3
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_record():
    timing.clear()
    yield
    timing.clear()


@pytest.fixture(scope="module")
def runs():
    """Per loop: (result and solve log without a profiler, the same with
    one, and the record of the profiled run)."""
    prob = tiny_problem("cpu")
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment=f"{K}_buoys",
                    T=0.05, dt=0.005, num_steps=STEPS, LR=LR_ARMIJO,
                    LR_MAX=LR_ARMIJO)
    f0 = system.initial_control(prob, 0)
    out = {}
    for staged in (True, False):
        def job():
            log = []
            p = dataclasses.replace(prob, solve_log=log)
            return run_gradient_descent(cfg, p, f0, staged=staged,
                                        verbose=False), log
        timing.clear()
        off = job()
        unrecorded = timing.recorded()
        with torch.profiler.profile(activities=CPU):
            on = job()
        out[staged] = (off, on, timing.recorded(), unrecorded)
        timing.clear()
    return out


LOOPS = pytest.mark.parametrize("staged", [True, False],
                                ids=["staged", "per_stage"])


@LOOPS
def test_nothing_recorded_without_a_profiler(runs, staged):
    assert runs[staged][3] == []


@LOOPS
def test_spans_of_a_job(runs, staged):
    _, (res, log), rec, _ = runs[staged]
    names = [s.name for s in rec]
    assert names.count("gd_job") == 1 and rec[0].name == "gd_job"
    its = [s for s in rec if s.name == "gd_iteration"]
    assert [s.attrs["i"] for s in its] == list(range(res.iterations_run))
    assert res.iterations_run == STEPS
    assert names.count("probe") == sum(res.inner_iterations) > STEPS
    newton = [s.attrs["iterations"] for s in rec if s.name == "ns_newton"]
    assert newton == [r["iterations"] for r in log
                      if r["solve"] == "ns_newton"]
    assert names.count("adjoint") == STEPS
    assert names.count("trajectory_copy") == STEPS
    for stage in ("newton.residual", "newton.step", "newton.factor",
                  "primal_ode", "adjoint_rhs", "adjoint_ode",
                  "point_sources", "adjoint_assemble", "adjoint_solve",
                  "cost", "gradient"):
        assert stage in names, stage


@LOOPS
def test_every_span_lies_inside_its_parent(runs, staged):
    rec = runs[staged][2]
    for k, s in enumerate(rec):
        assert 0 < s.start_ns <= s.end_ns
        assert s.job == 0
        if k == 0:
            assert s.parent == -1 and s.iteration == -1
            continue
        assert 0 <= s.parent < k
        p = rec[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        own = s.name == "gd_iteration"
        assert s.iteration == (s.attrs["i"] if own else p.iteration)


@LOOPS
def test_sync_count_by_hand(runs, staged):
    """Per iteration: four clocks, the gradient's inner product, J and
    div u recorded, the escape test (the trajectory copy waits for
    nothing: one wait a job, before the return, stands for it); J of each
    forward solve outside a probe (the first iteration's in the staged
    loop; in the per-stage loop also each one after a probe the Armijo
    test did not accept); one J a probe; a Newton solve reads its first
    residual and one a step; an adjoint reads the cell of the domain's
    center (point sources), ‖b‖ and one residual a sweep past the first;
    the wait for the trajectory copies and the last u_values."""
    _, (res, log), rec, _ = runs[staged]
    n, probes = res.iterations_run, sum(res.inner_iterations)
    solves = [r for r in log if r["solve"] == "ns_newton"]
    newton = sum(1 + r["iterations"] for r in solves)
    adjoint = sum(3 + s.attrs["rounds"] for s in rec if s.name == "adjoint")
    begins = len(solves) - probes
    assert 1 <= begins <= (1 if staged else n)
    want = 8 * n + begins + probes + newton + adjoint + 2
    assert sum(s.syncs for s in rec) == want


@LOOPS
def test_results_do_not_depend_on_the_profiler(runs, staged):
    (off, _), (on, _), _, _ = runs[staged]
    assert torch.equal(torch.tensor(off.j_array), torch.tensor(on.j_array))
    assert off.inner_iterations == on.inner_iterations
    assert off.lr == on.lr and off.exit_reason == on.exit_reason
    assert torch.equal(off.f.quad, on.f.quad)
    assert torch.equal(off.f.p2, on.f.p2)
    for a, b in zip(off.x_array, on.x_array):
        assert np.array_equal(a, b)


def test_span_forms_attributes_and_counts():
    @timing.span("decorated", kind=2)
    def work(x):
        with timing.span("inner") as s:
            s.set(size=x.numel())
            timing.count(rounds=2)
            timing.count(rounds=1)
            return timing.to_host(x.sum())

    assert timing.span("idle") is timing.span("idle")
    assert work(torch.ones(4)) == 4.0 and timing.recorded() == []
    with torch.profiler.profile(activities=CPU):
        with timing.span("outer"):
            got = work(torch.ones(3))
    assert got == 3.0
    rec = timing.recorded()
    outer, dec, inner = [s for s in rec if s.name != "gc"]
    assert (outer.name, dec.name, inner.name) == ("outer", "decorated",
                                                  "inner")
    assert rec[dec.parent] is outer and rec[inner.parent] is dec
    assert dec.attrs == {"kind": 2, "rounds": 3}
    assert inner.attrs == {"size": 3, "rounds": 3}
    assert outer.attrs == {"rounds": 3}
    assert (outer.syncs, dec.syncs, inner.syncs) == (0, 0, 1)


def test_to_host_and_sync_are_counted():
    x = torch.arange(4, dtype=torch.float64)
    with torch.profiler.profile(activities=CPU):
        with timing.span("reads"):
            f = timing.to_host(x.sum())
            i = timing.to_host(x.to(torch.int64).sum())
            b = timing.to_host(torch.isfinite(x.sum()))
            a = timing.to_host(x)
            timing.sync(torch.device("cpu"))
            timing.sync([x, {"y": x}])
    assert (type(f), type(i), type(b)) == (float, int, bool)
    assert (f, i, b) == (6.0, 6, True)
    assert isinstance(a, np.ndarray) and np.array_equal(a, x.numpy())
    (reads,) = [s for s in timing.recorded() if s.name != "gc"]
    assert reads.syncs == 6


def test_a_collection_inside_a_span_is_a_gc_span():
    with torch.profiler.profile(activities=CPU):
        with timing.span("work"):
            gc.collect()
    assert timing._on_gc not in gc.callbacks
    work, *rest = timing.recorded()
    collections = [s for s in rest if s.name == "gc"]
    assert any(s.attrs == {"generation": 2} for s in collections)
    for s in collections:
        assert s.parent == 0
        assert work.start_ns <= s.start_ns <= s.end_ns <= work.end_ns
