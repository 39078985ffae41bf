"""The readers of the program's own spans (``program_spans`` and the four
metrics on it): device idle inside nested spans, the join of the
program's clock to the trace's through the enclosing benchmark spans, no
reading where the pairs do not match, and the four metrics in the traced
runs of both cells on the CPU."""

import math

import pytest

from benchmark import harness, program_spans, tracing
from ocean_torch.utils.timing import SpanRecord

from conftest import SMALL

WALL0 = 1_792_000_000_003_000_000    # the profiler's start, 3 ms planted
METRICS = ("host.syncs_per_iter", "newton.idle_ms_per_iter",
           "ode.idle_ms_per_solve", "adjoint.idle_ms_per_solve")
# the benchmark's ns_newton spans, seconds from the profiler's start
BENCH = [(0.10, 0.30), (0.50, 0.60)]


def _ns(t):
    return WALL0 + round(t * 1e9)


def _job(job=0, shift=0.0, newton=BENCH, its=(4, 2)):
    """A job's record: each program ns_newton 1 us inside its benchmark
    span (moved by ``shift`` s), a primal ODE after each, an adjoint with
    a child at the end, 3 syncs an iteration."""
    def rec(name, s, e, parent, it=-1, **attrs):
        return SpanRecord(name, _ns(s + shift), parent, job, it, attrs,
                          end_ns=_ns(e + shift))
    out = [rec("gd_job", 0.0, 0.95, -1)]
    out.append(rec("gd_iteration", 0.0, 0.95, 0, it=0, i=0))
    out[-1].syncs = 3
    for (s, e), n in zip(newton, its):
        r = rec("ns_newton", s, e, 1, it=0, iterations=n)
        r.start_ns += 1000
        r.end_ns -= 1000
        out.append(r)
        out.append(rec("primal_ode", e, e + 0.05, 1, it=0, steps=199))
    out.append(rec("adjoint", 0.70, 0.90, 1, it=0, rounds=3))
    out.append(rec("adjoint_solve", 0.80, 0.90, len(out) - 1, it=0))
    return out


def _trace(kernels, window_s=1.0):
    return tracing.Trace(window_s=window_s, kernels=kernels, lu=[],
                         spans=[("ns_newton", s, e) for s, e in BENCH]
                         + [("primal_ode", 0.3, 0.35)])


def _ctx(trace):
    return harness.Context(cell="c", cfg={}, K=1, window={}, solve_log=[],
                           setup_seconds={}, trace=trace)


def test_idle_inside_nested_spans():
    busy = [[0.1, 0.3], [0.5, 0.6]]
    # [0, 0.4] holds [0.2, 0.35]: once; [0.55, 0.7]; [0.9, 1.2] past the
    # window's end at 1.0
    got = program_spans.idle_inside(
        busy, [(0.0, 0.4), (0.2, 0.35), (0.55, 0.7), (0.9, 1.2)], 1.0)
    assert got == pytest.approx((0.4 - 0.2) + (0.15 - 0.05) + 0.1)
    assert program_spans.idle_inside(busy, [], 1.0) == 0.0


def test_the_join_recovers_the_planted_offset():
    job = program_spans.traced_job(_trace([]), _job())
    assert job.offset_ns == WALL0 + 1000 and job.misfit_ns == 0
    assert job.pairs == 2
    placed = job.placed("ns_newton")
    assert placed[0][0] == pytest.approx(0.10, abs=1e-12)
    assert placed[1][1] == pytest.approx(0.60 - 2e-6, abs=1e-12)


def test_the_traced_job_is_picked_among_several():
    # job 0 is the same job 40 s earlier: it fits as well, and the latest
    # of equal fits is taken; job 2 pairs in number but not in time, job
    # 3 not in number; job 1 is the traced one
    record = (_job(0, shift=-40.0) + _job(1) + _job(2, newton=[
        (0.10, 0.30), (0.70, 0.80)]) + _job(3, newton=BENCH[:1],
                                          its=(4,)))
    job = program_spans.traced_job(_trace([]), record)
    assert {s.job for s in job.spans} == {1}


def test_nothing_to_read_where_the_pairs_do_not_match():
    tr = _trace([])
    assert program_spans.traced_job(None, _job()) is None
    assert program_spans.traced_job(tr, []) is None
    assert program_spans.traced_job(tr, _job(newton=BENCH[:1],
                                             its=(4,))) is None
    # the same number of pairs, offsets spread past the shortest span
    assert program_spans.traced_job(tr, _job(newton=[
        (0.10, 0.30), (0.70, 0.80)])) is None
    no_newton = tracing.Trace(window_s=1.0, kernels=[], lu=[], spans=[])
    assert program_spans.traced_job(no_newton, _job()) is None


def test_the_readers(monkeypatch):
    record = _job()
    monkeypatch.setattr(program_spans, "program_record", lambda: record)
    kernels = [("gemm", 0.15, 0.25), ("copy", 0.32, 0.34),
               ("ode", 0.62, 0.64), ("gemv", 0.75, 0.85)]
    ctx = _ctx(_trace(kernels))
    got = {m: harness.load_metric(m).read(ctx) for m in METRICS}
    assert got["host.syncs_per_iter"] == 3.0
    # ns_newton [0.1, 0.3 − 2 us] and [0.5, 0.6 − 2 us] on the trace's
    # axis, busy 0.15–0.25: idle 0.1 + 0.1 s over 6 iterations
    assert got["newton.idle_ms_per_iter"] == pytest.approx(
        1e3 * (0.2 - 4e-6) / 6)
    # primal_ode [0.3, 0.35] and [0.6, 0.65], 1 us after the shift back:
    # busy 0.32–0.34 and 0.62–0.64
    assert got["ode.idle_ms_per_solve"] == pytest.approx(
        1e3 * (0.03 + 0.03) / 2, rel=1e-4)
    # adjoint [0.7, 0.9], busy 0.75–0.85
    assert got["adjoint.idle_ms_per_solve"] == pytest.approx(100.0,
                                                             rel=1e-4)


def test_the_readers_with_nothing_to_read(monkeypatch):
    monkeypatch.setattr(program_spans, "program_record", lambda: [])
    for ctx in (_ctx(None), _ctx(_trace([]))):
        for m in METRICS:
            assert harness.load_metric(m).read(ctx) is None


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_traced_runs_report_the_four_metrics(small_runs, cell):
    spec = harness.benchmark_spec()
    line = harness.result_line(small_runs[cell], cell, True, {})
    listed = {x["name"] for x in harness.per_layer_metrics(spec, cell)}
    if cell == "square_k10.armijo":
        # the K=10 cell reports no iter_s, so no metric that moves it;
        # its window's timings are read per layer instead
        assert not listed & set(METRICS)
        names = ("driver.iter_s", "driver.iter_p90_s", "driver.solve_s")
    else:
        names = METRICS
    for m in names:
        assert m in listed
        v = line["metrics"][m]["value"]
        assert math.isfinite(v) and v > 0, m
