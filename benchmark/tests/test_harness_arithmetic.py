"""The window's arithmetic, the byte and operation counts of the roofline
metrics against hand counts, and the per-layer readers."""

import math
import statistics

import pytest

from benchmark import harness, kernel_bytes, peaks, tracing


def _result(times, jobs, peak=3 * 2 ** 30, setup=12.5):
    return {"window": {"seconds": sum(times), "iterations": len(times),
                       "iteration_times": times, "jobs": jobs},
            "peak_bytes": peak, "setup_s": setup}


def test_iter_s_is_all_time_over_all_iterations():
    # two whole jobs (a slow first iteration each) and a cut third
    times = [2.0] + [0.1] * 29 + [2.1] + [0.1] * 29 + [2.0, 0.1, 0.1]
    r = _result(times, jobs=[2.0 + 2.9, 2.1 + 2.9])
    e = harness.end_to_end(r)
    assert e["iter_s"] == pytest.approx(sum(times) / 63)
    assert e["solve_s"] == pytest.approx((4.9 + 5.0) / 2)   # whole jobs only
    assert e["peak_mem_gib"] == 3.0
    assert e["setup_s"] == 12.5


def test_p90_is_taken_over_every_iteration():
    times = [float(i) for i in range(1, 101)]
    e = harness.end_to_end(_result(times, jobs=[sum(times)]))
    assert e["iter_p90_s"] == pytest.approx(90.1)
    assert e["iter_p90_s"] == statistics.quantiles(
        times, n=10, method="inclusive")[8]


def test_kernel_bytes_against_hand_counts():
    # K = 2 buoys, nt = 3 samples, a 1 x 1 grid: half-grid 3 x 3, vertex
    # grid 2 x 2
    # primal: x0 4 doubles, image 18, x and u 2·12: 46 doubles, 2·2 int32
    assert kernel_bytes.primal_ode(2, 3, 1, 1) == 46 * 8 + 4 * 4
    # adjoint: x, u − u_d, μ 3·12 doubles, image 16, windows 2 int32
    assert kernel_bytes.adjoint_ode(2, 3, 1, 1) == 52 * 8 + 2 * 4
    # point sources: 6 points · (2 + 2) doubles in, image 18 · 2 limbs out
    assert kernel_bytes.point_sources(2, 3, 1, 1) == 24 * 8 + 36 * 8


def _ctx(trace, **kw):
    return harness.Context(cell="c", cfg={"resolution": 1, "T": 1.0,
                                          "dt": 1 / 3}, K=2,
                           window={"inner_iterations": [12, 1, 1, 2],
                                   "jobs": []},
                           solve_log=[{"solve": "ns_newton", "iterations": 4},
                                      {"solve": "adjoint"},
                                      {"solve": "ns_newton", "iterations": 6}],
                           setup_seconds={"a": 1.5, "b": 2.0}, trace=trace,
                           **kw)


def test_lu_roofline_counts_two_thirds_n_cubed():
    tr = tracing.Trace(window_s=1.0, kernels=[], spans=[],
                       lu=[(1000, 1, 0.01), (1000, 2, 0.03),
                           (1000, 1, 0.0)])
    got = harness.load_metric("linalg.lu_roofline_pct").read(_ctx(tr))
    flops = 3 * (2 / 3) * 1000 ** 3
    assert got == pytest.approx(100 * flops / peaks.FP64_TENSOR_FLOP_PER_S
                                / 0.04)


def test_an_lu_takes_the_device_time_of_what_it_launched():
    # launches at host ns 100..900; the LU's span holds those at 300-500
    launches = [(100, 1), (300, 2), (400, 3), (500, 4), (900, 5)]
    device_ops = {1: [(0.0, 1.0)], 2: [(2.0, 2.5)],
                  3: [(2.4, 3.0), (3.5, 3.75)], 4: [(5.0, 5.25)],
                  5: [(9.0, 10.0)]}
    got = tracing.lu_device_seconds([(64, 1, 300, 500), (64, 1, 600, 800)],
                                    launches, device_ops)
    # 2.0-3.0 merged, 3.5-3.75, 5.0-5.25: idle gaps between them left out
    assert got == [(64, 1, pytest.approx(1.5)), (64, 1, 0.0)]


def test_kernel_roofline_is_time_weighted():
    tr = tracing.Trace(window_s=1.0, spans=[], lu=[], kernels=[
        ("void primal_ode_kernel<RectGeom>(...)", 0.0, 1e-6),
        ("void primal_ode_kernel<RectGeom>(...)", 1.0e-5, 1.2e-5),
        ("void adjoint_ode_kernel<RectGeom>(...)", 2e-5, 2.5e-5),
        ("gemm", 3e-5, 9e-5)])
    got = harness.load_metric("kernels.roofline_pct").read(_ctx(tr))
    least = (2 * kernel_bytes.primal_ode(2, 3, 1, 1)
             + kernel_bytes.adjoint_ode(2, 3, 1, 1)) / peaks.HBM_BYTES_PER_S
    assert got == pytest.approx(100 * least / (1e-6 + 2e-6 + 5e-6))


def test_readers_with_nothing_to_read_return_none():
    empty = tracing.Trace(window_s=1.0, kernels=[], spans=[], lu=[])
    for name in ("linalg.lu_roofline_pct", "kernels.roofline_pct",
                 "linalg.device_pct"):
        assert harness.load_metric(name).read(_ctx(empty)) is None
        assert harness.load_metric(name).read(_ctx(None)) is None


def test_counter_readers():
    ctx = _ctx(None)
    assert harness.load_metric("linesearch.probes_per_iter").read(ctx) == 4.0
    assert harness.load_metric("newton.iters_per_solve").read(ctx) == 5.0
    assert harness.load_metric("setup.build_s").read(ctx) == 3.5


def test_idle_share_and_gaps_by_span():
    tr = tracing.Trace(window_s=1.0, lu=[], kernels=[
        ("gemm", 0.1, 0.3), ("copy", 0.25, 0.4), ("gemm", 0.8, 0.9)],
        spans=[("ns_newton", 0.0, 0.5), ("primal_ode", 0.5, 0.7)])
    assert tr.busy_s() == pytest.approx(0.4)
    idle = harness.load_metric("device.idle_pct").read(_ctx(tr))
    assert idle == pytest.approx(60.0)
    gaps = tr.idle_gaps()
    assert gaps["ns_newton"] == pytest.approx(0.1)      # 0.0–0.1
    assert gaps["primal_ode"] == pytest.approx(0.4)     # 0.4–0.8
    assert gaps["gd_loop"] == pytest.approx(0.1)         # 0.9–1.0
    assert math.isclose(sum(gaps.values()), 0.6)
    share = harness.load_metric("linalg.device_pct").read(_ctx(tr))
    assert share == pytest.approx(100 * 0.3 / 0.4)
