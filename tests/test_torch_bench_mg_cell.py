"""The benchmark's multigrid cell ``square_nx64_mg.armijo`` and the spans of
the Krylov and multigrid layer (``solve/krylov.py``, ``solve/mg.py``).

* The cell at a small size on the CPU (Nx=8, a 4 × 4 start grid): the
  configuration puts the port on the multigrid path, and the run reads
  ``correct`` against the benchmark's plain reference.
* Under ``torch.profiler`` a multigrid solve records an ``fgmres`` span a
  Krylov call with ``arnoldi_steps`` = cycles × restart, and the
  ``mg.precond``, ``newton.step`` and ``mg.refine`` spans; every norm read
  of the layer is a counted host sync.
* The spans change no number: ``fgmres`` gives the same ``x`` as the
  unspanned loop (kept here as it was), recorder on or off.
* The Krylov cycle's CUDA graph changes no number: a reloaded stencil
  matvec is a fresh one bit for bit, and so is the Newton that uses it;
  on the card (marker ``cuda``, ``python -m pytest
  tests/test_torch_bench_mg_cell.py -m cuda``) the graphed ``fgmres`` and
  Newton equal the eager ones, and a graph serves later calls whose
  operator changed in place.
* The three per-layer metrics of the cell on synthetic records, and
  nothing to read where nothing was recorded.
* ``chip_smoke.py``'s copy of the Nx=64 study's record.

No JAX; a few seconds.
"""

import ast
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, program_spans, tracing  # noqa: E402
from ocean_torch import system  # noqa: E402
from ocean_torch.solve import krylov  # noqa: E402
from ocean_torch.utils import graphs, timing  # noqa: E402
from ocean_torch.utils.timing import SpanRecord  # noqa: E402

torch.set_num_threads(2)

CELL = "square_nx64_mg.armijo"
SMALL = dict(resolution=8, starts={"grid": [[0.1, 0.4, 4], [0.25, 1.75, 4]]},
             alpha_buoys=16, num_steps=8)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_record():
    timing.clear()
    yield
    timing.clear()


@pytest.fixture(scope="module")
def small_problem():
    """The cell's problem at Nx=8 and its initial control."""
    from benchmark import inputs
    cell, cfg, traffic = harness.load_cell(CELL, SMALL)
    x0, u_d = inputs.make(cfg, traffic, 0, torch.device("cpu"))
    prob = system.build_problem(harness.port_config(cfg), u_d=u_d, x0=x0,
                                device="cpu")
    return prob, system.initial_control(prob, cfg["program_initial_case"])


# --- the cell -----------------------------------------------------------------

def test_the_configuration_is_the_multigrid_path(small_problem):
    _, cfg, _ = harness.load_cell(CELL)
    assert cfg["resolution"] == 64 and cfg["alpha_buoys"] == 400
    pcfg = harness.port_config(cfg)
    assert pcfg.linear_solver == "mg"
    assert (pcfg.ode_backend, pcfg.psrc_method) == ("pallas", "fused")
    assert small_problem[0].linear_solver == "mg"
    assert small_problem[0].mg is not None


def test_the_cell_runs_correct_at_a_small_size():
    r = harness.run_cell(CELL, 3300002101, 0.5, False, time.perf_counter(),
                         device="cpu", overrides=SMALL)
    assert r["correct"], r["table"]
    assert r["sample"][0] == 0 and len(r["sample"]) == 3
    assert 1 <= r["sample"][1] < r["sample"][2] <= 6
    steps = [c for rec in r["solve_log"] if rec["solve"] == "ns_newton"
             for c in rec["krylov_cycles"]]
    assert steps and all(c >= 1 for c in steps)


# --- the spans ------------------------------------------------------------------

def _by_name(rec, name):
    return [s for s in rec if s.name == name]


def test_a_multigrid_solve_records_the_krylov_and_mg_spans(small_problem):
    prob, f0 = small_problem
    with torch.profiler.profile(activities=CPU):
        fwd = system.forward(prob, f0.quad)
        system._solve_adjoint_flagged(prob, fwd)
    rec = timing.recorded()
    fg = _by_name(rec, "fgmres")
    steps = _by_name(rec, "newton.step")
    refine = _by_name(rec, "mg.refine")
    assert fg and steps and refine and _by_name(rec, "mg.precond")
    for s in fg:
        assert s.attrs["arnoldi_steps"] == s.attrs["cycles"] * 60
        assert s.attrs["dtype"] == 32
        # ‖b‖, ‖r₀‖, and a cycle's β, Hessenberg copy and ‖r‖
        assert s.syncs == 2 + 3 * s.attrs["cycles"]
    assert [s.attrs["cycles"] for s in steps] == list(
        fwd.newton.krylov_cycles)
    assert all(s.attrs["theta"] in (1.0, 0.5, 0.25, 0.125) for s in steps)
    # each step's FGMRES lies inside it; the damping's reads are its
    # newton.residual spans, one counted sync each
    for s in steps:
        inner = [f for f in fg if s.start_ns <= f.start_ns
                 and f.end_ns <= s.end_ns]
        assert [f.attrs["cycles"] for f in inner] == [s.attrs["cycles"]]
    residuals = _by_name(rec, "newton.residual")
    assert len(residuals) >= len(steps) + 1
    assert all(s.syncs == 1 for s in residuals)
    assert all(s.syncs == 1 and s.attrs["cycles"] >= 1 for s in refine)
    adjoint = _by_name(rec, "adjoint")[0]
    assert adjoint.attrs["rounds"] == len(refine)


def _fgmres_unspanned(matvec, b, M=None, x0=None, restart=60,
                      max_restarts=10, tol=1e-10):
    """``krylov.fgmres`` before it had a span and counted its reads."""
    if M is None:
        M = lambda v: v
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = torch.finfo(b.dtype).tiny
    target = tol * max(float(torch.linalg.norm(b)), tiny)
    r = b - matvec(x)
    rnorm = float(torch.linalg.norm(r))
    it = 0
    while rnorm > target and it < max_restarts:
        beta = torch.linalg.norm(r)
        V = b.new_zeros((restart + 1, b.shape[0]))
        Z = b.new_zeros((restart, b.shape[0]))
        H = b.new_zeros((restart + 1, restart))
        V[0] = r / beta.clamp_min(tiny)
        for j in range(restart):
            z = M(V[j])
            w = matvec(z)
            hs = V[: j + 1] @ w
            w = w - hs @ V[: j + 1]
            h2 = V[: j + 1] @ w
            w = w - h2 @ V[: j + 1]
            hs = hs + h2
            hnew = torch.linalg.norm(w)
            V[j + 1] = w / hnew.clamp_min(tiny)
            H[: j + 1, j] = hs
            H[j + 1, j] = hnew
            Z[j] = z
        h = H.detach().to("cpu", torch.float64).numpy()
        e1 = np.zeros(h.shape[0])
        e1[0] = float(beta)
        y = torch.as_tensor(np.linalg.lstsq(h, e1, rcond=None)[0],
                            dtype=b.dtype, device=b.device)
        x_new = x + y @ Z
        r_new = b - matvec(x_new)
        rnorm_new = float(torch.linalg.norm(r_new))
        if rnorm_new < rnorm:
            x, r, rnorm = x_new, r_new, rnorm_new
        it += 1
    return x, rnorm, it


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_span_changes_no_number(dtype):
    g = torch.Generator().manual_seed(21)
    n = 120
    a = (torch.randn(n, n, generator=g, dtype=torch.float64) / n ** 0.5
         + 2.0 * torch.eye(n, dtype=torch.float64)).to(dtype)
    b = torch.randn(n, generator=g, dtype=torch.float64).to(dtype)
    d = 1.0 / torch.diagonal(a)
    kw = dict(M=lambda v: d * v, restart=7, max_restarts=5, tol=1e-12)
    x_ref, rnorm_ref, it_ref = _fgmres_unspanned(lambda v: a @ v, b, **kw)
    off = krylov.fgmres(lambda v: a @ v, b, **kw)
    with torch.profiler.profile(activities=CPU):
        on = krylov.fgmres(lambda v: a @ v, b, **kw)
    (span,) = timing.recorded()
    for got in (off, on):
        assert torch.equal(got.x, x_ref)
        assert (got.residual_norm, got.iterations) == (rnorm_ref, it_ref)
    assert span.attrs == {"cycles": it_ref, "arnoldi_steps": 7 * it_ref,
                          "dtype": torch.finfo(dtype).bits}


# --- the Krylov cycle's graph ------------------------------------------------------

def _jacobians(prob, f0):
    """Two Jacobians of the small problem's Navier–Stokes residual."""
    w1 = system.forward(prob, f0.quad).w
    op_at = system._operator_at(prob, prob.nu)
    return op_at(torch.zeros_like(w1)), op_at(w1)


def test_a_reloaded_matvec_applies_each_operator_bit_for_bit(small_problem):
    from ocean_torch.ops import stencil
    prob, f0 = small_problem
    st = prob.mg.st_mixed
    x = torch.randn(prob.space.ndof, generator=torch.Generator()
                    .manual_seed(5), dtype=torch.float64).to(torch.float32)
    mv = stencil.ReloadableMatvec(st)
    for op in _jacobians(prob, f0):
        assert mv.load(op) is mv
        assert torch.equal(mv(x), stencil.matvec_of(st)(op)(x))
        assert mv.bc.data_ptr() != op.bc_dofs.data_ptr()   # a copy


def _newton_pair(prob, f0):
    """The multigrid Newton from w = 0 on its default path and with a
    fresh stencil matvec a step passed in (no reloaded matvec, no graph)."""
    from ocean_torch.ops import stencil
    w0 = torch.zeros(prob.space.ndof, dtype=torch.float64,
                     device=prob.space.device)
    default = system._newton_at(prob, f0.quad, prob.nu, w0)
    fresh = system._newton_at(
        prob, f0.quad, prob.nu, w0,
        matvec_of=stencil.matvec_of(prob.mg.st_mixed, torch.float32))
    return default, fresh


def test_the_reloaded_newton_changes_no_number(small_problem):
    default, fresh = _newton_pair(*small_problem)
    assert torch.equal(default.w, fresh.w)
    assert default.krylov_cycles == fresh.krylov_cycles
    assert default.iterations == fresh.iterations


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_cycle_graph_is_the_eager_cycle_on_the_card(card):
    g = torch.Generator().manual_seed(21)
    n = 3000
    a = (torch.randn(n, n, generator=g, dtype=torch.float64) / n ** 0.5
         + 2.0 * torch.eye(n, dtype=torch.float64)).to(card, torch.float32)
    b = torch.randn(n, generator=g, dtype=torch.float64).to(card,
                                                             torch.float32)
    d = 1.0 / torch.diagonal(a)
    mv, M = (lambda v: a @ v), (lambda v: d * v)
    kw = dict(M=M, restart=20, max_restarts=3, tol=1e-12)
    eager = krylov.fgmres(mv, b, **kw)
    graphed = krylov.fgmres(mv, b, graph=True, **kw)
    cycle = graphs.newest("cycle", b.device)
    again = krylov.fgmres(mv, b, graph=True, **kw)
    assert graphs.newest("cycle", b.device) is cycle
    a.mul_(1.5)                  # the graph reads the operator in place
    eager2 = krylov.fgmres(mv, b, **kw)
    graphed2 = krylov.fgmres(mv, b, graph=True, **kw)
    for e, got in ((eager, graphed), (eager, again), (eager2, graphed2)):
        assert torch.equal(got.x, e.x)
        assert (got.residual_norm, got.iterations) == (e.residual_norm,
                                                       e.iterations)
    assert not torch.equal(eager.x, eager2.x)


@pytest.mark.cuda
def test_the_graphed_newton_is_the_eager_newton_on_the_card(card):
    from benchmark import inputs
    cell, cfg, traffic = harness.load_cell(CELL, SMALL)
    x0, u_d = inputs.make(cfg, traffic, 0, card)
    prob = system.build_problem(harness.port_config(cfg), u_d=u_d, x0=x0,
                                device=card)
    f0 = system.initial_control(prob, cfg["program_initial_case"])
    default, fresh = _newton_pair(prob, f0)
    assert torch.equal(default.w, fresh.w)
    assert default.krylov_cycles == fresh.krylov_cycles


# --- the per-layer metrics ---------------------------------------------------------

WALL0 = 1_792_000_000_005_000_000
BENCH = [(0.10, 0.50)]          # the benchmark's ns_newton span


def _ns(t):
    return WALL0 + round(t * 1e9)


def _record():
    """A job: one ns_newton (1 us inside the benchmark's), a Newton step
    with two FGMRES calls one after the other, the second holding a
    nested one (a coarse solve) that must not count twice."""
    def rec(name, s, e, parent, **attrs):
        return SpanRecord(name, _ns(s), parent, 0, 0, attrs, end_ns=_ns(e))
    out = [rec("gd_job", 0.0, 0.9, -1), rec("gd_iteration", 0.0, 0.9, 0, i=0)]
    newton = rec("ns_newton", 0.10, 0.50, 1, iterations=1)
    newton.start_ns += 1000
    newton.end_ns -= 1000
    out.append(newton)
    out.append(rec("newton.step", 0.15, 0.45, 2, cycles=3))
    out.append(rec("fgmres", 0.20, 0.30, 3, cycles=1, arnoldi_steps=60,
                   dtype=32))
    out.append(rec("fgmres", 0.32, 0.40, 3, cycles=2, arnoldi_steps=120,
                   dtype=32))
    out.append(rec("fgmres", 0.33, 0.35, 5, cycles=1, arnoldi_steps=5,
                   dtype=32))
    return out


def _trace(kernels):
    return tracing.Trace(window_s=1.0, kernels=kernels, lu=[],
                         spans=[("ns_newton", s, e) for s, e in BENCH])


def _ctx(trace, solve_log=()):
    return harness.Context(cell=CELL, cfg={}, K=16, window={},
                           solve_log=list(solve_log), setup_seconds={},
                           trace=trace)


def test_cycles_per_newton_step_reads_the_solve_log():
    read = harness.load_metric("krylov.cycles_per_newton_step").read
    log = [{"solve": "ns_newton", "iterations": 3, "krylov_cycles": [4, 4, 1]},
           {"solve": "adjoint", "krylov_cycles": 9},
           {"solve": "ns_newton", "iterations": 2, "krylov_cycles": [4, 2]}]
    assert read(_ctx(None, log)) == pytest.approx(15 / 5)
    dense = [{"solve": "ns_newton", "iterations": 4, "krylov_cycles": []}]
    assert read(_ctx(None, dense)) is None
    assert read(_ctx(None)) is None


def test_krylov_idle_and_launches_on_a_planted_job(monkeypatch):
    # offsets are planted 1 us late, so spans sit 1 us before these times
    kernels = [("gemv", 0.21, 0.22), ("Memcpy DtoH (Device -> Pageable)",
                                      0.25, 0.26),
               ("norm", 0.29, 0.31), ("stencil", 0.335, 0.34),
               ("axpy", 0.36, 0.37), ("gemm", 0.45, 0.46),
               ("late", 0.401, 0.402)]
    monkeypatch.setattr(program_spans, "program_record", _record)
    ctx = _ctx(_trace(kernels))
    idle = harness.load_metric("krylov.idle_pct").read(ctx)
    # the union [0.2, 0.3] ∪ [0.32, 0.4] (0.18 s), less 1 us each; busy
    # inside: 0.01 + 0.01 + 0.01 (to 0.3) + 0.005 + 0.01
    length = 0.18
    busy = 0.01 + 0.01 + (0.30 - 0.29) + 0.005 + 0.01
    assert idle == pytest.approx(100 * (length - busy) / length, abs=1e-3)
    launches = harness.load_metric("krylov.launches_per_arnoldi_step")
    # kernels starting inside: gemv, norm, stencil, axpy (the copy is no
    # kernel, gemm and late start outside); 180 steps of the outer two
    assert launches.read(ctx) == pytest.approx(4 / 180)


@pytest.mark.parametrize("name", ["krylov.idle_pct",
                                  "krylov.launches_per_arnoldi_step"])
def test_the_span_metrics_read_nothing_without_spans(monkeypatch, name):
    read = harness.load_metric(name).read
    assert read(_ctx(None)) is None
    monkeypatch.setattr(program_spans, "program_record", lambda: [])
    assert read(_ctx(_trace([("gemv", 0.2, 0.3)]))) is None
    # a job whose spans hold no fgmres (the dense Newton)
    no_krylov = [s for s in _record() if s.name != "fgmres"]
    monkeypatch.setattr(program_spans, "program_record", lambda: no_krylov)
    assert read(_ctx(_trace([("gemv", 0.2, 0.3)]))) is None


def test_the_cell_and_metrics_are_new_entries():
    spec = harness.benchmark_spec()
    (cell,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "armijo"
    mine = [m for m in spec["per_layer"] if m["name"].startswith("krylov.")]
    assert {m["name"] for m in mine} == {
        "krylov.cycles_per_newton_step", "krylov.idle_pct",
        "krylov.launches_per_arnoldi_step"}
    assert all(m["workloads"] == [CELL] and m["moves"] == "iter_s"
               for m in mine)
    assert {m["name"] for m in harness.per_layer_metrics(spec, CELL)} == {
        m["name"] for m in mine}


# --- the record that chip_smoke.py holds the card's Nx=64 fit to ----------------

def test_chip_smoke_holds_the_nx64_record():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("HIRES_NX64_CONV")):
            consts[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), "chip_smoke.py", "eval"))
    run = json.loads((ROOT / "results/hires_mg/summary.json").read_text()
                     )["runs"]["nx64_conv"]
    assert list(consts["HIRES_NX64_CONV_J"]) == run["J"]
    assert len(consts["HIRES_NX64_CONV_PROBES"]) == len(run["J"])
    assert set(run["newton_iterations"]) == {consts["HIRES_NX64_CONV_NEWTON"]}
    assert set(run["adjoint_rounds"]) == {consts["HIRES_NX64_CONV_ROUNDS"]}
    assert (run["conv_crit"], run["lr"], run["mg_levels"]) == (1e-3, 1.0, 2)
