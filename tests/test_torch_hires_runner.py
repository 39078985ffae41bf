"""``scripts/hires_mg_run_torch.py::run_gd_staged``, the port's
high-resolution runner, on the CPU at Nx=8 (multigrid, ν = 0.05, a
2-rung ladder, 4 buoys, nt=10): its warm-started probes, the cold-ladder
retry of a warm probe that stalls, the abandon of a probe whose rung
flatlines, and the crash-resume round trip (mirrors
``tests/test_staged_pair.py::test_staged_runner_crash_resume``). The
stalls are scripted: a Newton stager whose chosen solves make no
progress. Port only; about 25 s on two threads.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from ocean_torch import system
from ocean_torch.config import OCPConfig

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from hires_mg_run_torch import run_gd_staged  # noqa: E402

torch.set_num_threads(2)

LR = 1.0


@pytest.fixture(scope="module")
def case():
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment="4_buoys",
                    T=0.05, dt=0.005, linear_solver="mg", viscosity=0.05,
                    newton_continuation=2, use_line_search=True, LR=LR,
                    num_steps=2)
    rng = np.random.default_rng(2)
    u_d = 0.05 * rng.standard_normal((4, cfg.num_time_steps, 2))
    x0 = 0.3 + 1.4 * rng.random((4, 2))
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cpu")
    return cfg, prob, system.initial_control(prob, case=4)


def _run(case, iters, tag, **kw):
    cfg, prob, f0 = case
    fh = io.StringIO()
    out = run_gd_staged(prob, f0, LR, iters, fh, tag, line_search=True,
                        cfg=cfg, **kw)
    return out, fh.getvalue()


@pytest.fixture(scope="module")
def full(case):
    return _run(case, 2, "full")


def test_warm_probes_skip_the_ladder(case, full):
    """Above ν = 0.05 a probe starts warm from the accepted state: the
    ladder runs once, for the first forward, and every probe of the two
    iterations is accepted warm (its state against a cold ladder's:
    ``test_crash_resume_round_trip``)."""
    cfg, _, _ = case
    (js, _, nit, adj), text = full
    assert text.count(": rung ") == cfg.newton_continuation + 1
    assert "cold-ladder retry" not in text and "abandoning" not in text
    assert text.count("line search accepted") == 2
    assert len(js) == len(nit) == 2 and js[1] < js[0]
    assert adj["adjoint_rounds"] and all(adj["adjoint_rounds"])


def test_crash_resume_round_trip(case, full, tmp_path):
    """Interrupted after one iteration and resumed from the state file,
    the run ends where the uninterrupted one does."""
    (js_full, _, _, _), _ = full
    state = str(tmp_path / "state.npz")
    (js_a, _, nit_a, _), _ = _run(case, 1, "part", state_path=state)
    (js_b, _, nit_b, adj_b), text = _run(case, 2, "part", state_path=state)
    assert "part: resuming at iteration 1 (lr=1)" in text
    assert js_b[:1] == js_a and nit_b[:1] == nit_a
    assert len(adj_b["adjoint_rounds"]) == 2
    # the resumed run's first forward climbs the ladder where the
    # uninterrupted one went on from a warm probe: the same state, so
    # the warm probe's is the cold ladder's
    np.testing.assert_allclose(js_b, js_full, rtol=1e-12)
    st = np.load(state)
    assert list(st["js"]) == js_b and float(st["lr"]) == LR


def _scripted_stager(make, stalls):
    """``make_newton_stager`` whose solves named in ``stalls`` — (ν, n):
    the n-th solve at ν — make no progress: each step leaves w and
    reports ‖r‖ = 1."""
    def wrapped(prob, **kw):
        real = make(prob, **kw)
        seen, flat = [], [False]

        def init(f_quad, w0, nu):
            seen.append(float(nu))
            flat[0] = (float(nu), seen.count(float(nu))) in stalls
            return real.init(f_quad, w0, nu)

        def step(f_quad, w, r, rn, *args):
            if flat[0]:
                return w, r, 1.0
            return real.step(f_quad, w, r, rn, *args)

        return real._replace(init=init, step=step)
    return wrapped


def test_stalled_warm_probe_retries_cold_and_flatlined_rung_abandons(
        case, monkeypatch):
    """The first probe's warm solve stalls (given up after 8 flat steps),
    its cold-ladder retry flatlines on rung 1 (abandoned: the probe is
    not accepted), and the line search goes on at half the LR, where the
    warm probe converges."""
    cfg, prob, _ = case
    rung1 = system.continuation_viscosities(prob.nu,
                                            cfg.newton_continuation)[1]
    monkeypatch.setattr(system, "make_newton_stager", _scripted_stager(
        system.make_newton_stager, {(prob.nu, 2), (rung1, 2)}))
    (js, _, _, _), text = _run(case, 1, "stall")
    lines = text.splitlines()
    want = ["warm probe stalled (rn=1.000e+00); cold-ladder retry",
            "rung 1 flatlined (rn=1.000e+00); abandoning probe",
            f"it=0 line search accepted lr={LR / 2:g} (2 probes)"]
    found = [next(i for i, line in enumerate(lines) if w in line)
             for w in want]
    assert found == sorted(found)
    assert len(js) == 1 and np.isfinite(js[0])
