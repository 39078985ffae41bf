"""The plain reference's ν-continuation ladder and the inputs of a fit at a
low ν, at Nx=8 on the CPU: the ladder finds the flow that the program's
ladder finds where one Newton from w = 0 does not, an iteration of the
program at ν = 0.01 is followed by the reference's, and a configuration
without ``continuation`` or ``ud.viscosity`` runs as before."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs
from benchmark.reference import fem, ocp, ode
from benchmark.reference.ocp import Reference

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEED = 3300002501


def _golden(**kw):
    """The golden run's shape at Nx=8: ν = 0.01 behind 6 rungs from the
    Taylor–Green control, the data from the flow at ν = 1."""
    _, cfg, traffic = harness.load_cell("square_k10.armijo")
    cfg = dict(cfg, resolution=8, viscosity=0.01, continuation=6,
               ud=dict(cfg["ud"], viscosity=1.0),
               initial_control="taylor_green", program_initial_case=0, **kw)
    return cfg, traffic


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path))
    return tmp_path


def test_the_ladder_finds_the_programs_flow(cache):
    from ocean_torch import system
    cfg, traffic = _golden()
    x0, u_d = inputs.make(cfg, traffic, SEED, CPU)
    ref = Reference(cfg, x0, u_d, CPU)
    assert len(ref.viscosities()) == 8 and ref.viscosities()[-1] == 0.01
    f = ref.initial_control()
    prob = system.build_problem(harness.port_config(cfg), u_d=u_d, x0=x0,
                                device=CPU)
    assert prob.newton_continuation == 6
    w_prog = system.solve_ns(prob, f).w
    w_ref = ref.forward(f)["w"]
    assert float((w_ref - w_prog).abs().max()
                 / w_prog.abs().max()) <= 1e-12
    # one Newton from w = 0 at ν = 0.01 stops at its first step
    plain = Reference({k: v for k, v in cfg.items() if k != "continuation"},
                      x0, u_d, CPU).forward(f)
    assert plain["newton_rel"] == 1.0
    assert not plain["w"].any()


def test_an_iteration_at_low_viscosity_is_followed(cache):
    """From LR 0.3125 the first probe is accepted on both sides (from LR
    5 the stalled probes cost the program minutes on the CPU)."""
    from ocean_torch import system
    from ocean_torch.opt.driver import run_gradient_descent
    cfg, traffic = _golden(LR=0.3125, num_steps=1)
    x0, u_d = inputs.make(cfg, traffic, SEED, CPU)
    pcfg = harness.port_config(cfg)
    prob = system.build_problem(pcfg, u_d=u_d, x0=x0, device=CPU)
    f0 = system.initial_control(prob, cfg["program_initial_case"])
    cap = check.Capture(system, [0])
    try:
        cap.start(f0.quad)
        res = run_gradient_descent(pcfg, prob, f0,
                                   escape_threshold=cfg["escape_threshold"],
                                   on_iteration=cap.on_iteration,
                                   grad_check_dir=None, verbose=False)
    finally:
        cap.stop()
        cap.restore()
    prog = check.program_readings(cap, cfg)
    ref = check.reference_readings(Reference(cfg, x0, u_d, CPU), prog)
    assert list(res.inner_iterations) == [1] and ref[0]["probes"] == 1
    gaps = check.compare(prog, ref, prob.space.n_p2, [0])[0]
    for k in ("u", "p", "z", "g", "J", "f_new"):
        assert gaps[k] <= 1e-10, (k, gaps)


def test_without_a_ladder_the_reference_is_one_newton(cache):
    _, cfg, traffic = harness.load_cell("square_k10.armijo",
                                        dict(resolution=8))
    x0, u_d = inputs.make(cfg, traffic, SEED, CPU)
    ref = Reference(cfg, x0, u_d, CPU)
    assert ref.viscosities() == [1.0]
    f = ref.initial_control()
    sp = ref.sp
    w, its, rel = fem.newton(
        sp, lambda w: fem.ns_residual(sp, w, f, 1.0),
        lambda w: fem.ns_jacobian(sp, w, 1.0, sp.bc),
        torch.zeros(sp.ndof, dtype=torch.float64), sp.bc, ref.bc_vals)
    out = ref.forward(f)
    assert torch.equal(out["w"], w)
    assert (out["newton_iters"], out["newton_rel"]) == (its, rel)


@pytest.mark.parametrize("config,name", [
    ("square_k10000", "flow_n32_nu1.0_in0.1_0.0.npy"),
    ("square_nx64_mg", "flow_n64_nu1.0_in0.1_0.0.npy"),
    ("square_k10", "flow_n32_nu1.0_in0.1_0.0.npy"),
])
def test_the_flow_files_keep_their_names(config, name):
    assert inputs.flow_file(harness.load("configs", config)) == name


@pytest.mark.parametrize("cell", ["square_k10000.armijo",
                                  "square_nx64_mg.armijo",
                                  "lshape_res50.armijo"])
def test_the_inputs_are_made_as_before(cache, cell):
    """At Nx=8, each configuration's inputs equal its recipe without
    ``ud.viscosity``: the flow at the configuration's ν."""
    _, cfg, traffic = harness.load_cell(cell, dict(resolution=8))
    assert "viscosity" not in cfg["ud"]
    x0, u_d = inputs.make(cfg, traffic, SEED, CPU)
    assert np.array_equal(x0, inputs.starts(cfg, traffic, SEED))
    if cfg["ud"]["kind"] == "dirichlet_flow":
        assert sorted(p.name for p in cache.iterdir()) == [
            f"flow_n8_nu{cfg['viscosity']}_in0.1_0.0.npy"]
        sp, w = ocp.dirichlet_flow(8, cfg["viscosity"], cfg["ud"]["inflow"],
                                   CPU)
        assert np.array_equal(np.load(next(cache.iterdir())), w.numpy())
        _, want, _ = ode.primal(
            sp, sp.split(w)[0], torch.as_tensor(x0), cfg["dt"],
            int(round(cfg["T"] / cfg["dt"])),
            torch.tensor([1.0, 1.0], dtype=torch.float64))
        assert np.array_equal(u_d, want.numpy())
        # the same ν named twice reads the same file and the same bytes
        again = dict(cfg, ud=dict(cfg["ud"], viscosity=cfg["viscosity"]))
        assert inputs.flow_file(again) == inputs.flow_file(cfg)
        assert np.array_equal(inputs.make(again, traffic, SEED, CPU)[1],
                              u_d)


def test_the_flow_viscosity_names_its_own_file(cache):
    cfg, traffic = _golden()
    assert inputs.flow_file(cfg) == "flow_n8_nu1.0_in0.1_0.0.npy"
    x0, u_d = inputs.make(cfg, traffic, SEED, CPU)
    _, cfg1, _ = harness.load_cell("square_k10.armijo", dict(resolution=8))
    assert np.array_equal(inputs.make(cfg1, traffic, SEED, CPU)[1], u_d)
    low = dict(cfg, ud={k: v for k, v in cfg["ud"].items()
                        if k != "viscosity"})
    assert inputs.flow_file(low) == "flow_n8_nu0.01_in0.1_0.0.npy"


def test_the_ten_buoy_configuration():
    from ocean_torch.pipelines.ud_construction import seed_positions
    _, cfg, _ = harness.load_cell("square_k10.armijo")
    flagship = harness.load("configs", "square_k10000")
    pcfg = harness.port_config(cfg)
    want = harness.port_config(flagship)
    for k in ("newton_reuse_lu", "psrc_method", "ode_backend",
              "dense_apply", "viscosity", "unit_square_resolution", "LR",
              "num_steps", "conv_crit", "newton_continuation"):
        assert getattr(pcfg, k) == getattr(want, k), k
    assert pcfg.ud_experiment == "10_buoys"
    x0, spacing = inputs.base_starts(cfg)
    assert np.array_equal(x0, seed_positions(10))
    assert np.array_equal(spacing, [2 / 32, 2 / 32])
    same = {k for k in flagship if flagship[k] == cfg[k]}
    assert set(flagship) - same == {"name", "source", "deployment",
                                    "assumed", "alpha_buoys", "starts"}
