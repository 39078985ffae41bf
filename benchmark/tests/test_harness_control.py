"""The comparison fails what it has to fail, at small sizes on the CPU:
the lower-precision control (the reference in float32 put in the
program's place), and a run whose timed path is broken underneath: a
step that leaves the control unchanged, the point sources of half of the
buoys doubled in place of all, and a velocity altered where the primal
ODE produces it; and a run in which a compared stage is rerouted past
its probe. The cells run on one card, so no exchange between cards
can be left out. On a card, the control at the cells' own size."""

import sys
import types

import pytest
import torch

from benchmark import check, harness

from conftest import SMALL, small_run

@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails(cell):
    r = small_run(cell, seconds=0.0, control=True)
    assert r["correct"]
    ok, _ = check.judge(r["control_numbers"], r["cell"]["limits"])
    assert not ok

def _unchanged_step(prob):
    from ocean_torch import control
    orig = control.Control.axpy
    control.Control.axpy = lambda self, s, other: self
    return lambda: setattr(control.Control, "axpy", orig)

def _half_the_buoys(prob):
    from ocean_torch import system
    orig = system._adjoint_sources

    def half(prob, u, mu, x, u_values, mask, x_raw, kfail):
        keep = torch.arange(mask.shape[0], device=mask.device) < (
            mask.shape[0] // 2)
        return 2.0 * orig(prob, u, mu, x, u_values, mask | ~keep, x_raw,
                          kfail)
    system._adjoint_sources = half
    return lambda: setattr(system, "_adjoint_sources", orig)

def _altered_velocity(prob):
    from ocean_torch import system
    orig = system._primal_ode

    def altered(prob, u):
        ode = orig(prob, u)
        uv = ode.u_values.clone()
        uv[0, 1, 0] *= 1.0 + 1e-5
        return ode._replace(u_values=uv)
    system._primal_ode = altered
    return lambda: setattr(system, "_primal_ode", orig)

@pytest.mark.parametrize("cell", ["square_k10000.armijo",
                                  "square_k10.armijo"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_buoys,
                                   _altered_velocity])
def test_a_broken_timed_path_is_not_correct(fault, cell):
    undo = []
    try:
        r = small_run(cell, seconds=0.0,
                      on_problem=lambda prob: undo.append(fault(prob)))
    finally:
        for u in undo:
            u()
    assert not r["correct"], r["table"]

def _rerouted(caller, stages):
    """The program with ``caller`` calling the stages it names directly,
    not through ``system``'s names: the same numbers, but no probe of
    those stages fires, as after a later change fuses or renames them."""
    def plant(prob):
        from ocean_torch import system
        fn = getattr(system, caller)
        env = dict(fn.__globals__)
        env.update({n: getattr(system, n) for n in stages})
        setattr(system, caller, types.FunctionType(
            fn.__code__, env, fn.__name__, fn.__defaults__, fn.__closure__))
        return lambda: setattr(system, caller, fn)
    return plant


@pytest.mark.parametrize("caller,stages,unread,read", [
    # the ∇u projection, μ and b are not read; the rest still is
    ("_adjoint_rhs_body", ("_adjoint_mu", "_adjoint_sources"),
     ("grad_u", "mu", "b"), ("u", "p", "x", "J", "z", "g", "f_new")),
    # without the gradient the reference cannot follow iterations 1-6
    ("make_staged_pair", ("reduced_gradient",), check.NUMBERS, ()),
])
def test_a_number_the_run_does_not_produce_is_not_correct(caller, stages,
                                                          unread, read):
    undo = []
    plant = _rerouted(caller, stages)
    try:
        r = small_run("square_k10000.armijo", seconds=0.0,
                      on_problem=lambda prob: undo.append(plant(prob)))
    finally:
        for u in undo:
            u()
    assert not r["correct"]
    assert r["failed"] == len(r["sample"])
    for k in unread:
        assert r["table"][k][0] == sys.float_info.max, (k, r["table"])
    for k in read:
        assert r["table"][k][0] <= r["table"][k][1], (k, r["table"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    for seed in (1, 2, 3):
        r = harness.run_cell(cell, seed, 0.0, False, time.perf_counter(),
                             control=True)
        assert r["correct"], r["table"]
        ok, _ = check.judge(r["control_numbers"], r["cell"]["limits"])
        assert not ok
