"""ocean_torch parity: ``opt.ensemble.run_ensemble`` against the JAX
package's fused ensemble (a scan over a vmapped ``gd_step``), on the
fixture of ``tests/test_ensemble.py`` (Nx=8, K=4, T=0.05) with its first
seed moved next to the outflow x = 2.

One JAX ensemble with the line search off: the four initial-control
cases as members, the learning-rate grid 0.5, 1, 2, 4, and
``escape_threshold=0``. Case 3's flow carries the seed out at step 0, so
member 3 stops there; the step from its frozen (updated) control keeps
the seed inside, so JAX records 1, 0, 0 escaped buoys: the port must
compute that step as the vmap does. The J, LR and escaped histories,
``stopped_at`` and the final controls agree to 1e-10.

With the line search on, the port's ensemble is held to the JAX
package's sequential ``gd_step`` loop (the JAX test holds its ensemble to
that loop to 1e-12): equal LRs, J to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
from ocean_jax.opt import ensemble as jax_ensemble

from ocean_torch import convert, system
from ocean_torch.config import OCPConfig
from ocean_torch.opt.ensemble import run_ensemble, stack_controls

torch.set_num_threads(2)

K = 4
CFG = dict(unit_square_resolution=8, ud_experiment=f"{K}_buoys", T=0.05,
           dt=0.005)
LR_GRID = [0.5, 1.0, 2.0, 4.0]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    seeds = 0.4 + 1.2 * rng.random((K, 2))
    u_d = 0.05 * rng.standard_normal((K, JaxConfig(**CFG).num_time_steps, 2))
    seeds[0] = (2.0 - 1e-3, 0.5)
    pj = jax_system.build_problem(JaxConfig(**CFG), u_d=u_d, x0=seeds)
    pt = system.build_problem(OCPConfig(**CFG), u_d=u_d, x0=seeds,
                              device="cpu")
    cases_j = [jax_system.initial_control(pj, c) for c in range(4)]
    ens_j = jax_ensemble.run_ensemble(
        pj, jax_ensemble.stack_controls(cases_j), jnp.asarray(LR_GRID),
        num_steps=3, use_line_search=False, escape_threshold=0)
    return pj, pt, cases_j, ens_j


def test_stacked_controls_carry_across(setup):
    _, pt, cases_j, _ = setup
    stacked = convert.control(jax_ensemble.stack_controls(cases_j))
    mine = stack_controls([system.initial_control(pt, c) for c in range(4)])
    assert stacked.quad.shape == (4,) + tuple(pt.bq.points.shape)
    assert torch.equal(stacked.quad, mine.quad)
    assert torch.equal(stacked.p2, mine.p2)


def test_ensemble_matches_jax(setup):
    _, pt, cases_j, ens_j = setup
    f0 = convert.control(jax_ensemble.stack_controls(cases_j))
    ens = run_ensemble(pt, f0, torch.tensor(LR_GRID), num_steps=3,
                       use_line_search=False, escape_threshold=0)
    # member 3 leaves at step 0; the step from its frozen control keeps
    # the seed inside
    assert ens.stopped_at.tolist() == np.asarray(ens_j.stopped_at).tolist()
    assert ens.stopped_at.tolist()[3] == 0
    assert ens.escaped_history[:, 3].tolist() == [1, 0, 0]
    assert np.array_equal(ens.escaped_history.numpy(),
                          np.asarray(ens_j.escaped_history))
    assert np.array_equal(ens.lr_history.numpy(),
                          np.asarray(ens_j.lr_history))
    assert _rel(ens.j_history, ens_j.j_history) < 1e-10
    assert len(np.unique(np.round(ens.j_history[-1].numpy(), 12))) == 4
    assert _rel(ens.f_final.quad, ens_j.f_final.quad) < 1e-10
    assert _rel(ens.f_final.p2, ens_j.f_final.p2) < 1e-10


def test_ensemble_line_search_matches_jax_sequential(setup):
    pj, pt, cases_j, _ = setup
    lr_j, js_j, lrs_j = jnp.asarray(1000.0), [], []
    f = cases_j[0]
    for _ in range(3):
        res = jax_system.gd_step(pj, f, lr_j, use_line_search=True,
                                 max_ls_iters=40)
        f, lr_j = res.f_new, res.lr
        js_j.append(float(res.J))
        lrs_j.append(float(res.lr))
    f0 = stack_controls([system.initial_control(pt, 0)])
    ens = run_ensemble(pt, f0, torch.tensor([1000.0]), num_steps=3,
                       use_line_search=True)
    assert ens.stopped_at.tolist() == [3]
    assert ens.lr_history[:, 0].tolist() == lrs_j
    assert lrs_j[0] < 1000.0                     # the search backtracked
    assert _rel(ens.j_history[:, 0], js_j) < 1e-10
    assert _rel(ens.f_final.quad[0], f.quad) < 1e-8


def test_frozen_member_keeps_its_state(setup, monkeypatch):
    """A member that diverges is frozen at its pre-step control and LR,
    records its previous J, and stops; the others go on."""
    _, pt, _, _ = setup
    f0 = stack_controls([system.initial_control(pt, c) for c in (0, 3)])
    calls = []
    real = system.gd_step

    def gd_step(prob, f, lr, **kw):
        res = real(prob, f, lr, **kw)
        calls.append(float(lr))
        if lr == 4.0 and len(calls) == 4:        # member 1 at iteration 1
            return res._replace(diverged=True)
        return res

    monkeypatch.setattr(system, "gd_step", gd_step)
    ens = run_ensemble(pt, f0, torch.tensor([2.0, 4.0]), num_steps=3)
    monkeypatch.undo()
    ref = run_ensemble(pt, f0, torch.tensor([2.0, 4.0]), num_steps=1)
    assert ens.stopped_at.tolist() == [3, 1]
    assert ens.j_history[1, 1] == ens.j_history[0, 1] == ref.j_history[0, 1]
    assert ens.j_history[2, 1] == ens.j_history[0, 1]
    assert torch.equal(ens.f_final.quad[1], ref.f_final.quad[1])
    assert ens.j_history[2, 0] < ens.j_history[1, 0] < ens.j_history[0, 0]
    # member 1's step is computed once more from its frozen state, then
    # its count is reused: 3 steps of each member
    assert len(calls) == 6
