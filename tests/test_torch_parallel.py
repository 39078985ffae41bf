"""The sharded GD steps of ``ocean_torch/parallel`` on 4 gloo ranks on the
CPU, against the port's single-device ``gd_step`` and ocean_jax.

One spawn (``launch.spawn``, rank functions in
``tests/torch_parallel_cases.py``) runs every case: the cell-sharded
matvec on 3 ranks, the buoy-sharded step on 4 ranks in three cases (the
default method; exact Ozaki point sources with the consistent adjoint
and a control that ejects the lane of rank 1; the Armijo search from an
LR it must backtrack from), the 2-D step on a 2 × 2 layout with the
multigrid solver at Nx=8, and two iterations of ``system.gd_multi_step``
with the buoy hooks (line search off and on) and with all three hooks
on the 2 × 2 layout (the 2-D step's problem). The problem is the JAX
package's sharding problem (Nx=8, 6 buoys padded to 8, T=0.05).

Tolerances, the JAX package's own (``tests/test_sharding.py``): J within
1e-12 relative and the new control within 1e-12 of the single-device
step (the 2-D step 1e-9: its float32 Krylov matvec sums in another
order), the same LR and escape count; the sharded matvec within 1e-12 of
``Operator.matvec64``; the multi-step cases J and the final control
within 1e-12 relative (the 2-D case 1e-9, as the 2-D step) of the
single-device ``gd_multi_step``, with equal LRs, probe and escape
counts. Every rank returns the same bits as rank
0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ocean_jax.config import OCPConfig as JaxConfig
from ocean_jax import system as jax_system
from ocean_jax.fem.assemble import Operator as JaxOperator
from ocean_jax.parallel import pad_buoys as jax_pad_buoys
from ocean_jax.parallel.sharding import pad_problem as jax_pad_problem

from ocean_torch import system
from ocean_torch.parallel import (launch, make_sharded_step, pad_buoys,
                                  pad_problem)

import torch_parallel_cases as cases

torch.set_num_threads(2)

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of ``cases.rank_all_cases``."""
    return launch.spawn(cases.rank_all_cases, WORLD, "gloo", "cpu")


@pytest.fixture(scope="module")
def jax_tiny():
    rng = np.random.default_rng(0)
    cfg = JaxConfig(unit_square_resolution=8, ud_experiment="6_buoys",
                    T=0.05, dt=0.005)
    seeds = 0.3 + 1.4 * rng.random((cases.K, 2))
    u_d = 0.05 * rng.standard_normal((cases.K, cfg.num_time_steps, 2))
    return jax_system.build_problem(cfg, u_d=u_d, x0=seeds)


def _same_on_every_rank(ranks, key):
    ref = ranks[0][key]
    for r in ranks[1:]:
        got = r[key]
        if isinstance(ref, dict):
            assert ref.keys() == got.keys()
            for k in ref:
                assert (torch.equal(got[k], ref[k]) if torch.is_tensor(ref[k])
                        else got[k] == ref[k]), (key, k)
        else:
            assert torch.equal(got, ref), key


def test_pad_buoys_matches_jax():
    rng = np.random.default_rng(3)
    u_d, x0 = rng.standard_normal((6, 4, 2)), rng.standard_normal((6, 2))
    center = np.array([1.0, 1.0])
    got = pad_buoys(torch.as_tensor(u_d), torch.as_tensor(x0), 4,
                    torch.as_tensor(center))
    ref = jax_pad_buoys(jnp.asarray(u_d), jnp.asarray(x0), 4,
                        jnp.asarray(center))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert float(got[2].sum()) == 6.0


def test_pad_problem_matches_jax(jax_tiny):
    got = pad_problem(cases.tiny_problem("cpu"), WORLD)
    ref = jax_pad_problem(jax_tiny, WORLD)
    assert got.K == 8 and ref.u_d.shape[0] == 8
    for name in ("u_d", "x0", "buoy_weights"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def test_sharded_matvec_matches_jax(ranks):
    op, x = cases.matvec_input(cases.tiny_problem("cpu"))
    ref = JaxOperator(
        jnp.asarray(op.cell_mats.numpy()), jnp.asarray(op.cell_dofs.numpy()),
        jnp.asarray(op.facet_mats.numpy()),
        jnp.asarray(op.facet_dofs.numpy()), jnp.asarray(op.bc_dofs.numpy()),
        op.n).matvec64(jnp.asarray(x.numpy()))
    for r in ranks[:3]:
        assert np.abs(r["matvec"].numpy() - np.asarray(ref)).max() <= 1e-12
    _same_on_every_rank(ranks[:3], "matvec")
    assert "matvec" not in ranks[3]


@pytest.mark.parametrize("name", ["default", "ozaki_consistent", "armijo"])
def test_sharded_step_matches_single_device(ranks, name):
    prob, f, lr, opts = cases.cases("cpu")[name]
    ref = system.gd_step(prob, f, lr, **{"max_ls_iters": 40, **opts})
    got = ranks[0][name]
    assert not got["diverged"] and not ref.diverged
    assert abs(got["J"] - float(ref.J)) <= 1e-12 * abs(float(ref.J))
    assert float((got["f_quad"] - ref.f_new.quad).abs().max()) <= 1e-12
    assert float((got["f_p2"] - ref.f_new.p2).abs().max()) <= 1e-12
    assert got["lr"] == ref.lr
    assert got["mask_count"] == float(ref.fwd.mask.sum())
    if name == "ozaki_consistent":
        assert got["mask_count"] == 1.0
        assert ref.fwd.mask.tolist().index(True) == cases.ESCAPER
    if name == "armijo":
        assert ref.inner_iterations > 1 and got["lr"] < lr
    _same_on_every_rank(ranks, name)


def test_sharded_step_matches_jax(ranks, jax_tiny):
    f = jax_system.initial_control(jax_tiny, case=0)
    ref = jax_system.gd_step(jax_tiny, f, jnp.asarray(cases.LR),
                             use_line_search=False)
    got = ranks[0]["default"]
    assert not bool(ref.diverged)
    assert abs(got["J"] - float(ref.J)) <= 1e-12 * abs(float(ref.J))
    assert np.abs(got["f_quad"].numpy()
                  - np.asarray(ref.f_new.quad)).max() <= 1e-12
    assert np.abs(got["f_p2"].numpy()
                  - np.asarray(ref.f_new.p2)).max() <= 1e-12
    assert got["mask_count"] == float(ref.fwd.mask.sum())


def test_sharded_step_2d_matches_single_device(ranks):
    prob, f, lr = cases.problem_2d("cpu")
    assert prob.linear_solver == "mg"
    ref = system.gd_step(prob, f, lr)
    got = ranks[0]["2d"]
    assert not got["diverged"] and not ref.diverged
    assert abs(got["J"] - float(ref.J)) <= 1e-9 * abs(float(ref.J))
    assert float((got["f_quad"] - ref.f_new.quad).abs().max()) <= 1e-9
    assert got["mask_count"] == float(ref.fwd.mask.sum())
    _same_on_every_rank(ranks, "2d")


@pytest.mark.parametrize("name", ["multi_fixed", "multi_armijo",
                                  cases.MULTI_2D])
def test_sharded_multi_step_matches_single_device(ranks, name):
    prob, f, lr, opts = cases.multi_step_cases("cpu")[name]
    tol = 1e-9 if name == cases.MULTI_2D else 1e-12
    f_ref, lr_ref, traj = system.gd_multi_step(prob, f, lr,
                                               cases.MULTI_STEPS, **opts)
    got = ranks[0][name]
    assert got["J"].shape == (cases.MULTI_STEPS,)
    assert not bool(got["diverged"].any()) and not bool(traj.diverged.any())
    assert float((got["J"] - traj.J).abs().max()) \
        <= tol * float(traj.J.abs().max())
    for key, ref in (("f_quad", f_ref.quad), ("f_p2", f_ref.p2)):
        assert float((got[key] - ref).abs().max()) \
            <= tol * float(ref.abs().max())
    assert got["lr_final"] == lr_ref
    for key in ("lr", "mask_count", "inner_iterations"):
        assert torch.equal(got[key], getattr(traj, key)), key
    if name == "multi_armijo":
        assert int(traj.inner_iterations[0]) > 1 and lr_ref < lr
    calls = got["hook_calls"]           # every hook ran in every iteration
    assert calls["adjoint_rhs_impl"] == cases.MULTI_STEPS
    assert calls["ode_impl"] == cases.MULTI_STEPS \
        + int(traj.inner_iterations.sum())          # forwards and probes
    assert calls.get("matvec_of", 0) > 0 \
        if name == cases.MULTI_2D else "matvec_of" not in calls
    _same_on_every_rank(ranks, name)


def test_sharded_step_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_sharded_step(cases.tiny_problem("cpu"))


def test_launch_refuses_nccl_without_cards():
    with pytest.raises((ValueError, RuntimeError)):
        launch.rank_device(0, 2, "nccl", "cpu")
    with pytest.raises((ValueError, RuntimeError)):
        launch.spawn(cases.rank_default_step, 2, "nccl", "cuda")
