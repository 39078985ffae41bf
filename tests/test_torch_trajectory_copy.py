"""The driver's record of the buoy trajectories (``GDRunResult.x_array``,
span ``trajectory_copy``; ``utils/timing.py::to_host_async``), no JAX.

On the CPU (``torch_parallel_cases.tiny_problem``, Nx=8, 6 buoys, both
driver loops): one ``np.ndarray`` an iteration, bit for bit the state the
``on_iteration`` hook sees, no two sharing memory, every span
``pinned`` 0. On the card (marker ``cuda``; the square cell's program at
Nx=16, K=400, kernels 1-3):

    python -m pytest --noconftest tests/test_torch_trajectory_copy.py -m cuda

the copies are page-locked and asynchronous (``pinned`` 1), the entries
read straight after the return equal a synchronous ``.cpu()`` of the same
states, and a job stopped by an exception from the hook leaves the next
job's entries whole.
"""

import dataclasses

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
LOOPS = pytest.mark.parametrize("staged", [True, False],
                                ids=["staged", "per_stage"])


@pytest.fixture(autouse=True)
def _empty_record():
    timing.clear()
    yield
    timing.clear()


def _job(cfg, prob, f0, hook=None, staged=True, **kw):
    return run_gradient_descent(cfg, dataclasses.replace(prob, solve_log=[]),
                                f0, on_iteration=hook, staged=staged,
                                verbose=False, **kw)


def _cloning_hook(states):
    def hook(i, f, fwd, z, j_array):
        states.append(fwd.x.clone())
    return hook


def _apart(arrays):
    return not any(np.shares_memory(a, b)
                   for k, a in enumerate(arrays) for b in arrays[:k])


# --- the CPU ------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_runs():
    """Per loop: the result of a job run under the profiler, the hook's
    clones of ``fwd.x`` and the record."""
    prob = tiny_problem("cpu")
    cfg = OCPConfig(unit_square_resolution=8, ud_experiment=f"{K}_buoys",
                    T=0.05, dt=0.005, num_steps=STEPS, LR=LR_ARMIJO,
                    LR_MAX=LR_ARMIJO)
    f0 = system.initial_control(prob, 0)
    out = {}
    for staged in (True, False):
        states = []
        timing.clear()
        with torch.profiler.profile(activities=CPU):
            res = _job(cfg, prob, f0, _cloning_hook(states), staged)
        out[staged] = (res, states, timing.recorded())
        timing.clear()
    return out


@LOOPS
def test_one_array_an_iteration(cpu_runs, staged):
    res, states, _ = cpu_runs[staged]
    assert res.iterations_run == STEPS == len(res.x_array) == len(states)
    for a in res.x_array:
        assert type(a) is np.ndarray
        assert a.dtype == np.float64 and a.shape == (K, 10, 2)


@LOOPS
def test_arrays_are_the_hooks_states_bit_for_bit(cpu_runs, staged):
    res, states, _ = cpu_runs[staged]
    for a, x in zip(res.x_array, states):
        assert np.array_equal(a, x.numpy())


@LOOPS
def test_no_two_arrays_share_memory(cpu_runs, staged):
    assert _apart(cpu_runs[staged][0].x_array)


@LOOPS
def test_the_copy_spans_say_unpinned(cpu_runs, staged):
    spans = [s for s in cpu_runs[staged][2] if s.name == "trajectory_copy"]
    assert len(spans) == STEPS
    for s in spans:
        assert s.attrs == {"bytes": K * 10 * 2 * 8, "pinned": 0}
        assert s.syncs == 0


def test_to_host_async_on_the_cpu_is_the_tensors_memory():
    x = torch.arange(6, dtype=torch.float64).reshape(3, 2)
    with torch.profiler.profile(activities=CPU):
        with timing.span("outer"):
            a = timing.to_host_async(x)
    assert [s.syncs for s in timing.recorded() if s.name == "outer"] == [0]
    assert np.shares_memory(a, x.numpy()) and np.array_equal(a, x.numpy())


# --- the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_problem(dev):
    """The square cell's program (chord Newton on the float32 inverse,
    kernels 1-3) at Nx=16, K=400 on a 20 × 20 grid, nt=200."""
    gx, gy = np.meshgrid(np.linspace(0.1, 0.4, 20),
                         np.linspace(0.25, 1.75, 20))
    x0 = np.stack([gx.ravel(), gy.ravel()], axis=1)
    u_d = 0.05 * np.random.default_rng(24).standard_normal((400, 200, 2))
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=16,
                    num_steps=STEPS, use_line_search=True, LR=5.0, LR_MAX=5.0,
                    newton_reuse_lu=True, dense_apply="inverse",
                    psrc_method="fused", ode_backend="pallas")
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    return cfg, prob, system.initial_control(prob, 4)


@pytest.mark.cuda
def test_to_host_async_on_the_card(dev):
    x = torch.randn(400, 200, 2, dtype=torch.float64, device=dev)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with timing.span("outer"):
            a = timing.to_host_async(x)
    assert [s.syncs for s in timing.recorded() if s.name == "outer"] == [0]
    assert torch.from_numpy(a).is_pinned()
    torch.cuda.synchronize(dev)
    assert np.array_equal(a, x.cpu().numpy())


@pytest.mark.cuda
def test_the_card_copies_are_pinned_and_asynchronous(card_problem):
    cfg, prob, f0 = card_problem
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        res = _job(cfg, prob, f0, escape_threshold=10)
    spans = [s for s in timing.recorded() if s.name == "trajectory_copy"]
    assert len(spans) == res.iterations_run == STEPS
    for s in spans:
        assert s.attrs == {"bytes": 400 * 200 * 2 * 8, "pinned": 1}
        assert s.syncs == 0
    for a in res.x_array:
        assert type(a) is np.ndarray and a.shape == (400, 200, 2)
        assert torch.from_numpy(a).is_pinned()
    assert _apart(res.x_array)


@pytest.mark.cuda
def test_arrays_read_after_the_return_equal_a_synchronous_copy(card_problem):
    cfg, prob, f0 = card_problem
    states = []
    res = _job(cfg, prob, f0, _cloning_hook(states), escape_threshold=10)
    got = [a.copy() for a in res.x_array]     # no wait but the driver's
    assert len(got) == len(states) == STEPS
    for a, x in zip(got, states):
        assert np.array_equal(a, x.cpu().numpy())


@pytest.mark.cuda
def test_a_stopped_job_leaves_the_next_one_whole(card_problem):
    """The first job stops by an exception from the hook, as the
    benchmark's window does; the next job's arrays equal its states and a
    job of its own, and its J the same job's."""
    cfg, prob, f0 = card_problem

    class Stop(Exception):
        pass

    def stop(i, f, fwd, z, j_array):
        if i == 1:
            raise Stop
    alone = _job(cfg, prob, f0, escape_threshold=10)
    with pytest.raises(Stop):
        _job(cfg, prob, f0, stop, escape_threshold=10)
    states = []
    res = _job(cfg, prob, f0, _cloning_hook(states), escape_threshold=10)
    assert res.j_array == alone.j_array
    for a, b, x in zip(res.x_array, alone.x_array, states):
        assert np.array_equal(a, b)
        assert np.array_equal(a, x.cpu().numpy())
    assert _apart(res.x_array + alone.x_array)
