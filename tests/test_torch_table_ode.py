"""The table-path primal ODE kernel's plain mirror (``csrc/table_ode.cu``,
``ode/cuda_table_ode.py::table_ode_steps_plain``) against the eager table
path ``euler_steps(eval_velocity)`` on the CPU, and the dispatch of
``system._primal_ode``.

The mirror is the kernel's arithmetic in its order: location by the plain
mirrors of ``csrc/grid.cuh``, the reference coordinates and the six-term
P2 sum as ordered sums. The eager path sums with ``einsum``, in an order
of its own, so trajectories and velocities are held to it within 1e-12
relative, and the escape flags and steps exactly. Inputs: the ODE hard
inputs of ``tests/torch_kernel_cases.py`` (their half-grid images read at
the P2 dofs) on the rectangle, the L-shape on either diagonal and the pipe
meshes, and the L-shape's own starts and steps at K = 1, 3 and 33. The
card-only tests (``tests/test_torch_cuda.py``) hold the kernel to the
mirror bit for bit on the same inputs.
"""

import functools
import re

import numpy as np
import pytest
import torch

import torch_kernel_cases as kc
from ocean_torch import kernels, system
from ocean_torch.config import OCPConfig
from ocean_torch.fem.interpolate import eval_velocity
from ocean_torch.fem.spaces import make_space
from ocean_torch.mesh import structured
from ocean_torch.mesh.locate import in_domain
from ocean_torch.ode import solve_primal_ode
from ocean_torch.ode.cuda_table_ode import (eval_velocity_table,
                                            table_ode_steps,
                                            table_ode_steps_plain)
from ocean_torch.ode.grideval import make_grideval
from ocean_torch.ode.primal import euler_steps
from ocean_torch.utils import timing

NX = 8
RES = 8
RTOL = 1e-12


@functools.lru_cache(maxsize=None)
def rect(nx: int):
    return make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), nx,
                                                nx), "cpu")


@functools.lru_cache(maxsize=None)
def lshape(res: int, diagonal: str):
    return make_space(structured.l_shape_mesh(res, diagonal=diagonal), "cpu")


@functools.lru_cache(maxsize=None)
def pipe(name: str):
    mesh, _ = structured.pipe_mesh(**kc.PIPE_MESHES[name])
    return mesh, make_space(mesh, "cpu")


def _dofs(space, u_img):
    """The P2 dof vector whose half-grid image is ``u_img``."""
    return u_img[make_grideval(space).dof_to_node]


def _close(a, b):
    """NaN where the other has NaN, else within RTOL of max|b|."""
    assert torch.equal(a.isnan(), b.isnan())
    a, b = a.nan_to_num(), b.nan_to_num()
    assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())


def _mirror_against_eager(space, u, x0, h, nt):
    """Runs both; returns the mirror's (x, u_rec, failed, kfail)."""
    got = table_ode_steps_plain(space, u, x0, h, nt)
    want = euler_steps(lambda p: eval_velocity(space, u, p), x0, h, nt)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    _close(got[0], want[0])
    _close(got[1], want[1])
    return got


@pytest.mark.parametrize("case", kc.PRIMAL_CASES)
def test_mirror_equals_table_path_on_rectangle(case):
    space = rect(kc.ode_case_nx(case, NX))
    u_img, x0, h, nt = kc.primal_ode_case(case, NX)
    x, _, failed, kfail = _mirror_against_eager(space, _dofs(space, u_img),
                                                x0, h, nt)
    last_inside = in_domain(space.locator, x[:, nt - 1])
    if case == "leave_step_0":
        assert bool(failed.all()) and bool((kfail == 0).all())
    elif case == "leave_step_nt-2":
        assert bool(failed.all()) and bool((kfail == nt - 2).all())
    elif case == "leave_last_eval":
        assert not bool(failed.any()) and not bool(last_inside.any())
    elif case == "leave_never":
        assert not bool(failed.any()) and bool(last_inside.all())
    elif case == "edge_slack":
        assert 0 < int((kfail == 0).sum()) < len(kfail)


@pytest.mark.parametrize("diagonal", ["right", "left"])
@pytest.mark.parametrize("case", kc.LSHAPE_PRIMAL_CASES)
def test_mirror_equals_table_path_on_lshape(case, diagonal):
    space = lshape(kc.lshape_case_res(case, RES), diagonal)
    u_img, x0, h, nt = kc.lshape_primal_case(case, RES)
    _, _, failed, kfail = _mirror_against_eager(
        space, _dofs(space, u_img), x0, h, nt)
    if case.startswith("leave_reentrant_"):
        step = {"first": 0, "middle": nt // 2, "last": nt - 2}[case[16:]]
        assert bool(failed.all()) and bool((kfail == step).all())
    elif case == "corner_slack":
        assert 0 < int((kfail == 0).sum()) < len(kfail)
    elif case == "missing_block":
        assert int((kfail == 0).sum()) >= len(kfail) // 2


@pytest.mark.parametrize("name,case", kc.pipe_primal_cases())
def test_mirror_equals_table_path_on_pipes(name, case):
    mesh, space = pipe(name)
    u_img, x0, h, nt = kc.pipe_primal_case(case, mesh)
    _, _, failed, kfail = _mirror_against_eager(
        space, _dofs(space, u_img), x0, h, nt)
    if case.startswith("enter_hole_"):
        step = {"first": 0, "middle": nt // 2, "last": nt - 2}[case[11:]]
        assert bool(failed.all()) and bool((kfail == step).all())


def _lshape_field(space):
    """A smooth P2 field on the L-shape that carries buoys across the
    re-entrant corner and out through the outer boundary."""
    c = space.dof_coords_p2
    return torch.stack([0.6 * torch.sin(2.0 * c[:, 1]) - 0.2 * c[:, 0],
                        0.5 * torch.cos(3.0 * c[:, 0]) + 0.1], dim=-1)


@pytest.mark.parametrize("K", [1, 3, 33])
def test_mirror_equals_table_path_lshape_starts(K):
    """The L-shape cell's starts and steps (nt = 200, h = 0.005), the
    first three its own three buoys, the rest random inside the L."""
    space = lshape(RES, "right")
    rng = np.random.default_rng(37)
    x0 = np.concatenate([[[0.5, 0.5], [1.0, 0.5], [1.5, 1.0]],
                         rng.uniform([1.0, 0.0], [2.0, 2.0], (30, 2))])
    x0 = torch.as_tensor(x0[:K])
    _, _, failed, _ = _mirror_against_eager(space, _lshape_field(space), x0,
                                            0.005, 200)
    if K == 33:
        assert 0 < int(failed.sum()) < K


def test_mirror_points_on_lines_diagonal_and_reentrant_edges():
    """Point by point on the L-shape: grid nodes, grid lines and square
    diagonals, the re-entrant edges and the corner's slack, the missing
    block and beyond the outer boundary."""
    space = lshape(RES, "right")
    h = 2.0 / RES
    rng = np.random.default_rng(41)
    nodes = h * rng.integers(0, RES + 1, (64, 2))
    diag = np.repeat(rng.uniform(0.0, 1.0, (64, 1)), 2, axis=1)
    diag[:, 0] += h * rng.integers(0, RES // 2, 64)
    edges, _ = kc.lshape_point_case("reentrant_edges", RES)
    corner, _ = kc.lshape_point_case("corner_slack", RES)
    pts = torch.cat([torch.as_tensor(nodes), torch.as_tensor(diag),
                     edges[:256], corner[:64],
                     torch.as_tensor(rng.uniform(-0.2, 2.2, (512, 2)))])
    u = _lshape_field(space)
    got, inside = eval_velocity_table(space, u, pts)
    want, inside_eager = eval_velocity(space, u, pts)
    assert torch.equal(inside, inside_eager)
    assert bool(inside.any()) and not bool(inside.all())
    _close(got, want)


def test_wrapper_on_cpu_is_the_mirror():
    space = lshape(RES, "right")
    u_img, x0, h, nt = kc.lshape_primal_case("corner_slack", RES)
    u = _dofs(space, u_img)
    n0 = kernels.LAUNCHES["table_ode"]
    got = table_ode_steps(space, u, x0, h, nt)
    want = table_ode_steps_plain(space, u, x0, h, nt)
    assert kernels.LAUNCHES["table_ode"] == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def lshape_problem():
    return system.build_problem(
        OCPConfig(L_shape=True, L_shape_resolution=6,
                  ud_experiment="3_buoys"), device="cpu")


def test_primal_ode_on_cpu_stays_plain(lshape_problem):
    """On CPU tensors the "gather" backend runs ``solve_primal_ode``
    exactly as before, launches nothing, and its span says so."""
    prob = lshape_problem
    assert prob.ode_backend == "gather"
    u = _lshape_field(prob.space)
    n0 = kernels.LAUNCHES["table_ode"]
    timing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = system._primal_ode(prob, u)
    spans = [s for s in timing.recorded() if s.name == "primal_ode"]
    timing.clear()
    want = solve_primal_ode(prob.space, u, prob.x0, prob.h, prob.nt,
                            prob.center)
    assert kernels.LAUNCHES["table_ode"] == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [s.attrs for s in spans] == [{"steps": prob.nt - 1,
                                         "table_kernel": 0}]


def test_kernel_source_matches_its_wrapper():
    """The launch function takes the wrapper's arguments, and no kernel
    name holds a name that the benchmark's byte count matches as a part
    (``benchmark/kernel_bytes.py``)."""
    from ocean_torch.ode import cuda_table_ode
    src = (kernels.CSRC / kernels.SOURCES["table_ode"]).read_text()
    sig = re.search(r'extern "C" int table_ode_launch\(([^)]*)\)', src)
    assert len(sig.group(1).split(",")) == len(cuda_table_ode._ARGTYPES)
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
        src)
    assert names == ["table_euler_kernel"]
    for other in ("primal_ode_kernel", "adjoint_ode_kernel",
                  "point_sources_kernel"):
        assert other not in src
