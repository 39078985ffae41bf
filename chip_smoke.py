#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ocean_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: require CUDA (no CPU fallback); print the card's name and
   power limit as nvidia-smi reports them;
2. build: compile the six CUDA kernels from ``ocean_torch/csrc`` (one
   nvcc per source, in parallel) and print the seconds and what ptxas
   says of registers, spills and static shared memory (the adjoint ODE's
   gather slots and the primal ODE's staging rows). The primal ODE also
   asks for dynamic shared memory at launch, for the velocity image where
   it fits; phase 4 prints those bytes;
3. setup at path 1's configuration, the scalability configuration
   (unit square [0,2]², Nx=32, K=10⁴ buoys, nt=200, line search off,
   dense solver, chord Newton on the Stokes factor, CUDA ODE and
   point-source kernels; ``bench.py::_build`` adds
   ``dense_apply="inverse"``: path 10c's "inverse" variant and path 14a):
   synthesize u_d (cached in ``data/ud_torch/``), build the problem, and
   run one warm-up GD step whose state feeds phase 4;
4. each kernel against its plain PyTorch version on the same inputs at
   the main path's shapes: maximum error against the stated tolerance,
   kernel and plain times (CUDA events), the two ODE kernels and the
   integer sums (point sources, segment sum) bit-identical
   (``torch.equal``) to the plain version and between two launches, and
   the ``index_add_`` yardstick where one exists; then the two ODE and
   the two scatter kernels on the small hard inputs of
   ``tests/torch_kernel_cases.py`` (ragged buoy tiles and time chunks,
   buoys leaving at the first, the last or no step, the slack of every
   edge and corner, grid lines and the diagonal, every ``vlimit`` window,
   a spacing that is divided and an image too large for shared memory;
   one square or segment, one per lane, ragged M, zero and negative
   weights, dropped ids, ±scale), each equal to the plain version;
5. small-input reference checks: one GD step of path 1 and one of path 2
   at Nx=8, K=100 through the kernels on the card against the plain
   versions on the CPU;
6. path 1, the main path: launch counts set to 0, one GD step from
   ``initial_control(case=4)``, counts read (its three kernels must have
   run, the other two not); J finite, not diverged, Newton converged;
   the median seconds of 3 repeats at the fixed control; a per-stage
   breakdown;
7. path 2, the same configuration with the exact segment-sum point
   sources (``psrc_method="ozaki_pallas"``) and the consistent adjoint,
   at a constant outflow control that ejects buoys: counts set to 0, one
   GD step (primal ODE, adjoint ODE and segment sum must have run, the
   point-source kernel not), its median seconds, its adjoint RHS
   against the "fused" kernel's on the same forward state, and the two
   ODE and the two scatter kernels, each held to its plain version and
   timed, on this state's inputs (a faster flow with frozen buoys,
   ``vlimit`` windows, shorter groups);
8. the parallel-prefix adjoint entry points with the grid tables
   (``solve_adjoint_ode(method="parallel", grid=)`` on path 1's state,
   ``solve_adjoint_ode_consistent(grid=)`` on path 2's): each launches
   the ∇u evaluation kernel once and matches the sequential adjoint
   kernel;
9. small-input reference of the optimisation run: three driver
   iterations with the Armijo line search at Nx=8, K=100 and on the
   L-shape at resolution 8, kernels on the card against plain versions on
   the CPU: equal ``inner_iterations`` sequences and LR, J to 1e-12;
10. the gradient check on the card (``opt.grad_check.grad_test``) on the
    L-shape at resolution 16 and on the square at Nx=8, K=100: the centred
    finite-difference error against ⟨g, df⟩ per step size: the quotient
    settled to 1e-6 and the adjoint within its consistency floor of it
    (5e-3 relative, the JAX package's own bound);
11. path 3, the flagship run: ``pipelines.limits.run`` at Nx=32, K=10⁴,
    nt=200, Armijo on, fast paths, LR=5, 5 iterations, artifacts into a
    temporary directory. Counts set to 0 before and read after (primal
    ODE = forwards taken, adjoint ODE and point sources = iterations); J
    strictly decreasing, the first J and probe count beside the JAX
    package's TPU record, LR non-increasing, every artifact present,
    ``q.npz`` reloads; prints
    ``gd_iteration_seconds_10000_buoys_armijo``;
12. path 4, the L-shape run: ``pipelines.ocp.run`` at resolution 50 (17.4k
    mixed dofs), 3 analytic buoys, Armijo on, CUDA ODE and point-source
    kernels, 3 iterations, with the same count and artifact checks;
    prints ``lshape_res50_gd_iteration_seconds``;
13. the five kernels at a real size on the L-shape: 10⁴ meshgrid seeds
    inside the L on path 4's velocity and ∇u fields, each kernel equal to
    its plain version and timed as in phase 4; then kernel 6, the
    "gather" backend's steps on the locate/dofmap tables
    (``ode/cuda_table_ode.py``), on path 4's velocity at the L-shape
    cell's three starts and at the 10⁴ seeds, and on phase 4's velocity
    at the main path's 10⁴ starts: equal (``torch.equal``) to
    ``table_ode_steps_plain`` and between two launches, timed as in phase
    4 with kernel 1 on the same field and starts beside it;
14. path 5, the "left" diagonal: path 1's configuration and data with
    ``mesh_diagonal="left"``, counts set to 0, one GD step, counts read,
    3 timed (``gd_iteration_seconds_10000_buoys_left``), the stages;
    kernels 1–3 and (through the ``grid=`` adjoint entry point) kernel 4
    on its inputs, each held to its plain version and timed; one GD step
    with ``ode_backend="grid"`` whose trajectories equal kernel 1's; the
    small reference at Nx=8, K=100 against the CPU;
15. path 6, the gen-1 pipe meshes at function level, as the JAX package
    drove them on its TPU (``scripts/pallas_domains_hw.py``): the record's
    three meshes at K=512 (escapes beside the record's 25 / 19 / 24) and
    the ∇u evaluation on 4,096 points; then, counts set to 0, the primal
    ODE, ∇u projection, adjoint ODE, fused point sources and ∇u evaluation
    at 10⁴ seeds on the gmsh-default graded pipe (73 × 73, the primal
    ODE's image in device memory) and the uniform 22 × 22 pipe, each
    kernel held to its plain version and timed;
16. path 7, the verification harnesses on the card: the Stokes gradient
    check at the reference's size (``pipelines.stokes_gradcheck.run``,
    nx=32) against the JAX package's CPU numbers (gradj, J0, ‖div u‖ to
    1e-10, centred error below 1e-11 at h=1e-3) and autograd through
    ``solve_state`` against gradj (1e-9); the NS+ODE check
    (``pipelines.ns_gradcheck.run``, nx=32, K=5: J0 against the JAX
    package's to 1e-10, the centred quotient settled, its gap to gradj
    printed) and the same at nx=8, K=3 against the CPU (1e-12); the VJP
    of ``system.make_differentiable_ns_solver`` on the path-1 problem
    against the centred difference of ⟨c, w(f)⟩ (1e-7). No kernel runs
    on this path: the counts are printed;
17. path 8, the initial-control study at the flagship size: path 1's u_d
    and x0 written into a temporary ``reference_runs_dir``, path 3's fast
    paths, counts set to 0, ``pipelines.initial_control.
    run_all_cases_fused`` (cases 0–3, Armijo, LR=5, 3 iterations), counts
    read (primal ODE = forwards, adjoint ODE and point sources = 12);
    four distinct finite J histories, member 0 equal to three sequential
    ``gd_step`` calls to 1e-12; then ``initial_control.run(case=2)``
    through the driver for 2 iterations with its artifacts; seconds per
    member-iteration and the driver's iteration seconds;
18. path 9, the JAX package's hi-res multigrid study
    (``results/hires_mg/``: unit square, 400 meshgrid buoys synthesized
    at Nx=32, nt=200, Armijo, LR 1, ``initial_control(case=4)``,
    ``linear_solver="auto"``): a small mg reference (Nx=8, card against
    CPU); 9a at Nx=64 (37,507 dofs): "auto" must pick mg with two levels
    (coarse 9,539 dofs, leaf 8,450 velocity dofs) and the stencil matvec;
    counts set to 0, 3 driver iterations, counts read (primal ODE =
    forwards, adjoint ODE and point sources = iterations), every NS and
    adjoint solve converged, J decreasing; per iteration J, probes,
    Newton iterations, FGMRES cycles a Newton step, adjoint rounds and
    residual, seconds; ``hires_nx64_gd_iteration_seconds`` (median of
    iterations 1–2) and the set-up seconds by part; J₀ beside the TPU
    record (information); kernels 1–3 on these inputs (the primal ODE's
    image in device memory) against their plain versions; the stages of
    one mg step; the stencil matvec in float32 and float64 against its
    byte bound and a CSR product. 9b: the same problem with a forced
    dense LU (37,507² float64) and one ``gd_step`` each from the same
    control: J within 1e-9 relative, f_new within 1e-9·max|f_new|. 9c at
    Nx=192 (333,699 dofs, levels 192 → 96 → 48, 37,249 P1 dofs → CG
    projection): one Armijo iteration, every solve converged, the
    accepted probe's J below J₀, its seconds, then as in 9a;
19. path 10, the reference's golden viscosity ν = 0.01 and the float32
    dense knobs. 10a: the golden configuration (Nx=32, 10 buoys at
    x = 0.1, u_d synthesized at ν = 1 into ``data/ud_torch/10_buoys``)
    through ``pipelines.ocp.run`` with 6 continuation rungs and the
    --fast bundle (chord Newton, kernels 1–3, ``dense_apply="inverse"``),
    Armijo, 3 iterations: every rung and Newton solve converged (the
    solve log), the checks of path 3, J₀ beside the TPU record
    (information), vanilla Newton at the initial control reports
    ``converged=False`` with a residual above 1, and kernels 1–3 on the
    initial control's escaping buoys against their plain versions;
    ``golden_nu001_gd_iteration_seconds``. 10b: the hi-res study at ν =
    0.01 (Nx=64, mg, 400 buoys, 6 rungs; the Armijo search starts at 2⁻⁷,
    the LR it accepts from the study's LR 1), 2 driver iterations: every
    rung and solve the run went on with converged (rejected probes may
    stall), J₀ within 1e-6 of the TPU record, J₁ and the
    Newton iterations beside it, ``hires_nx64_nu001_gd_iteration_seconds``;
    one forward with a forced dense ladder at the initial control agrees
    with mg on J₀ within 1e-9, with its peak device memory. 10c: path 1's
    step with ``dense_apply="inverse"``, with ``newton_chord_f32`` and with
    both: J within 1e-9 relative of path 1's and f_new within
    1e-8·max|f_new|, the kernels' counts, the median of 3 steps, the
    stages;
20. path 11, the sharded steps over ``torch.distributed`` and gen-1, the
    ranks started by ``ocean_torch.parallel.launch.spawn``. 11a: path 1's
    step through ``parallel.make_sharded_step`` on one nccl rank: counts
    set to 0 in the rank, one step, counts read (kernels 1–3 only), J
    within 1e-12 relative and f_new within 1e-12 of phase 6's
    ``gd_step``, the same LR and escape count, the median of 3 steps,
    each timed after path 1's ``gd_step`` in the same rank (the ranks
    take phase 3's configuration, control and LR, and path 2's control);
    kernels 1–3 on the rank's lanes equal to their plain versions; then
    the step with Armijo against ``gd_step(use_line_search=True)``: the
    same LR, J and probes (primal ODE launches − 1). 11b: the same on
    three gloo ranks sharing the card (10⁴ lanes padded to 10,002), each
    rank's outputs bitwise equal to rank 0's (a broadcast and one
    ``all_reduce`` of the count of differing words); then path 2's step
    on two of them (kernels 1, 2 and 5 on each shard) with path 2's J,
    control and escape count. 11c: path 9a's configuration (Nx=64, mg,
    400 buoys) through ``make_sharded_step_2d`` on a 2 × 1 layout of gloo
    ranks and a 1 × 1 layout on nccl: J and f_new within 1e-9 of the
    single-device mg step, the same escape count. 11d:
    ``gen1.main.run(nx=32, K=5, num_steps=3, grad_check=True)``: J
    decreasing, the centred FD table within 0.2 of gradj (the JAX test's
    level); the gen-1 Stokes solve on path 6's graded pipe with its
    obstacle (dense LU): finite and driven. Prints
    ``sharded_gd_iteration_seconds_10000_buoys_{nccl1,gloo3}``,
    ``sharded2d_hires_nx64_gd_iteration_seconds_{gloo2,nccl1}`` and
    ``gen1_run_seconds_nx32``;
21. path 12, the package's surface and loaders. 12a, in path 11's nccl
    rank: two Armijo iterations of ``system.gd_multi_step`` on path 1's
    problem with its three hooks on the world group (buoy-sharded ODE and
    adjoint right-hand side, cell-sharded matvec), counts set to 0 before
    and read after (primal ODE = forwards, adjoint ODE and point sources
    = 2), beside two iterations of the single-device ``gd_multi_step``:
    J, LR, probes, escape counts and the final control equal bit for bit.
    12b: the f_new of path 1's Armijo step through
    ``io.torch_ckpt.save_control`` and the default ``load_control``: on
    the card, equal, and a GD step from it finite and equal to one from
    the control in memory. 12c: ``make_space``,
    ``make_boundary_quad`` and the gen-1 ``NavierStokesSolver`` without a
    device land on the card; the graded pipe's Stokes state equals 11d's.
    12d: ``import ocean_torch`` in a fresh interpreter imports no jax,
    matplotlib or h5py, leaves CUDA uninitialized, and
    ``ocean_torch.OCPConfig`` resolves;
22. path 13, the host-stepped solver layer (``system.make_staged_pair``,
    the stepped Newton and the staged adjoint, the driver's two modes,
    ``scripts/hires_mg_run_torch.py::run_gd_staged``), counts set to 0
    before and read after each part and summed. 13a: path 3's run with
    ``staged_driver=False`` (the per-stage mode; path 3 ran the staged
    mode): J, LR, probes, ‖div u‖ and the final control equal bit for
    bit. 13b: path 9a's problem (Nx=64, ν = 1, mg): ``run_newton_staged``
    against ``newton_solve_mg`` (the same iteration count, w within
    1e-12·max|w|), with ``max_refreeze=2, stall_ratio=0`` (two
    re-freezes, converged, within 1e-9), ``run_adjoint_staged`` against
    ``_solve_adjoint_flagged`` (z within 1e-12·max|z|), kernels 1–3 on
    its state. 13c: the ν = 0.01 study (Nx=64, 6 rungs) through
    ``run_gd_staged`` from LR 1, 2 iterations: iteration 0 accepts 2⁻⁷
    after 8 probes and J₀ lies within 1e-6 of the TPU record, J equals
    path 10b's driver bit for bit, J₁ and the Newton iterations beside
    the record's, kernels 1–3 on the last state. 13d: Nx=256 (592,387
    dofs, 4 levels, CG projection), 2 iterations from LR 1 with up to 12
    adjoint rounds: J within 1e-6 of the TPU record, adjoint rounds and
    final relative residual beside the record's, the peak device memory,
    kernels 1–3 on the last state;
23. path 14, the benchmark and the production entry points, each through
    the function its command line calls. 14a: ``bench_torch.main`` (the
    headline line of ``bench.py``: ``bench.py::_build``'s problem, a
    warm-up and 3 timed steps): counts set to 0 before and read after
    (kernels 1–3 once a step, 4 and 5 never), J equal bit for bit to
    path 10c's ``dense_apply="inverse"`` step. 14b:
    ``bench_torch.stages_main`` into a temporary directory: bench.py's
    keys, every value finite. 14c: ``bench_torch.multi_k_main``: the
    per-K envelope against the reference CPU (K = 10, 100, 400, 10⁴; at
    K = 10 and 100 ``gd_multi_step`` over 20 iterations), one line a K,
    the multi-step J equal to the host loop's (difference 0.0). 14d:
    ``scripts/flagship_refresh_torch.py`` for the record's 30 iterations,
    with the record as the previous run: exit "num_steps", the record's
    probes, every J within 1e-6 relative of ``results/flagship_10k/``,
    the launch counts its probes imply. 14e:
    ``scripts/lshape_production_torch.py`` under a CUDA-only profiler: the
    record's 28 iterations to the convergence exit, J within 1e-6 and
    probes equal to ``results/lshape_res50/``, the last |ΔJ| beside the
    record's; counts set to 0 before and read after (kernel 6 once a
    forward, the others never), and as many ``primal_ode`` spans as
    kernel 6's launches, each with ``table_kernel`` 1.
Phase 4 also runs the hard inputs of the "left" diagonal and the pipes.
Path 3 runs with ``dense_apply="inverse"`` (``limits.run``'s fast paths,
as in the JAX package).

The line before the last is the kernels' JSON record, one entry per
kernel and geometry (``geometry``; kernel 6's with its K and
``primal_ode_ms``), with the launches of paths 1–2 and
``launches_path3``, ``_path4``, ``_path8``, ``_path11`` (the counted
sharded steps of 11a and, for the segment sum, 11b), ``_path12`` (12a's
counted ``gd_multi_step``), ``_path13`` and ``_path14``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks at the full 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth and the float64 vector rate (the kernels do float64
# arithmetic outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOP_PER_S = 34e12

# float64 operations per item, counted from the kernel sources
# (ocean_torch/csrc): locate ≈ 10 (clamp, divide, floor, subtract), P2
# weights ≈ 25, 3×3 patch sum of 2 components = 36, Euler step 4; P1
# weights ≈ 6, 2×2 patch sum of 4 components = 32, μ update 12; per
# point-source lane: locate + P2 weights + 6 nonzero nodes × 2 components
# × (multiply + 4 split operations) = 95; ∇u evaluation point: locate 10
# + P1 weights 3 + 2×2 patch sum of 4 components 28 = 41; Ozaki value:
# divide by the scale, then 8 slices × (multiply, rint, divide, subtract)
# = 33; table ODE step: locate 10, ξ = J⁻¹(p − v₀) 8, P2 basis 18, six-term
# sum of 2 components 22, Euler step 4 = 62.
OPS_PRIMAL_STEP = 75
OPS_ADJOINT_STEP = 60
OPS_PSRC_POINT = 95
OPS_P1_EVAL_POINT = 41
OPS_OZAKI_VALUE = 33
OPS_TABLE_STEP = 62

TOL = 1e-12

PATH1 = ("primal_ode", "adjoint_ode", "point_sources")
PATH2 = ("primal_ode", "adjoint_ode", "segment_sum")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


_BUSY = []


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches after
    one warm-up, timed with CUDA events. The launches are queued behind a
    float32 matrix product of some 20 ms, so they run back to back on the
    card even where the host needs longer to launch a kernel than the
    card to run it (the ODE kernels take ~0.05 ms): the time is the
    kernel's, not the wrapper's."""
    import torch
    if not _BUSY:
        a = torch.ones(8192, 8192, device="cuda")
        _BUSY.extend([a, torch.empty_like(a)])
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.mm(_BUSY[0], _BUSY[0], out=_BUSY[1])
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def primal_bound(ge, K: int, nt: int):
    """Least time of the primal ODE: x0 and the image in, x, u, failed and
    kfail out, against the float64 operations of K·(nt−1) steps."""
    Hy, Hx = ge.hg_shape
    nbytes = 8 * (K * 2 + Hy * Hx * 2 + 2 * K * nt * 2) + 4 * 2 * K
    return bound_ms(nbytes, OPS_PRIMAL_STEP * K * (nt - 1))


def adjoint_bound(ge, K: int, nt: int):
    """Least time of the adjoint ODE: x, u − u_d, the ∇u image and the
    windows in, μ out."""
    Gy, Gx = ge.vg_shape
    nbytes = 8 * (3 * K * nt * 2 + Gy * Gx * 4) + 4 * K
    return bound_ms(nbytes, OPS_ADJOINT_STEP * K * (nt - 1))


def stage_seconds(prob, f, lr) -> dict:
    """Host-clock seconds of each stage of one GD step, in the order
    ``system.gd_step`` runs them, each ending in a synchronize: on the
    dense path the chord Newton and the transposed-factor adjoint solve,
    on the multigrid path the FGMRES Newton and the mixed-precision
    adjoint rounds."""
    import torch
    from ocean_torch import system
    from ocean_torch.fem import assemble

    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return val

    newton = timed("ns_newton", lambda: system.solve_ns(prob, f.quad))
    u, _ = prob.space.split(newton.w)
    ode = timed("primal_ode", lambda: system._primal_ode(prob, u))
    grad_u = timed("gradu_projection",
                   lambda: prob.projector.project(prob.space, u))
    state = (ode.x, ode.u_values, ode.mask, ode.x_raw, ode.kfail)
    mu = timed("adjoint_ode",
               lambda: system._adjoint_mu(prob, grad_u, *state))
    b = timed("point_sources",
              lambda: system._adjoint_sources(prob, u, mu, *state))
    op, op_c = timed("adjoint_assemble", lambda: system.adjoint_operators(
        prob, newton.w))
    fwd = system.ForwardState(newton.w, ode.x, ode.u_values, ode.mask,
                              newton, ode.x_raw, ode.kfail)
    z, _ = timed("adjoint_solve", lambda: system.solve_adjoint_system(
        prob, fwd, b, op, op_c))

    def update():
        g = system.reduced_gradient(prob, f, z)
        f_new = f.axpy(-lr, g)
        return (float(system.cost(prob, ode.u_values, f_new.quad)),
                float(assemble.divergence_l2(prob.space, u)))

    timed("gradient_update_cost", update)
    return out


def print_stages(name: str, prob, f, lr) -> None:
    stages = stage_seconds(prob, f, lr)
    print(f"{name} stages (s, host clock, one GD step): "
          f"{json.dumps(stages)} sum {sum(stages.values())!r}", flush=True)


def primal_ode_check(ge, u_img, x0, h, nt, label: str, card: str):
    """Kernel 1 on one velocity image: x, u, ``failed`` and ``kfail`` equal
    (``torch.equal``) to the plain version's and between two launches.
    Returns (max error, kernel ms, plain ms, escaped buoys)."""
    import torch
    from ocean_torch.ode.cuda_ode import (primal_ode_steps,
                                          primal_ode_steps_plain)

    got = primal_ode_steps(ge, u_img, x0, h, nt)
    again = primal_ode_steps(ge, u_img, x0, h, nt)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"primal_ode on {label}: two launches differ")
    plain = primal_ode_steps_plain(ge, u_img, x0, h, nt)
    for name, a, b in zip(("x", "u", "failed", "kfail"), got, plain):
        check(torch.equal(a, b), f"primal_ode on {label}: {name} differs "
              "from the plain version")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], plain[:2]))
    ms = cuda_ms(lambda: primal_ode_steps(ge, u_img, x0, h, nt), 20)
    plain_ms = cuda_ms(lambda: primal_ode_steps_plain(ge, u_img, x0, h, nt),
                       3)
    escaped = int(got[2].sum())
    print(f"primal_ode on {label} inputs: equal to the plain version, "
          f"max_abs_err={err!r} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"escaped={escaped} on {card}", flush=True)
    return err, ms, plain_ms, escaped


def adjoint_ode_check(ge, g_img, x, resid, vlimit, h, label: str, card: str):
    """Kernel 2 on one set of trajectories: μ equal (``torch.equal``) to
    the plain version's and between two launches, and finite. Returns
    (max error, kernel ms, plain ms)."""
    import torch
    from ocean_torch.ode.cuda_adjoint import (adjoint_ode_steps,
                                              adjoint_ode_steps_plain)

    got = adjoint_ode_steps(ge, g_img, x, resid, vlimit, h)
    again = adjoint_ode_steps(ge, g_img, x, resid, vlimit, h)
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"adjoint_ode on {label}: two launches differ")
    plain = adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit, h)
    check(torch.equal(got, plain),
          f"adjoint_ode on {label}: μ differs from the plain version")
    check(bool(torch.isfinite(got).all()),
          f"adjoint_ode on {label}: non-finite μ")
    ms = cuda_ms(lambda: adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
                 20)
    plain_ms = cuda_ms(lambda: adjoint_ode_steps_plain(ge, g_img, x, resid,
                                                       vlimit, h), 3)
    err = float((got - plain).abs().max())
    windows = int((vlimit < x.shape[1]).sum())
    print(f"adjoint_ode on {label} inputs: equal to the plain version, "
          f"max_abs_err={err!r} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"windows={windows} on {card}", flush=True)
    return err, ms, plain_ms


def p1_eval_record(ge, g_img, x, label: str = "") -> dict:
    """Kernel 4 (∇u at every trajectory point) against its plain version:
    values and inside flags equal (``torch.equal``)."""
    import torch
    from ocean_torch.ode.cuda_eval import eval_p1_tensor_cuda
    from ocean_torch.ode.grideval import eval_p1_tensor_grid

    vk, ik = eval_p1_tensor_cuda(ge, g_img, x)
    torch.cuda.synchronize()
    vp, ip = eval_p1_tensor_grid(ge, g_img, x)
    check(torch.equal(ik, ip), "p1_eval: inside flags differ from the plain "
          "version")
    err = float((vk - vp).abs().max())
    check(err <= TOL, f"p1_eval: max error {err} > {TOL}")
    check(torch.equal(vk, vp), "p1_eval: values differ from the plain "
          "version")
    ms = cuda_ms(lambda: eval_p1_tensor_cuda(ge, g_img, x), 20)
    plain = cuda_ms(lambda: eval_p1_tensor_grid(ge, g_img, x), 5)
    n = x.numel() // 2
    Gy, Gx = ge.vg_shape
    nbytes = 8 * (2 * n + 4 * Gy * Gx + 4 * n) + n
    b, by = bound_ms(nbytes, OPS_P1_EVAL_POINT * n)
    print(f"p1_eval{label}: max_abs_err={err!r} N={n} outside={int((~ik).sum())} "
          f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f}", flush=True)
    return dict(name="p1_eval", route="cuda",
                source="ocean_torch/csrc/p1_eval.cu",
                replaces="ocean_jax/ode/pallas_eval.py:201",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None)


def point_sources_record(ge, x, gamma, label: str = "") -> dict:
    """Kernel 3 (fused point sources) on the γ a path builds: limbs equal
    to the plain version's and between two launches, the image within
    1e-10 of a float64 ``index_add_`` of the same terms."""
    import torch
    from ocean_torch.adjoint.cuda_psrc import (point_source_limbs,
                                               point_source_limbs_plain)
    from ocean_torch.ode.grideval import grid_coords, p2_patch_weights
    from ocean_torch.ops.scatter import pow2_scale

    Hy, Hx = ge.hg_shape
    dev = x.device
    pts = x.reshape(-1, 2).contiguous()
    scale = pow2_scale(gamma.reshape(-1, 2))
    r = (gamma.reshape(-1, 2) / scale).contiguous()
    hk, lk = point_source_limbs(ge, pts, r)
    hk2, lk2 = point_source_limbs(ge, pts, r)
    torch.cuda.synchronize()
    check(torch.equal(hk, hk2) and torch.equal(lk, lk2),
          "point_sources: two launches differ")
    hp, lp = point_source_limbs_plain(ge, pts, r)
    check(torch.equal(hk, hp) and torch.equal(lk, lp),
          "point_sources: limbs differ from the plain version")

    def image(hi, lo):                      # (Hy·Hx, 2) in units of γ
        return (hi.double() * 2.0 ** -40 + lo.double() * 2.0 ** -80) * scale

    img_k = image(hk, lk)
    err = float((img_k - image(hp, lp)).abs().max())
    check(err <= TOL, f"point_sources: max error {err} > {TOL}")
    # against a plain float64 scatter of the same terms, whose own
    # rounding grows with the ~10⁴ terms per node (reported, bounded at
    # 1e-10 rather than 1e-12)
    ix, iy, s, t = grid_coords(ge.locator, pts)
    W = p2_patch_weights(s, t, ge.locator.diagonal).reshape(-1, 9)
    offs = torch.tensor([bb * Hx + a for bb in range(3) for a in range(3)],
                        device=dev)
    nodes = (((2 * iy) * Hx + 2 * ix)[:, None] + offs).reshape(-1)
    vals = (W[:, :, None] * r[:, None, :]).reshape(-1, 2).contiguous()
    img_f64 = torch.zeros(Hy * Hx, 2, dtype=torch.float64, device=dev)
    img_f64.index_add_(0, nodes, vals)
    err_f64 = float((img_k - img_f64 * scale).abs().max())
    check(err_f64 <= 1e-10, f"point_sources: {err_f64} from the f64 sum")
    ms = cuda_ms(lambda: point_source_limbs(ge, pts, r), 20)
    plain = cuda_ms(lambda: point_source_limbs_plain(ge, pts, r), 3)
    lib = cuda_ms(lambda: torch.zeros(Hy * Hx, 2, dtype=torch.float64,
                                      device=dev).index_add_(0, nodes, vals),
                  20)
    M = pts.shape[0]
    active = int((r != 0).any(dim=1).sum())
    nbytes = 8 * (2 * M * 2) + 8 * 2 * Hy * Hx * 2
    b, by = bound_ms(nbytes, OPS_PSRC_POINT * active)
    print(f"point_sources{label}: max_abs_err={err!r} vs_f64_sum={err_f64!r} "
          f"M={M} active={active} ms={ms:.4f} plain_ms={plain:.4f} "
          f"index_add_ms={lib:.4f} bound_ms={b:.4f}", flush=True)
    return dict(name="point_sources", route="cuda",
                source="ocean_torch/csrc/point_sources.cu",
                replaces="ocean_jax/adjoint/pallas_psrc.py:226",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def segment_sum_record(cell, vals, scale, num_cells: int,
                       label: str = "") -> dict:
    """Kernel 5 (exact slice sums of the Ozaki segment sum) on the (M, 12)
    per-point terms: two launches and the plain version bit-identical,
    the recombined sums within 1e-12·scale of a float64 ``index_add_``."""
    import torch
    from ocean_torch.ops.psum_cuda import (ozaki_slice_sums,
                                           ozaki_slice_sums_plain)
    from ocean_torch.ops.scatter import ozaki_segment_sum

    S = num_cells
    ak = ozaki_slice_sums(cell, vals, scale, S)
    ak2 = ozaki_slice_sums(cell, vals, scale, S)
    torch.cuda.synchronize()
    check(torch.equal(ak, ak2), "segment_sum: two launches differ")
    ap = ozaki_slice_sums_plain(cell, vals, scale, S)
    check(torch.equal(ak, ap), "segment_sum: differs from the plain version")
    err = float((ak - ap).abs().max())
    out = ozaki_segment_sum(cell, vals, S)

    def index_add(v):
        return torch.zeros(S, 12, dtype=torch.float64,
                           device=vals.device).index_add_(0, cell, v)

    # A float64 reference accurate to ~1e-17·scale: each value split into
    # a high part on the 2^-26·scale grid, whose sums are exact in any
    # order (fewer than 2^26 terms per segment), and a remainder below
    # 2^-27·scale. Bound: 1e-12·scale, plus the rounding of each sum
    # itself to float64 (half an ulp on each side).
    step = scale * 2.0 ** -26
    hi = torch.round(vals / step) * step
    exact = index_add(hi) + index_add(vals - hi)
    err_exact = float(((out - exact).abs() / scale).max())
    check(bool(((out - exact).abs()
                <= 1e-12 * scale + 2.0 ** -52 * exact.abs()).all()),
          f"segment_sum: {err_exact}·scale from the exact reference")
    # the plain float64 index_add_ is itself off by up to (n−1)·2^-53·Σ|v|
    # per segment of n terms, far above 1e-12·scale for long segments of
    # one sign; it is held to that bound
    ref = index_add(vals)
    n = torch.bincount(cell, minlength=S + 1)[:S, None].to(torch.float64)
    own = (n - 1).clamp(min=0) * 2.0 ** -53 * index_add(vals.abs())
    err_f64 = float(((out - ref).abs() / scale).max())
    check(bool(((out - ref).abs()
                <= 1e-12 * scale + 2.0 ** -52 * exact.abs() + own).all()),
          f"segment_sum: {err_f64}·scale from the float64 index_add_")
    ms = cuda_ms(lambda: ozaki_slice_sums(cell, vals, scale, S), 20)
    plain = cuda_ms(lambda: ozaki_slice_sums_plain(cell, vals, scale, S), 3)
    lib = cuda_ms(lambda: torch.zeros(S, 12, dtype=torch.float64,
                                      device=vals.device)
                  .index_add_(0, cell, vals), 20)
    M = vals.shape[0]
    nbytes = 8 * (12 * M + M + 12 + 8 * 12 * S)
    b, by = bound_ms(nbytes, OPS_OZAKI_VALUE * 12 * M)
    print(f"segment_sum{label}: max_abs_err={err!r} (int64 slice sums) "
          f"vs_exact={err_exact!r}·scale vs_index_add={err_f64!r}·scale "
          f"max_terms={int(n.max())} M={M} S={S} ms={ms:.4f} "
          f"plain_ms={plain:.4f} index_add_ms={lib:.4f} bound_ms={b:.4f}",
          flush=True)
    return dict(name="segment_sum", route="cuda",
                source="ocean_torch/csrc/segment_sum.cu",
                replaces="ocean_jax/ops/psum_pallas.py:113",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def hard_inputs(ge32) -> None:
    """The two ODE and the two scatter kernels on the small hard inputs of
    ``tests/torch_kernel_cases.py``, each equal (``torch.equal``) to its
    plain version on the card. The cases run on the main path's Nx=32
    grid (``ge32``); the ODE cases that name a grid run on Nx=12 (a
    spacing that is divided) and Nx=64 (an image too large for shared
    memory), and the point sources on Nx=64 too."""
    import torch
    import torch_kernel_cases as kernel_cases
    from ocean_torch.adjoint import cuda_psrc
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import structured
    from ocean_torch.ode import cuda_adjoint, cuda_ode
    from ocean_torch.ode.grideval import make_grideval
    from ocean_torch.ops import psum_cuda

    dev = ge32.dof_to_node.device
    grids = {32: ge32}
    for nx in (12, 64):
        grids[nx] = make_grideval(make_space(structured.rectangle_mesh(
            (0.0, 0.0), (2.0, 2.0), nx, nx), dev))
    for case in kernel_cases.PRIMAL_CASES:
        ge = grids[kernel_cases.ode_case_nx(case, 32)]
        u_img, x0, h, nt = kernel_cases.primal_ode_case(case, 32)
        u_img, x0 = u_img.to(dev), x0.to(dev)
        got = cuda_ode.primal_ode_steps(ge, u_img, x0, h, nt)
        plain = cuda_ode.primal_ode_steps_plain(ge, u_img, x0, h, nt)
        check(all(torch.equal(a, b) for a, b in zip(got, plain)),
              f"primal_ode, hard input {case!r}: differs from the plain "
              "version")
    for case in kernel_cases.ADJOINT_CASES:
        ge = grids[kernel_cases.ode_case_nx(case, 32)]
        g_img, x, resid, vlimit, h = (
            a.to(dev) if torch.is_tensor(a) else a
            for a in kernel_cases.adjoint_ode_case(case, 32))
        check(torch.equal(
            cuda_adjoint.adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
            cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid,
                                                 vlimit, h)),
              f"adjoint_ode, hard input {case!r}: μ differs from the plain "
              "version")
    for nx, ge in ((32, ge32), (64, grids[64])):
        for case in kernel_cases.PSRC_CASES:
            pts, r = (a.to(dev) for a in
                      kernel_cases.point_source_case(case, nx))
            hk, lk = cuda_psrc.point_source_limbs(ge, pts, r)
            hp, lp = cuda_psrc.point_source_limbs_plain(ge, pts, r)
            check(torch.equal(hk, hp) and torch.equal(lk, lp),
                  f"point_sources, hard input {case!r} at Nx={nx}: limbs "
                  "differ from the plain version")
    for case in kernel_cases.SEG_CASES:
        ids, vals, scale, S = kernel_cases.segment_sum_case(case)
        ids, vals, scale = ids.to(dev), vals.to(dev), scale.to(dev)
        check(torch.equal(psum_cuda.ozaki_slice_sums(ids, vals, scale, S),
                          psum_cuda.ozaki_slice_sums_plain(ids, vals, scale,
                                                           S)),
              f"segment_sum, hard input {case!r}: differs from the plain "
              "version")
    torch.cuda.synchronize()
    print(f"hard inputs: primal_ode {len(kernel_cases.PRIMAL_CASES)} and "
          f"adjoint_ode {len(kernel_cases.ADJOINT_CASES)} cases (Nx 32, 12 "
          f"and 64), point_sources {len(kernel_cases.PSRC_CASES)} cases "
          f"× Nx 32 and 64, segment_sum "
          f"{len(kernel_cases.SEG_CASES)} cases: all equal to the plain "
          "versions", flush=True)


def lshape_hard_inputs(dev) -> None:
    """All five kernels on the L-shape hard inputs of
    ``tests/torch_kernel_cases.py``, each equal (``torch.equal``) to its
    plain version on the card. The cases run at resolution 32; the ODE
    cases that name a resolution run at 50 (the half-grid image just fits
    in shared memory beside the staging rows) and 64 (it does not), the
    point cases at 32 and 64."""
    import numpy as np
    import torch
    import torch_kernel_cases as kernel_cases
    from ocean_torch.adjoint import cuda_psrc
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import locate_points, structured
    from ocean_torch.ode import cuda_adjoint, cuda_eval, cuda_ode
    from ocean_torch.ode.grideval import eval_p1_tensor_grid, make_grideval
    from ocean_torch.ops import psum_cuda
    from ocean_torch.ops.scatter import pow2_scale

    spaces = {res: make_space(structured.l_shape_mesh(res), dev)
              for res in (32, 50, 64)}
    grids = {res: make_grideval(sp) for res, sp in spaces.items()}
    for res in (50, 64):
        Hy, Hx = grids[res].hg_shape
        image = 16 * Hy * Hx
        total = cuda_ode.shared_bytes(grids[res])
        print(f"primal_ode on the L-shape at resolution {res}: image "
              f"{image} B, dynamic shared memory {total} B a block of "
              f"{cuda_ode.SHARED_LIMIT} B allowed: image in "
              f"{'shared' if total > image else 'device'} memory",
              flush=True)
    check(cuda_ode.shared_bytes(grids[50]) == 52224 + 163216
          and cuda_ode.shared_bytes(grids[64]) == 52224,
          "primal_ode: shared-memory size rule on the L-shape")
    for case in kernel_cases.LSHAPE_PRIMAL_CASES:
        ge = grids[kernel_cases.lshape_case_res(case, 32)]
        u_img, x0, h, nt = kernel_cases.lshape_primal_case(case, 32)
        u_img, x0 = u_img.to(dev), x0.to(dev)
        got = cuda_ode.primal_ode_steps(ge, u_img, x0, h, nt)
        plain = cuda_ode.primal_ode_steps_plain(ge, u_img, x0, h, nt)
        check(all(torch.equal(a, b) for a, b in zip(got, plain)),
              f"primal_ode, L-shape hard input {case!r}: differs from the "
              "plain version")
        check(bool(got[2].any()), f"primal_ode, L-shape hard input "
              f"{case!r}: no buoy left the domain")
    for case in kernel_cases.LSHAPE_ADJOINT_CASES:
        ge = grids[kernel_cases.lshape_case_res(case, 32)]
        g_img, x, resid, vlimit, h = (
            a.to(dev) if torch.is_tensor(a) else a
            for a in kernel_cases.lshape_adjoint_case(case, 32))
        check(torch.equal(
            cuda_adjoint.adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
            cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid,
                                                 vlimit, h)),
              f"adjoint_ode, L-shape hard input {case!r}: μ differs from "
              "the plain version")
    rng = np.random.default_rng(43)
    for res in (32, 64):
        ge, sp = grids[res], spaces[res]
        Gy, Gx = ge.vg_shape
        g_img = torch.as_tensor(rng.standard_normal((Gy * Gx, 2, 2)),
                                device=dev)
        for case in kernel_cases.LSHAPE_POINT_CASES:
            pts, r = (a.to(dev) for a in
                      kernel_cases.lshape_point_case(case, res))
            where = f"L-shape hard input {case!r} at resolution {res}"
            hk, lk = cuda_psrc.point_source_limbs(ge, pts, r)
            hp, lp = cuda_psrc.point_source_limbs_plain(ge, pts, r)
            check(torch.equal(hk, hp) and torch.equal(lk, lp),
                  f"point_sources, {where}: limbs differ from the plain "
                  "version")
            vk, ik = cuda_eval.eval_p1_tensor_cuda(ge, g_img, pts)
            vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
            check(torch.equal(vk, vp) and torch.equal(ik, ip),
                  f"p1_eval, {where}: differs from the plain version")
            check(bool(ik.any()) and not bool(ik.all()),
                  f"p1_eval, {where}: points on one side only")
            # the segment sum takes the cells these points are located in
            cell, _, _ = locate_points(sp.locator, pts)
            vals = torch.as_tensor(
                rng.standard_normal((pts.shape[0], 12)), device=dev)
            scale = pow2_scale(vals)
            check(torch.equal(
                psum_cuda.ozaki_slice_sums(cell, vals, scale, sp.num_cells),
                psum_cuda.ozaki_slice_sums_plain(cell, vals, scale,
                                                 sp.num_cells)),
                  f"segment_sum, {where}: differs from the plain version")
    torch.cuda.synchronize()
    n_pt = len(kernel_cases.LSHAPE_POINT_CASES)
    print(f"L-shape hard inputs: primal_ode "
          f"{len(kernel_cases.LSHAPE_PRIMAL_CASES)} and adjoint_ode "
          f"{len(kernel_cases.LSHAPE_ADJOINT_CASES)} cases (resolutions 32, "
          f"50 and 64), point_sources, p1_eval and segment_sum {n_pt} cases "
          f"× resolutions 32 and 64: all equal to the plain versions",
          flush=True)


RECTANGLE = "rectangle, Nx=32"       # the geometry of phase 4's records

KERNEL_FILES = {
    "primal_ode": ("ocean_torch/csrc/primal_ode.cu",
                   "ocean_jax/ode/pallas_ode.py:480"),
    "adjoint_ode": ("ocean_torch/csrc/adjoint_ode.cu",
                    "ocean_jax/ode/pallas_adjoint.py:326"),
}


def ode_record(name: str, geometry: str, err, ms, plain, bound) -> dict:
    """The kernels-line record of one ODE kernel on one geometry."""
    source, replaces = KERNEL_FILES[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                geometry=geometry, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def domain_hard_inputs(dev) -> None:
    """The four grid kernels on the hard inputs of the other domains
    (``tests/torch_kernel_cases.py``), each equal to its plain version on
    the card (``same``: ``torch.equal`` with NaN equal to NaN, for buoys
    that start at NaN): the rectangle's and the L-shape's cases on the
    "left" diagonal (Nx 32, 12 and 64; resolutions 32, 50 and 64) with
    points on the anti-diagonals s + t = 1, and the pipe cases (fringe,
    buoys entering the removed squares at the first, a middle and the
    last step, grid lines, NaN, walks) on the four pipe meshes."""
    import numpy as np
    import torch
    import torch_kernel_cases as kc
    from ocean_torch.adjoint import cuda_psrc
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import structured
    from ocean_torch.ode import cuda_adjoint, cuda_eval, cuda_ode
    from ocean_torch.ode.grideval import eval_p1_tensor_grid, make_grideval

    counts = dict(primal=0, adjoint=0, points=0)

    def primal(ge, case, where):
        u_img, x0, h, nt = case
        u_img, x0 = u_img.to(dev), x0.to(dev)
        got = cuda_ode.primal_ode_steps(ge, u_img, x0, h, nt)
        plain = cuda_ode.primal_ode_steps_plain(ge, u_img, x0, h, nt)
        check(all(kc.same(a, b) for a, b in zip(got, plain)),
              f"primal_ode, hard input {where}: differs from the plain "
              "version")
        counts["primal"] += 1

    def adjoint(ge, case, where):
        g_img, x, resid, vlimit, h = (a.to(dev) if torch.is_tensor(a) else a
                                      for a in case)
        check(torch.equal(
            cuda_adjoint.adjoint_ode_steps(ge, g_img, x, resid, vlimit, h),
            cuda_adjoint.adjoint_ode_steps_plain(ge, g_img, x, resid, vlimit,
                                                 h)),
              f"adjoint_ode, hard input {where}: μ differs from the plain "
              "version")
        counts["adjoint"] += 1

    def points(ge, pts, r, where):
        pts, r = pts.to(dev), r.to(dev)
        hk, lk = cuda_psrc.point_source_limbs(ge, pts, r)
        hp, lp = cuda_psrc.point_source_limbs_plain(ge, pts, r)
        check(torch.equal(hk, hp) and torch.equal(lk, lp),
              f"point_sources, hard input {where}: limbs differ from the "
              "plain version")
        Gy, Gx = ge.vg_shape
        g_img = torch.as_tensor(np.random.default_rng(43).standard_normal(
            (Gy * Gx, 2, 2)), device=dev)
        pts = torch.cat([pts, torch.tensor(
            [[np.nan, 1.0], [0.2, np.nan], [np.inf, 0.3]],
            dtype=torch.float64, device=dev)])
        vk, ik = cuda_eval.eval_p1_tensor_cuda(ge, g_img, pts)
        vp, ip = eval_p1_tensor_grid(ge, g_img, pts)
        check(kc.same(vk, vp) and torch.equal(ik, ip),
              f"p1_eval, hard input {where}: differs from the plain version")
        check(bool(ik.any()) and not bool(ik.all()),
              f"p1_eval, hard input {where}: points on one side only")
        counts["points"] += 1

    def space(mesh):
        return make_grideval(make_space(mesh, dev))

    left = {nx: space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), nx, nx, diagonal="left"))
        for nx in (32, 12, 64)}
    for case in kc.PRIMAL_CASES:
        primal(left[kc.ode_case_nx(case, 32)], kc.primal_ode_case(case, 32),
               f"{case!r} (left)")
    primal(left[32], kc.left_primal_case(32), "'anti_diagonal' (left)")
    for case in kc.ADJOINT_CASES:
        adjoint(left[kc.ode_case_nx(case, 32)],
                kc.adjoint_ode_case(case, 32), f"{case!r} (left)")
    for case in kc.PSRC_CASES:
        pts, r = kc.point_source_case(case, 32)
        extra = torch.as_tensor(kc.anti_diagonal_points(32))
        points(left[32], torch.cat([pts, extra]),
               torch.cat([r, torch.full_like(extra, 0.5)]),
               f"{case!r} (left)")
    lleft = {res: space(structured.l_shape_mesh(res, diagonal="left"))
             for res in (32, 50, 64)}
    for case in kc.LSHAPE_PRIMAL_CASES:
        primal(lleft[kc.lshape_case_res(case, 32)],
               kc.lshape_primal_case(case, 32), f"L-shape {case!r} (left)")
    for case in kc.LSHAPE_ADJOINT_CASES:
        adjoint(lleft[kc.lshape_case_res(case, 32)],
                kc.lshape_adjoint_case(case, 32),
                f"L-shape {case!r} (left)")
    for case in kc.LSHAPE_POINT_CASES:
        points(lleft[32], *kc.lshape_point_case(case, 32),
               f"L-shape {case!r} (left)")
    for name, kw in sorted(kc.PIPE_MESHES.items()):
        mesh, _ = structured.pipe_mesh(**kw)
        ge = space(mesh)
        for mesh_name, case in kc.pipe_primal_cases():
            if mesh_name == name:
                primal(ge, kc.pipe_primal_case(case, mesh),
                       f"{case!r} (pipe {name})")
        for case in kc.PIPE_ADJOINT_CASES:
            adjoint(ge, kc.pipe_adjoint_case(case, mesh),
                    f"{case!r} (pipe {name})")
        for case in kc.PIPE_POINT_CASES:
            points(ge, *kc.pipe_point_case(case, mesh),
                   f"{case!r} (pipe {name})")
    torch.cuda.synchronize()
    print(f"hard inputs of the other domains: primal_ode {counts['primal']}, "
          f"adjoint_ode {counts['adjoint']} and point_sources + p1_eval "
          f"{counts['points']} cases (the left diagonal on the rectangle "
          "and the L-shape, the four pipe meshes): all equal to the plain "
          "versions", flush=True)


def pipe_record_sizes(dev, card) -> None:
    """Path 6 at the TPU record's sizes, inputs made as
    ``scripts/pallas_domains_hw.py`` makes them: the primal ODE equal to
    its plain version with the record's escape count, and the ∇u
    evaluation on 4,096 points."""
    import numpy as np
    import torch
    from torch_kernel_cases import PIPE_RECORD
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import structured
    from ocean_torch.ode.grideval import (grad_to_grid, make_grideval,
                                          velocity_to_grid)

    for name, (kw, escapes_tpu) in sorted(PIPE_RECORD.items()):
        mesh, _ = structured.pipe_mesh(**kw)
        sp = make_space(mesh, dev)
        ge = make_grideval(sp)
        rng = np.random.default_rng(7)
        u = torch.as_tensor(0.6 * rng.standard_normal((sp.n_p2, 2)),
                            device=dev)
        K, nt, h = 512, 200, 0.005
        x0 = torch.as_tensor(rng.uniform(0.05, 1.95, (K, 2)), device=dev)
        _, _, _, escaped = primal_ode_check(
            ge, velocity_to_grid(ge, u), x0, h, nt,
            f"{name} {mesh.grid_shape} K=512", card)
        print(f"{name}: {escaped} of {K} buoys escape, the TPU record "
              f"{escapes_tpu}", flush=True)
        check(escaped == escapes_tpu, f"{name}: {escaped} escapes, the "
              f"record {escapes_tpu}")
        grad_u = torch.as_tensor(rng.standard_normal((sp.n_p1, 2, 2)),
                                 device=dev)
        pts = torch.as_tensor(rng.uniform([0.0, 0.0], [2.0, 2.0],
                                          (4096, 2)), device=dev)
        p1_eval_record(ge, grad_to_grid(ge, grad_u), pts,
                       f" on {name} (4,096 points)")


PIPE_REAL = (
    ("pipe, obstacle, graded (gmsh defaults)",
     dict(obstacle=True, graded=True)),
    ("pipe, obstacle, uniform (resolution 22)",
     dict(resolution=22, obstacle=True)),
)


def pipe_real_size(dev, card) -> list:
    """Path 6 at a real size: the pipe with its obstacle on the graded
    grid of the gmsh defaults (73 squares an axis, the half-grid image too
    large for shared memory) and on the uniform 22 × 22 grid; 10⁴ seeds (a
    tenth in the fringe between the disk and the removed squares), nt=200,
    a smooth analytic flow along the pipe. The path runs once with the
    counts set to 0 (primal ODE, ∇u projection, reference adjoint ODE,
    fused point sources with γ from ``fused_gamma`` and the escape mask,
    ∇u at every raw trajectory point), then each kernel is held to its
    plain version and timed. Buoys must leave both through the obstacle
    and through the outer boundary. Returns the kernels' records."""
    import numpy as np
    import torch
    import torch_kernel_cases as kc
    from ocean_torch import kernels
    from ocean_torch.adjoint.cuda_psrc import point_source_image
    from ocean_torch.adjoint.point_sources import fused_gamma
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import structured
    from ocean_torch.mesh.locate import in_domain
    from ocean_torch.ode import (cuda_ode, eval_p1_tensor_cuda,
                                 solve_adjoint_ode_cuda,
                                 solve_primal_ode_cuda)
    from ocean_torch.ode.grideval import (grad_to_grid, make_grideval,
                                          velocity_to_grid)
    from ocean_torch.solve import GradProjector

    records = []
    for label, kw in PIPE_REAL:
        mesh, _ = structured.pipe_mesh(**kw)
        sp = make_space(mesh, dev)
        ge = make_grideval(sp)
        Hy, Hx = ge.hg_shape
        total = cuda_ode.shared_bytes(ge)
        geometry = f"{label}, {mesh.grid_shape[0]}x{mesh.grid_shape[1]}"
        print(f"{geometry}: {sp.ndof} mixed dofs, image {16 * Hy * Hx} B, "
              f"primal_ode dynamic shared memory {total} B: image in "
              f"{'shared' if total > 16 * Hy * Hx else 'device'} memory",
              flush=True)
        # a smooth flow along the pipe, through and past the obstacle (a
        # random P2 field, as at the record's sizes, has gradients of
        # O(1/h_min) on the fine cells, and μ grows by (1 + h·|∇u|) a step)
        c = sp.dof_coords_p2
        u = torch.stack([0.6 + 0.3 * torch.sin(np.pi * c[:, 1]),
                         0.3 * torch.sin(np.pi * c[:, 0])
                         * torch.cos(np.pi * c[:, 1])], 1)
        rng = np.random.default_rng(7)
        K, nt, h = 10000, 200, 0.005
        seeds = torch.as_tensor(np.concatenate([
            rng.uniform(0.02, 1.98, (9000, 2)), kc.fringe_points(mesh, 1000)]),
            device=dev)
        center = torch.tensor([1.0, 1.0], dtype=torch.float64, device=dev)
        u_d = torch.zeros(K, nt, 2, dtype=torch.float64, device=dev)
        kernels.reset_launch_counts()
        ode = solve_primal_ode_cuda(ge, u, seeds, h, nt, center)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        projector = GradProjector.build(sp)
        grad_u = projector.project(sp, u)
        torch.cuda.synchronize()
        t_proj = time.perf_counter() - t0
        mu = solve_adjoint_ode_cuda(ge, grad_u, ode.x, ode.u_values, u_d,
                                    ode.mask, h)
        active = (~ode.mask)[:, None].expand(K, nt)
        gamma = fused_gamma(sp, u, ode.x, mu, u_d, active, h, center,
                            ode.u_values)
        b = point_source_image(ge, ode.x, gamma)
        g_img = grad_to_grid(ge, grad_u)
        vals, _ = eval_p1_tensor_cuda(ge, g_img, ode.x_raw)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {"primal_ode": 1, "adjoint_ode": 1, "point_sources": 1,
                "p1_eval": 1, "segment_sum": 0, "table_ode": 0}
        check(counts == want, f"{geometry}: launches {counts}, expected "
              f"{want}")
        check(bool(torch.isfinite(b).all()) and bool(
            torch.isfinite(vals).all()) and bool(torch.isfinite(mu).all()),
              f"{geometry}: non-finite results")
        # where each escaped buoy was at its first failing step: beyond
        # the outer boundary, or in the obstacle or its fringe
        kf = ode.kfail.to(torch.int64).clamp(max=nt - 1)
        gone = ode.x_raw[torch.arange(K, device=dev), kf][ode.mask]
        outer = ((gone < -1e-12) | (gone > 2.0 + 1e-12)).any(1)
        n_outer, n_hole = int(outer.sum()), int((~outer).sum())
        check(not bool(in_domain(ge.locator, gone).any()),
              f"{geometry}: an escaped buoy's first failing point is inside")
        print(f"{geometry}, {K} seeds: {int(ode.mask.sum())} buoys leave, "
              f"{n_hole} through the obstacle (the 1000 fringe seeds at "
              f"step 0 among them) and {n_outer} through the outer "
              f"boundary; ∇u projection {t_proj!r} s; launches {counts}",
              flush=True)
        check(n_outer >= 1 and n_hole >= 1, f"{geometry}: buoys leave "
              f"through the obstacle {n_hole}, the outer boundary "
              f"{n_outer}")
        err, ms, plain, _ = primal_ode_check(ge, velocity_to_grid(ge, u),
                                             seeds, h, nt, geometry, card)
        records.append(ode_record("primal_ode", geometry, err, ms, plain,
                                  primal_bound(ge, K, nt)))
        # the raw positions keep the escaped buoys where they left, in the
        # obstacle or its fringe: the carry of the last in-domain ∇u
        vlimit = torch.full((K,), nt, dtype=torch.int32, device=dev)
        err, ms, plain = adjoint_ode_check(
            ge, g_img, ode.x_raw.contiguous(),
            (ode.u_values - u_d).contiguous(), vlimit, h, geometry, card)
        records.append(ode_record("adjoint_ode", geometry, err, ms, plain,
                                  adjoint_bound(ge, K, nt)))
        records.append(point_sources_record(ge, ode.x, gamma,
                                            f" on {geometry}"))
        records.append(p1_eval_record(ge, g_img, ode.x_raw,
                                      f" on {geometry}"))
        for rec in records[-4:]:
            rec["geometry"] = geometry
            rec["launches"] = counts[rec["name"]]
    return records


def path5_kernels(prob, res, counts: dict, card: str) -> list:
    """Kernels 1–3 on path 5's inputs and kernel 4 through the ``grid=``
    adjoint entry point, each held to its plain version and timed as in
    phase 4. Returns the kernels' records."""
    import torch
    from ocean_torch import kernels
    from ocean_torch.ode import solve_adjoint_ode, solve_adjoint_ode_cuda
    from ocean_torch.ode.grideval import grad_to_grid, velocity_to_grid

    geometry = "rectangle, left diagonal, Nx=32"
    ge, K, nt, h = prob.grid, prob.K, prob.nt, prob.h
    fwd = res.fwd
    u, _ = prob.space.split(fwd.w)
    err, ms, plain, _ = primal_ode_check(ge, velocity_to_grid(ge, u),
                                         prob.x0, h, nt, "path 5", card)
    records = [ode_record("primal_ode", geometry, err, ms, plain,
                          primal_bound(ge, K, nt))]
    grad_u = prob.projector.project(prob.space, u)
    g_img = grad_to_grid(ge, grad_u)
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=prob.device)
    err, ms, plain = adjoint_ode_check(
        ge, g_img, fwd.x, (fwd.u_values - prob.u_d).contiguous(), vlimit, h,
        "path 5", card)
    records.append(ode_record("adjoint_ode", geometry, err, ms, plain,
                              adjoint_bound(ge, K, nt)))
    records.append(point_sources_record(
        *scatter_inputs(prob, fwd)["point_sources"], " on path 5"))
    kernels.reset_launch_counts()
    mu_par = solve_adjoint_ode(prob.space, grad_u, fwd.x, fwd.u_values,
                               prob.u_d, fwd.mask, h, method="parallel",
                               grid=ge)
    torch.cuda.synchronize()
    n_eval = kernels.LAUNCHES["p1_eval"]
    check(n_eval == 1, "path 5: solve_adjoint_ode(grid=) did not launch "
          "p1_eval once")
    mu_seq = solve_adjoint_ode_cuda(ge, grad_u, fwd.x, fwd.u_values,
                                    prob.u_d, fwd.mask, h)
    err_par = float((mu_par - mu_seq).abs().max())
    check(err_par <= TOL, f"path 5: parallel adjoint vs kernel: {err_par}")
    print(f"path 5 grid= adjoint entry point: parallel vs kernel "
          f"{err_par!r}", flush=True)
    records.append(p1_eval_record(ge, g_img, fwd.x, " on path 5"))
    for rec in records:
        rec["geometry"] = geometry
        rec["launches"] = (n_eval if rec["name"] == "p1_eval"
                           else counts[rec["name"]])
    return records


def small_reference_armijo(name: str, cfg, control, u_d=None, x0=None):
    """Three driver iterations with the Armijo line search at a small size
    through the kernels on the card against the plain versions on the
    CPU: equal ``inner_iterations`` sequences, LR and exit, J to 1e-12
    relative."""
    from ocean_torch import system
    from ocean_torch.opt.driver import run_gradient_descent

    res = {}
    for where in ("cpu", "cuda"):
        p = system.build_problem(cfg, u_d=u_d, x0=x0, device=where)
        res[where] = run_gradient_descent(cfg, p, control(p), verbose=False)
    cpu, gpu = res["cpu"], res["cuda"]
    check(gpu.inner_iterations == cpu.inner_iterations and gpu.lr == cpu.lr
          and gpu.exit_reason == cpu.exit_reason,
          f"{name}: card {gpu.inner_iterations}, LR {gpu.lr}, "
          f"{gpu.exit_reason}; CPU {cpu.inner_iterations}, LR {cpu.lr}, "
          f"{cpu.exit_reason}")
    dj = max(abs(a - b) / abs(b) for a, b in zip(gpu.j_array, cpu.j_array))
    check(len(gpu.j_array) == 3 and dj < 1e-12, f"{name}: J rel {dj}")
    check(all(b < a for a, b in zip(cpu.j_array, cpu.j_array[1:])),
          f"{name}: J does not decrease: {cpu.j_array}")
    print(f"{name}: inner_iterations {gpu.inner_iterations} LR {gpu.lr!r} "
          f"J {gpu.j_array!r} card vs CPU rel {dj!r}", flush=True)


def gradient_check(name: str, cfg, control, u_d=None, x0=None) -> None:
    """``opt.grad_check.grad_test`` on the card: the centred
    finite-difference quotient of J along df = (0.1, 0.1) against the
    adjoint's ⟨g, df⟩, per step size. Two checks: the quotient itself has
    converged (two neighbouring step sizes agree to 1e-6 relative), and the
    adjoint's value is within GRAD_FLOOR of it. The reference's adjoint is
    not the discrete gradient (P1-projected ∇u, an O(h‖∇u‖) adjoint-ODE
    consistency error), so the gap stays at its consistency floor however
    small h is; GRAD_FLOOR is what the JAX package's own test holds it to
    (``tests/test_coupled_gradient.py``, escape-free regime)."""
    from ocean_torch import control as ctrl_mod, system
    from ocean_torch.opt.grad_check import grad_test

    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cuda")
    f = control(prob)
    step = system.gd_step(prob, f, cfg.LR)
    check(not bool(step.fwd.mask.any()), f"{name}: a buoy escaped")
    df = system.fd_direction(prob)
    gradj = float(ctrl_mod.boundary_inner(prob.bq, step.grad, df))
    j0 = float(system.cost(prob, step.fwd.u_values, f.quad))
    _, centred = grad_test(prob, f, df, j0, gradj, 0)
    for approx, err, h in centred:
        print(f"{name}: h={h:.0e} centred FD {approx!r} error {err!r} "
              f"relative {err / abs(gradj)!r}", flush=True)
    fd = [approx for approx, _, _ in centred]
    settled = min(abs(a - b) / abs(b) for a, b in zip(fd, fd[1:]))
    check(settled < 1e-6, f"{name}: the centred quotient has not settled: "
          f"two neighbouring step sizes agree to {settled} at best")
    best = min(err for _, err, _ in centred) / abs(gradj)
    check(best < GRAD_FLOOR, f"{name}: smallest centred FD error {best} of "
          f"|<g, df>| = {abs(gradj)}")
    print(f"{name}: <g, df> = {gradj!r}, smallest centred FD error "
          f"{best!r} relative (bound {GRAD_FLOOR}), quotient settled to "
          f"{settled!r}", flush=True)


GRAD_FLOOR = 5e-3

ARTIFACTS = ("variables.txt", "timings.txt", "u_divergence.txt",
             "J_array.npy", "checkpoints/q.npz", "checkpoints/q_history.npz",
             "q_backup/q.npz", "paraview/velocity.npz",
             "paraview/checkpoint/up.npz", "paraview/velocity.xdmf",
             "paraview/pressure.xdmf")


def check_run(name: str, result, prob, cfg, counts: dict, metric: str,
              card: str) -> None:
    """What paths 3 and 4 have in common: the launch counts that the
    driver's records imply, a J that decreases, an LR that does not grow,
    the artifacts, and the iteration metric."""
    import numpy as np
    import torch
    from ocean_torch.io import checkpoint

    n = result.iterations_run
    check(n == cfg.num_steps and result.exit_reason == "num_steps",
          f"{name}: ran {n} iterations, exit {result.exit_reason}")
    # every probe accepted (none floored), so each accepted probe's forward
    # state was reused: forwards = the first one + the probes
    forwards = 1 + sum(result.inner_iterations)
    want = {"primal_ode": forwards, "adjoint_ode": n, "point_sources": n,
            "p1_eval": 0, "segment_sum": 0, "table_ode": 0}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    j = result.j_array
    check(all(np.isfinite(j)) and all(b < a for a, b in zip(j, j[1:])),
          f"{name}: J not strictly decreasing: {j}")
    check(result.lr <= cfg.LR and result.lr == cfg.LR * cfg.tau ** sum(
        i - 1 for i in result.inner_iterations),
        f"{name}: LR {result.lr} does not follow the probes "
        f"{result.inner_iterations}")
    check(result.last_fwd.newton.converged, f"{name}: Newton did not "
          "converge")
    out = Path(cfg.out_dir)
    missing = [a for a in ARTIFACTS if not (out / a).is_file()]
    check(not missing, f"{name}: artifacts missing: {missing}")
    f_ck, lr_ck, it_ck = checkpoint.load_control(
        str(out / "q_backup" / "q.npz"), prob.space, prob.bq)
    check(torch.equal(f_ck.quad, result.f.quad)
          and torch.equal(f_ck.p2, result.f.p2) and lr_ck == result.lr
          and it_ck == n, f"{name}: q_backup/q.npz does not reload")
    f_last, _, it_last = checkpoint.load_control(
        str(out / "checkpoints" / "q.npz"), prob.space, prob.bq)
    check(torch.equal(f_last.quad, result.f.quad) and it_last == n - 1,
          f"{name}: checkpoints/q.npz does not reload")
    check(np.array_equal(np.load(out / "J_array.npy"), np.asarray(j)),
          f"{name}: J_array.npy differs")
    steady = sorted(o + i for o, i in zip(result.outer_times[1:],
                                          result.inner_times[1:]))
    print(f"{name}: J={j!r} inner_iterations={result.inner_iterations} "
          f"LR={result.lr!r} escaped={int(result.last_fwd.mask.sum())} "
          f"newton_iters={result.last_fwd.newton.iterations} "
          f"launches={counts}", flush=True)
    print(f"{name} outer seconds {result.outer_times!r} inner seconds "
          f"{result.inner_times!r}", flush=True)
    print(f"{metric}: median {steady[len(steady) // 2]!r} (outer + inner "
          f"of iterations 1-{n - 1}: {steady!r}) on {card}", flush=True)


def lshape_seeds(ge, dev):
    """10⁴ meshgrid seeds inside the L (resolution 50's grid tables)."""
    import numpy as np
    import torch
    from ocean_torch.mesh.locate import in_domain

    gx, gy = np.meshgrid(np.linspace(0.02, 1.98, 116),
                         np.linspace(0.02, 1.98, 116))
    seeds = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], 1),
                            device=dev)
    seeds = seeds[in_domain(ge.locator, seeds)][:10000].contiguous()
    check(seeds.shape[0] == 10000, f"L-shape seeds: {seeds.shape[0]}")
    return seeds


def lshape_real_size(prob4, w, records: list, card: str) -> None:
    """The five kernels at a real size on the L-shape: 10⁴ meshgrid seeds
    inside the L, nt=200, on path 4's velocity and ∇u fields. Each kernel
    is held to its plain version and timed as in phase 4; the times go
    into the kernels' records under ``lshape_*`` keys."""
    import torch
    from ocean_torch import system
    from ocean_torch.ode.grideval import grad_to_grid, velocity_to_grid

    dev = prob4.device
    ge, nt, h = prob4.grid, prob4.nt, prob4.h
    seeds = lshape_seeds(ge, dev)
    K = seeds.shape[0]
    big = dataclasses.replace(
        prob4, x0=seeds,
        u_d=torch.zeros(K, nt, 2, dtype=torch.float64, device=dev))
    u, _ = big.space.split(w)
    ode = system._primal_ode(big, u)
    # which way the buoys left: through a re-entrant edge means into the
    # missing block x < 1, y > 1
    kf = ode.kfail.to(torch.int64).clamp(max=nt - 1)
    gone = ode.x_raw[torch.arange(K, device=dev), kf][ode.mask]
    corner = int(((gone[:, 0] < 1.0) & (gone[:, 1] > 1.0)).sum())
    print(f"L-shape at resolution 50, {K} seeds: {int(ode.mask.sum())} "
          f"buoys leave, {corner} of them through the re-entrant edges",
          flush=True)
    extra = {}
    label = " on the L-shape"
    err, ms, plain, _ = primal_ode_check(ge, velocity_to_grid(ge, u), seeds,
                                         h, nt, "L-shape", card)
    b, by = primal_bound(ge, K, nt)
    extra["primal_ode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b, bound_by=by)
    grad_u = big.projector.project(big.space, u)
    g_img = grad_to_grid(ge, grad_u)
    x_raw = ode.x_raw.contiguous()
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=dev)
    err, ms, plain = adjoint_ode_check(
        ge, g_img, x_raw, (ode.u_values - big.u_d).contiguous(), vlimit, h,
        "L-shape", card)
    b, by = adjoint_bound(ge, K, nt)
    extra["adjoint_ode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b, bound_by=by)
    fwd = system.ForwardState(w, ode.x, ode.u_values, ode.mask, None,
                              ode.x_raw, ode.kfail)
    got = scatter_inputs(big, fwd)
    extra["point_sources"] = point_sources_record(*got["point_sources"],
                                                  label)
    # the raw positions keep the frozen buoys where they left, outside
    extra["p1_eval"] = p1_eval_record(ge, g_img, x_raw, label)
    extra["segment_sum"] = segment_sum_record(*got["segment_sum"], label)
    for rec in records:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            if key in extra[rec["name"]]:
                rec["lshape_" + key] = extra[rec["name"]][key]
    print("L-shape kernel times (ms, 10⁴ seeds, resolution 50) on "
          f"{card}: " + json.dumps({r["name"]: r["lshape_ms"]
                                    for r in records}), flush=True)


def table_bound(K: int, nt: int):
    """Least time of the table kernel: x0 in; x, u, failed and kfail out,
    against the float64 operations of K·(nt−1) steps. The tables and u
    are left out of the bytes: a buoy reads only the cells it passes."""
    nbytes = 8 * (K * 2 + 2 * K * nt * 2) + 4 * 2 * K
    return bound_ms(nbytes, OPS_TABLE_STEP * K * (nt - 1))


def table_ode_records(cases, card: str) -> list:
    """Kernel 6 (``csrc/table_ode.cu``, the "gather" backend's steps) on
    each case (geometry, problem, velocity u, starts x0): x, u, ``failed``
    and ``kfail`` equal (``torch.equal``) to ``table_ode_steps_plain`` and
    between two launches; kernel and plain times as in phase 4, kernel 1
    on the same field and starts beside it (``primal_ode_ms``), and the
    byte bound. Returns the kernels' records."""
    import torch
    from ocean_torch.ode.cuda_ode import primal_ode_steps
    from ocean_torch.ode.cuda_table_ode import (table_ode_steps,
                                                table_ode_steps_plain)
    from ocean_torch.ode.grideval import velocity_to_grid

    records = []
    for geometry, prob, u, x0 in cases:
        space, nt, h = prob.space, prob.nt, prob.h
        K = x0.shape[0]
        label = f"{geometry}, K={K}"
        got = table_ode_steps(space, u, x0, h, nt)
        again = table_ode_steps(space, u, x0, h, nt)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"table_ode on {label}: two launches differ")
        plain = table_ode_steps_plain(space, u, x0, h, nt)
        for name, a, b in zip(("x", "u", "failed", "kfail"), got, plain):
            check(torch.equal(a, b), f"table_ode on {label}: {name} differs "
                  "from the plain version")
        err = max(float((a - b).abs().max())
                  for a, b in zip(got[:2], plain[:2]))
        ms = cuda_ms(lambda: table_ode_steps(space, u, x0, h, nt), 20)
        plain_ms = cuda_ms(
            lambda: table_ode_steps_plain(space, u, x0, h, nt), 3)
        u_img = velocity_to_grid(prob.grid, u)
        grid_ms = cuda_ms(
            lambda: primal_ode_steps(prob.grid, u_img, x0, h, nt), 20)
        b, by = table_bound(K, nt)
        escaped = int(got[2].sum())
        print(f"table_ode on {label}: equal to the plain version, "
              f"max_abs_err={err!r} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"primal_ode_ms={grid_ms:.4f} bound_ms={b:.4f} "
              f"escaped={escaped} on {card}", flush=True)
        records.append(dict(
            name="table_ode", route="cuda",
            source="ocean_torch/csrc/table_ode.cu",
            replaces="ocean_jax/ode/primal.py (the gather lax.scan)",
            geometry=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=None, primal_ode_ms=grid_ms,
            escaped=escaped))
    return records


def scatter_inputs(prob, fwd) -> dict:
    """What the point-source stage of ``system.gd_step`` hands the two
    scatter kernels' wrappers at the forward state ``fwd``, whatever
    ``prob.psrc_method`` is: ``"point_sources"`` → (grid tables, points,
    γ) of ``cuda_psrc.point_source_image`` and ``"segment_sum"`` → (ids,
    values, scale, S) of ``psum_cuda.ozaki_slice_sums``."""
    from ocean_torch import system
    from ocean_torch.adjoint import point_sources
    from ocean_torch.ops.scatter import pow2_scale

    u, _ = prob.space.split(fwd.w)
    grad_u = prob.projector.project(prob.space, u)
    mu = system._adjoint_mu(prob, grad_u, fwd.x, fwd.u_values, fwd.mask,
                            fwd.x_raw, fwd.kfail)
    x, active = system._source_points(prob, fwd.x, fwd.mask, fwd.x_raw,
                                      fwd.kfail)
    common = (prob.space, u, x, mu, prob.u_d, active, prob.h, prob.center)
    gamma = point_sources.fused_gamma(*common, fwd.u_values)
    cell, vals = point_sources.point_source_terms(*common)
    vals = vals.reshape(-1, 12)
    return {"point_sources": (prob.grid, x, gamma),
            "segment_sum": (cell, vals, pow2_scale(vals),
                            prob.space.num_cells)}


def scatter_times(label: str, got: dict, card: str) -> None:
    """Times of the two scatter kernels on a path's inputs (``got`` from
    ``scatter_inputs``), each first held to its plain version."""
    import torch
    from ocean_torch.adjoint.cuda_psrc import (point_source_limbs,
                                               point_source_limbs_plain)
    from ocean_torch.ops.psum_cuda import (ozaki_slice_sums,
                                           ozaki_slice_sums_plain)
    from ocean_torch.ops.scatter import pow2_scale

    ge, x, gamma = got["point_sources"]
    pts = x.reshape(-1, 2).contiguous()
    gamma = gamma.reshape(-1, 2)
    r = (gamma / pow2_scale(gamma)).contiguous()
    hk, lk = point_source_limbs(ge, pts, r)
    hp, lp = point_source_limbs_plain(ge, pts, r)
    check(torch.equal(hk, hp) and torch.equal(lk, lp),
          f"point_sources on {label}: limbs differ from the plain version")
    ms = cuda_ms(lambda: point_source_limbs(ge, pts, r), 20)
    print(f"point_sources on {label} inputs: ms={ms:.4f} "
          f"active={int((r != 0).any(dim=1).sum())} of {pts.shape[0]} "
          f"on {card}", flush=True)
    del hp, lp
    ids, vals, scale, S = got["segment_sum"]
    check(torch.equal(ozaki_slice_sums(ids, vals, scale, S),
                      ozaki_slice_sums_plain(ids, vals, scale, S)),
          f"segment_sum on {label}: differs from the plain version")
    ms = cuda_ms(lambda: ozaki_slice_sums(ids, vals, scale, S), 20)
    print(f"segment_sum on {label} inputs: ms={ms:.4f} M={vals.shape[0]} "
          f"on {card}", flush=True)


def small_reference(name: str, cfg, control, lr) -> None:
    """One GD step at a small size through the kernels on the card against
    the plain versions on the CPU: J within 1e-10 and f_new within 1e-8
    relative, the same buoys escaped. ``control(prob)`` is the control."""
    import numpy as np
    import torch
    from ocean_torch import system
    from ocean_torch.pipelines.ud_construction import seed_positions

    # u_d from a seed: a generated one would share the cache key
    # "100_buoys" with other resolutions
    rng = np.random.default_rng(7)
    ud_s = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    ud_s[..., 1] -= 0.1
    x0_s = seed_positions(100)
    res = {}
    for where in ("cpu", "cuda"):
        p = system.build_problem(cfg, u_d=ud_s, x0=x0_s, device=where)
        res[where] = system.gd_step(p, control(p), lr)
    cpu, gpu = res["cpu"], res["cuda"]
    check(torch.equal(gpu.fwd.mask.cpu(), cpu.fwd.mask),
          f"{name}: escaped buoys differ between card and CPU")
    dj = abs(float(gpu.J) - float(cpu.J)) / abs(float(cpu.J))
    dq = float((gpu.f_new.quad.cpu() - cpu.f_new.quad).abs().max()
               / cpu.f_new.quad.abs().max())
    check(dj < 1e-10 and dq < 1e-8, f"{name}: J rel {dj}, f_new rel {dq}")
    print(f"{name} (Nx=8, K=100): J rel {dj!r} f_new rel {dq!r} "
          f"escaped={int(cpu.fwd.mask.sum())}", flush=True)


def run_path(name: str, prob, f, lr, kernels_on: tuple, metric: str,
             card: str):
    """Counts set to 0, one GD step, counts read: each kernel of
    ``kernels_on`` launched, no other. Then the median host seconds of 3
    repeats at the fixed control. Returns (result, counts)."""
    import torch
    from ocean_torch import kernels, system

    kernels.reset_launch_counts()
    res = system.gd_step(prob, f, lr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(all(counts[n] >= 1 for n in kernels_on)
          and all(counts[n] == 0 for n in counts if n not in kernels_on),
          f"{name}: launches {counts}, expected exactly {kernels_on}")
    j = float(res.J)
    check(j == j and abs(j) != float("inf"), f"{name}: non-finite J {j}")
    check(not res.diverged, f"{name}: GD step diverged")
    check(res.fwd.newton.converged, f"{name}: Newton did not converge")
    check(res.f_new.quad.shape == f.quad.shape
          and bool(torch.isfinite(res.f_new.quad).all()),
          f"{name}: bad control update")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        r_ = system.gd_step(prob, f, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dj = abs(float(r_.J) - j) / abs(j)
        check(dj < 1e-12, f"{name}: GD step at a fixed control drifts: {dj}")
    times.sort()
    print(f"{name}: J={j!r} newton_iters={res.fwd.newton.iterations} "
          f"escaped={int(res.fwd.mask.sum())} launches={counts}", flush=True)
    print(f"{metric}: median {times[1]!r} (repeats {times!r}) on {card}",
          flush=True)
    return res, counts


# the JAX package on the CPU (float64, reference paths) at the
# reference's sizes: stokes_gradcheck.run(nx=32, alpha=1e-2) and the J0
# of ns_gradcheck.run(nx=32, K=5)
STOKES_JAX = dict(gradj=-0.03131649410221973, J0=0.9676643376409284,
                  div_l2=9.149866023292053e-4)
NS_J0_JAX = 0.31099233774692514
# the NS+ODE harness's adjoint is implicit and P1-projected: its gap to
# the settled centred quotient is a consistency floor, printed and held
# only loosely
NS_GAP_BOUND = 5e-2


def ns_gradcheck_small_reference() -> None:
    """The NS+ODE harness at nx=8, K=3 on the card against the CPU: J0 and
    gradj to 1e-12 relative."""
    from ocean_torch.pipelines import ns_gradcheck
    res = {where: ns_gradcheck.run(nx=8, K=3, ks=range(3, 5),
                                   verbose=lambda s: None, device=where)
           for where in ("cpu", "cuda")}
    d = {k: abs(res["cuda"][k] / res["cpu"][k] - 1) for k in ("J0", "gradj")}
    check(max(d.values()) < 1e-12, f"ns_gradcheck small reference: {d}")
    print(f"ns_gradcheck small reference (nx=8, K=3): card vs CPU rel {d}",
          flush=True)


def differentiable_ns_check(prob) -> None:
    """The VJP of ``make_differentiable_ns_solver`` on ``prob``: for a
    seeded c, ⟨VJP(c), df⟩ against the centred difference of ⟨c, w(f)⟩
    over three step sizes (1e-7 relative at the best)."""
    import numpy as np
    import torch
    from ocean_torch import system

    f = system.initial_control(prob, case=4)
    df = system.fd_direction(prob)
    c = torch.as_tensor(np.random.default_rng(5).standard_normal(
        prob.space.ndof), device=prob.device)
    fq = f.quad.clone().requires_grad_(True)
    w = system.make_differentiable_ns_solver(prob)(fq)
    (g,) = torch.autograd.grad(w, fq, c)
    directional = float(torch.sum(g * df.quad))

    def cw(q):
        return float(torch.dot(c, system.solve_ns(prob, q).w))

    errs = []
    for h in (1e-3, 1e-4, 1e-5):
        fd = (cw(f.quad + h * df.quad) - cw(f.quad - h * df.quad)) / (2 * h)
        errs.append(abs(fd - directional) / abs(directional))
        print(f"differentiable NS solve (Nx=32): h={h:.0e} centred "
              f"<c, w> quotient {fd!r} against <VJP(c), df> "
              f"{directional!r}: relative {errs[-1]!r}", flush=True)
    check(min(errs) < 1e-7, f"differentiable NS solve: VJP against the "
          f"centred difference {errs}")


def path7_verification(prob, card: str) -> None:
    """Path 7: the Stokes and NS+ODE gradient checks and the
    differentiable NS solve on the card. Launches no kernel."""
    import torch
    from ocean_torch import kernels
    from ocean_torch.pipelines import ns_gradcheck, stokes_gradcheck

    dev = prob.device
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lines = []
    res = stokes_gradcheck.run(nx=32, alpha=1e-2, out=lines.append,
                               device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for line in lines:
        print(f"stokes_gradcheck: {line}")
    rel = {k: abs(res[k] / v - 1) for k, v in STOKES_JAX.items()}
    print(f"stokes_gradcheck (nx=32): {secs:.2f} s with set-up on {card}; "
          f"relative to the JAX package's CPU numbers {rel}", flush=True)
    check(max(rel.values()) < 1e-10, f"stokes_gradcheck: {rel}")
    cen = {h: err for _, err, h in res["centered"]}
    check(cen[1e-3] < 1e-11, f"stokes_gradcheck: centred error "
          f"{cen[1e-3]} at h=1e-3")
    sp = stokes_gradcheck.build(nx=32, alpha=1e-2, device=dev)
    f = stokes_gradcheck.default_control(sp)
    fq = f.quad.clone().requires_grad_(True)
    j = stokes_gradcheck.cost(sp, stokes_gradcheck.solve_state(sp, fq), fq)
    (g,) = torch.autograd.grad(j, fq)
    d_auto = abs(float(torch.sum(g * f.quad)) / res["gradj"] - 1)
    check(d_auto < 1e-9, f"stokes_gradcheck: autograd against gradj "
          f"{d_auto}")
    print(f"stokes_gradcheck: autograd through solve_state against gradj "
          f"{d_auto!r}", flush=True)

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rn = ns_gradcheck.run(nx=32, K=5, out_dir=tmp,
                              verbose=lambda s: None, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        written = sorted(p.name for p in Path(tmp).iterdir())
    check(written == ["grad_J_error_0.txt", "grad_J_error_centered_0.txt"],
          f"ns_gradcheck: wrote {written}")
    for approx, err, h in rn["centered"]:
        print(f"ns_gradcheck: gradj {rn['gradj']!r} h={h:.0e} centred "
              f"{approx!r} error {err!r}")
    dj0 = abs(rn["J0"] / NS_J0_JAX - 1)
    fd = [a for a, _, _ in rn["centered"]]
    settled = min(abs(a - b) / abs(b) for a, b in zip(fd, fd[1:]))
    gap = min(err for _, err, _ in rn["centered"]) / abs(rn["gradj"])
    print(f"ns_gradcheck (nx=32, K=5): {secs:.2f} s with set-up on {card}; "
          f"J0 {rn['J0']!r} (JAX package {NS_J0_JAX}, relative {dj0!r}), "
          f"quotient settled to {settled!r}, gap to gradj {gap!r} "
          f"(the implicit adjoint's consistency floor)", flush=True)
    check(dj0 < 1e-10, f"ns_gradcheck: J0 relative {dj0}")
    check(settled < 1e-6, f"ns_gradcheck: quotient not settled: {settled}")
    check(gap < NS_GAP_BOUND, f"ns_gradcheck: gap to gradj {gap}")
    ns_gradcheck_small_reference()
    differentiable_ns_check(dataclasses.replace(prob, newton_reuse_lu=False))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"path 7 launches: {counts}", flush=True)
    check(not any(counts.values()), f"path 7 launched kernels: {counts}")


PATH8_ARTIFACTS = tuple(a for a in ARTIFACTS
                        if not a.startswith("checkpoints/"))


def path8_initial_control(u_d, x0, card: str) -> dict:
    """Path 8: the initial-control study at K=10⁴ from a temporary
    ``reference_runs_dir``. Returns the fused run's launch counts."""
    import tempfile
    import numpy as np
    import torch
    from ocean_torch import kernels, system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines import initial_control

    with tempfile.TemporaryDirectory() as tmp:
        runs = Path(tmp) / "reference_runs"
        (runs / "10000_buoys").mkdir(parents=True)
        np.save(runs / "10000_buoys" / "u_d_array.npy", u_d)
        np.save(runs / "10000_buoys" / "x_0_array.npy", x0[:, None, :])
        cfg = OCPConfig(ud_experiment="10000_buoys",
                        unit_square_resolution=32, use_line_search=True,
                        LR=5.0, num_steps=3, newton_reuse_lu=True,
                        psrc_method="fused", ode_backend="pallas",
                        reference_runs_dir=str(runs),
                        out_dir=str(Path(tmp) / "ic") + "/")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ens, prob = initial_control.run_all_cases_fused(cfg, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        js, lrs = ens.j_history, ens.lr_history
        print(f"path 8 (run_all_cases_fused, K=10⁴, Armijo): J "
              f"{js.T.tolist()!r} LR {lrs.T.tolist()!r} escaped "
              f"{ens.escaped_history.T.tolist()} stopped_at "
              f"{ens.stopped_at.tolist()} launches={counts}", flush=True)
        check(prob.K == 10000 and prob.ode_backend == "pallas"
              and prob.psrc_method == "fused" and prob.newton_reuse_lu,
              "path 8: not path 3's configuration")
        check(ens.stopped_at.tolist() == [3] * 4, "path 8: a member stopped")
        # probes of a step: LR halves after each refused probe
        prev = torch.full((1, 4), cfg.LR, dtype=torch.float64)
        ratio = torch.cat([prev, lrs[:-1]]) / lrs
        probes = 1 + torch.round(torch.log2(ratio)).to(torch.int64)
        check(torch.equal(ratio, 2.0 ** (probes - 1).to(torch.float64)),
              f"path 8: LR history {lrs.tolist()} is not a halving")
        forwards = int((1 + probes).sum())
        want = {"primal_ode": forwards, "adjoint_ode": 12,
                "point_sources": 12, "p1_eval": 0, "segment_sum": 0,
                "table_ode": 0}
        check(counts == want, f"path 8: launches {counts}, expected {want}")
        check(bool(torch.isfinite(js).all())
              and len(set(tuple(r) for r in js.T.tolist())) == 4,
              "path 8: J histories not four distinct finite ones")
        f, lr, seq = system.initial_control(prob, case=0), cfg.LR, []
        for _ in range(3):
            r = system.gd_step(prob, f, lr, use_line_search=True,
                               max_ls_iters=cfg.max_line_search_iters)
            f, lr = r.f_new, r.lr
            seq.append((float(r.J), r.lr, r.fwd.newton.iterations))
        dj = max(abs(a / s[0] - 1) for a, s in zip(js[:, 0].tolist(), seq))
        check(dj < 1e-12 and lrs[:, 0].tolist() == [s[1] for s in seq],
              f"path 8: member 0 against sequential gd_step: J rel {dj}, "
              f"LR {lrs[:, 0].tolist()} vs {[s[1] for s in seq]}")
        print(f"path 8 member 0 against three sequential gd_step calls: J "
              f"relative {dj!r}, LR equal; chord Newton iterations at the "
              f"three controls {[s[2] for s in seq]}", flush=True)
        print(f"path8_fused_seconds_per_member_iteration: "
              f"{secs / 12!r} ({secs:.2f} s for 4 members × 3 iterations "
              f"with set-up, {forwards} forward solves) on {card}",
              flush=True)

        t0 = time.perf_counter()
        res, _, _ = initial_control.run(
            dataclasses.replace(cfg, num_steps=2), case=2, verbose=False,
            device="cuda")
        torch.cuda.synchronize()
        out = Path(cfg.out_dir)
        missing = [a for a in PATH8_ARTIFACTS if not (out / a).is_file()]
        check(not missing, f"path 8 run(case=2): artifacts missing "
              f"{missing}")
        check(res.iterations_run == 2 and np.isfinite(res.j_array).all(),
              f"path 8 run(case=2): {res.iterations_run} iterations, J "
              f"{res.j_array}")
        iters = [o + i for o, i in zip(res.outer_times, res.inner_times)]
        print(f"path 8 initial_control.run(case=2): J {res.j_array!r} "
              f"inner_iterations {res.inner_iterations} in "
              f"{time.perf_counter() - t0:.2f} s with set-up and artifacts; "
              f"driver iteration seconds (outer + inner) {iters!r} on "
              f"{card}", flush=True)
    return counts


# the JAX package's hi-res study on its TPU (results/hires_mg/summary.json,
# 400 buoys, Armijo, LR 1, initial_control(case=4)): the first recorded J
# at Nx=64 and Nx=192. The record's J moved between passes of the study
# (results/hires_mg/run.log), so they are printed beside the port's, not
# held to it.
HIRES_J0 = {64: 1.157232246063213, 192: 1.158434906717261}
# the same study run to its convergence exit at Nx=64 (run "nx64_conv"):
# J of every iteration, probes (iteration 0 halves LR 1 to 0.0625), Newton
# iterations a solve and adjoint rounds an iteration
HIRES_NX64_CONV_J = (
    1.15723224606322, 0.23830559751911007, 0.1292118054513729,
    0.09911840596586985, 0.08007911959641678, 0.06587505811654726,
    0.055029012414485906, 0.04669576005580689, 0.04026560340171237,
    0.035281604532182986, 0.03139930436272653, 0.028358035742632515,
    0.025960084667992267, 0.024055144856016675, 0.02252873535050215,
    0.02129351141592606, 0.02028273155075544, 0.01944532780357841)
HIRES_NX64_CONV_PROBES = (5,) + (1,) * 17
HIRES_NX64_CONV_NEWTON = 4
HIRES_NX64_CONV_ROUNDS = 3
HIRES_RTOL = 1e-8


def square_sizes(n: int):
    """(mixed dofs, velocity dofs, P1 dofs) of the [0,2]² square at Nx=n."""
    n_p2, n_p1 = (2 * n + 1) ** 2, (n + 1) ** 2
    return 2 * n_p2 + n_p1, 2 * n_p2, n_p1


def mg_levels(ctx) -> list:
    """The multigrid contexts from the finest down."""
    out = [ctx]
    while out[-1].sub is not None:
        out.append(out[-1].sub)
    return out


def mg_driver_run(name: str, cfg, prob, f0, card: str,
                  rejected_may_stall: bool = False, forwards=None,
                  to_exit: bool = False):
    """Counts set to 0, ``cfg.num_steps`` driver iterations (with
    ``to_exit``, up to the driver's exit: the caller checks it), counts
    read;
    every NS and adjoint solve of the run converged (the problem's solve
    log; with ``rejected_may_stall`` the NS solves of rejected line-search
    probes may stall, and their count is printed); per iteration J,
    probes, each Newton solve's iterations and FGMRES cycles a step, the
    rungs' Newton iterations, the adjoint's rounds and final relative
    residual, and the seconds. ``forwards``, a list where given, receives
    each iteration's forward state. Returns (result, counts)."""
    import torch
    from ocean_torch import kernels
    from ocean_torch.opt.driver import run_gradient_descent

    marks = []

    def on_iteration(i, f, fwd, z, j):
        marks.append(len(prob.solve_log))
        if forwards is not None:
            forwards.append(fwd)

    kernels.reset_launch_counts()
    res = run_gradient_descent(cfg, prob, f0, on_iteration=on_iteration,
                               verbose=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    start = 0
    for i, end in enumerate(marks):
        recs, start = prob.solve_log[start:end], end
        ns = [r for r in recs if r["solve"] == "ns_newton"]
        rungs = [r["iterations"] for r in recs if r["solve"] == "ns_rung"]
        adj = [r for r in recs if r["solve"] == "adjoint"]
        used, rejected = used_forwards(recs)
        stalled = sum(not r["converged"] for g in rejected for r in g)
        check(len(adj) == 1 and adj[0]["converged"]
              and all(r["converged"] for g in used for r in g)
              and (rejected_may_stall or not stalled),
              f"{name}: iteration {i}: a solve did not converge: {recs}")
        print(f"{name} iteration {i}: J={res.j_array[i]!r} probes="
              f"{res.inner_iterations[i]} newton_iterations="
              f"{[r['iterations'] for r in ns]} fgmres_cycles_per_newton_step="
              f"{[r['krylov_cycles'] for r in ns]} rung_newton_iterations="
              f"{rungs} adjoint_rounds="
              f"{adj[0]['rounds']} adjoint_fgmres_cycles="
              f"{adj[0]['krylov_cycles']} adjoint_relative_residual="
              f"{adj[0]['relative_residual']!r} stalled_rejected_probe_solves="
              f"{stalled} seconds="
              f"{res.outer_times[i] + res.inner_times[i]!r} on {card}",
              flush=True)
    n = res.iterations_run
    check(to_exit or n == cfg.num_steps, f"{name}: ran {n} iterations, "
          f"exit {res.exit_reason}")
    j = res.j_array
    check(all(v == v and abs(v) != float("inf") for v in j)
          and all(b < a for a, b in zip(j, j[1:])),
          f"{name}: J not finite and decreasing: {j}")
    # each accepted probe's forward state is the next iteration's
    want = {"primal_ode": 1 + sum(res.inner_iterations), "adjoint_ode": n,
            "point_sources": n, "p1_eval": 0, "segment_sum": 0, "table_ode": 0}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    print(f"{name}: launches={counts} escaped="
          f"{int(res.last_fwd.mask.sum())} LR={res.lr!r}", flush=True)
    return res, counts


def image_in_device_memory(ge, geometry: str) -> None:
    """Path 9's meshes: the primal ODE's velocity image is too large for
    shared memory and is read from device memory."""
    from ocean_torch.ode import cuda_ode

    Hy, Hx = ge.hg_shape
    check(cuda_ode.shared_bytes(ge) < 16 * Hy * Hx,
          f"{geometry}: the velocity image would fit in shared memory")
    print(f"{geometry}: primal ODE image {16 * Hy * Hx} B in device memory "
          f"(dynamic shared memory {cuda_ode.shared_bytes(ge)} B a block)",
          flush=True)


def state_kernels(prob, fwd, counts: dict, geometry: str, card: str):
    """Kernels 1–3 on the inputs of a path's forward state ``fwd``, each
    held to its plain version and timed as in phase 4. Returns their
    records, ``launches`` from the path's ``counts``."""
    import torch
    from ocean_torch.ode.grideval import grad_to_grid, velocity_to_grid

    ge, K, nt, h = prob.grid, prob.K, prob.nt, prob.h
    u, _ = prob.space.split(fwd.w)
    err, ms, plain, _ = primal_ode_check(ge, velocity_to_grid(ge, u),
                                         prob.x0, h, nt, geometry, card)
    records = [ode_record("primal_ode", geometry, err, ms, plain,
                          primal_bound(ge, K, nt))]
    g_img = grad_to_grid(ge, prob.projector.project(prob.space, u))
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=prob.device)
    err, ms, plain = adjoint_ode_check(
        ge, g_img, fwd.x, (fwd.u_values - prob.u_d).contiguous(), vlimit, h,
        geometry, card)
    records.append(ode_record("adjoint_ode", geometry, err, ms, plain,
                              adjoint_bound(ge, K, nt)))
    records.append(point_sources_record(
        *scatter_inputs(prob, fwd)["point_sources"], f" on {geometry}"))
    for rec in records:
        rec["geometry"] = geometry
        rec["launches"] = counts[rec["name"]]
    return records


def stencil_times(prob, label: str, card: str) -> None:
    """The stencil matvec of the fine mixed operator (not a TPU kernel:
    plain PyTorch, one gather and one batched contraction) at the Stokes
    state, float32 and float64, each against ``Operator.matvec64`` and
    timed with CUDA events beside its byte bound (coefficients read once,
    x read and y written once) and beside a CSR sparse product of the
    same matrix."""
    import torch
    from ocean_torch.fem import assemble
    from ocean_torch.ops import stencil

    st, n = prob.mg.st_mixed, prob.space.ndof
    op = assemble.ns_operator(
        prob.space, prob.bq, torch.zeros(n, dtype=torch.float64,
                                         device=prob.device),
        prob.nu, prob.bc_dofs)
    x = torch.randn(n, dtype=torch.float64, device=prob.device,
                    generator=torch.Generator(prob.device).manual_seed(9))
    ref = op.matvec64(x)
    # the same matrix in CSR: element entries off the Dirichlet rows,
    # identity rows on them, duplicates summed by coalesce
    k = op.cell_dofs.shape[1]
    parts = [(op.cell_dofs, op.cell_mats)]
    if op.facet_mats is not None:
        parts.append((op.facet_dofs, op.facet_mats))
    rows = torch.cat([d[:, :, None].expand(-1, k, k).reshape(-1)
                      for d, _ in parts])
    cols = torch.cat([d[:, None, :].expand(-1, k, k).reshape(-1)
                      for d, _ in parts])
    vals = torch.cat([m.reshape(-1) for _, m in parts])
    free = torch.ones(n, dtype=torch.bool, device=prob.device)
    free[op.bc_dofs] = False
    keep = free[rows]
    rows = torch.cat([rows[keep], op.bc_dofs])
    cols = torch.cat([cols[keep], op.bc_dofs])
    vals = torch.cat([vals[keep], torch.ones_like(op.bc_dofs,
                                                  dtype=vals.dtype)])
    csr = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (n, n)).coalesce().to_sparse_csr()
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        s = stencil.build_coefficients(st, op, dtype)
        xd = x.to(dtype)
        y = stencil.stencil_matvec(st, s, op.bc_dofs, xd)
        err = float((y.double() - ref).abs().max() / ref.abs().max())
        check(err < tol, f"stencil matvec {label} {dtype}: {err}")
        ms = cuda_ms(lambda: stencil.stencil_matvec(st, s, op.bc_dofs, xd),
                     20)
        nbytes = s.numel() * s.element_size() + 2 * n * xd.element_size()
        a = csr.to(dtype)
        err_csr = float(((a @ xd).double() - ref).abs().max()
                        / ref.abs().max())
        check(err_csr < tol, f"CSR product {dtype}: {err_csr}")
        lib = cuda_ms(lambda: a @ xd, 20)
        print(f"stencil matvec {label} {str(dtype)[6:]}: rel_err={err!r} "
              f"ms={ms:.4f} bound_ms={nbytes / PEAK_BYTES_PER_S * 1e3:.4f} "
              f"(bytes {nbytes}, {st.n_off} offsets) csr_ms={lib:.4f} "
              f"(nnz {a.values().numel()}) on {card}", flush=True)


def path9d_to_exit(cfg, prob, f0, card: str):
    """Path 9d: the Nx=64 study run to its convergence exit through
    ``run_gradient_descent``, held to its record: every J within
    HIRES_RTOL relative, the probes, 4 Newton iterations a solve (of
    the forwards the run went on with), 3 adjoint rounds, the exit at
    iteration 17. Returns the result."""
    import dataclasses as dc
    import numpy as np

    n = len(HIRES_NX64_CONV_J)
    prob = dc.replace(prob, solve_log=[])
    res, _ = mg_driver_run("path 9d (Nx=64 to the exit)",
                           dc.replace(cfg, num_steps=30, conv_crit=1e-3),
                           prob, f0, card, to_exit=True)
    j = np.asarray(res.j_array[:n])
    gaps = np.abs(j - HIRES_NX64_CONV_J[:len(j)]) / np.abs(
        HIRES_NX64_CONV_J[:len(j)])
    probes = tuple(res.inner_iterations)
    differ = [i for i, (a, b) in enumerate(zip(probes,
                                               HIRES_NX64_CONV_PROBES))
              if a != b]
    used, _ = used_forwards(prob.solve_log)
    newton = [g[-1]["iterations"] for g in used]
    rounds = [r["rounds"] for r in prob.solve_log if r["solve"] == "adjoint"]
    steady = [o + i for o, i in zip(res.outer_times[1:], res.inner_times[1:])]
    print(f"path 9d: {len(res.j_array)} iterations, exit "
          f"{res.exit_reason!r}, largest relative gap of J to the record "
          f"{float(gaps.max())!r} (iteration {int(gaps.argmax())}), probes "
          f"{list(probes)} (first Armijo decision off the record: "
          f"{differ[0] if differ else None}), Newton iterations of the "
          f"forwards the run went on with "
          f"{sorted(set(newton))}, adjoint rounds {sorted(set(rounds))}, "
          f"iteration seconds 1-{len(steady)}: median "
          f"{sorted(steady)[len(steady) // 2]!r} max {max(steady)!r} on "
          f"{card}", flush=True)
    check(len(res.j_array) == n and res.exit_reason == "converged",
          f"path 9d: {len(res.j_array)} iterations, exit "
          f"{res.exit_reason}; the record stopped converged after {n}")
    check(float(gaps.max()) < HIRES_RTOL,
          f"path 9d: J off the record by {float(gaps.max())}")
    check(not differ, f"path 9d: probes {probes}, the record "
          f"{HIRES_NX64_CONV_PROBES}")
    check(set(newton) == {HIRES_NX64_CONV_NEWTON}
          and set(rounds) == {HIRES_NX64_CONV_ROUNDS},
          f"path 9d: Newton iterations {newton}, adjoint rounds {rounds}")
    return res


def path9_hires(card: str) -> list:
    """Path 9: the JAX package's hi-res multigrid study through the
    port's entry points. Returns the kernels' records of its inputs."""
    import dataclasses as dc
    import statistics
    import torch
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.limits import ensure_ud

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    u_d, x0 = ensure_ud(OCPConfig(ud_experiment="400_buoys",
                                  unit_square_resolution=32),
                        cache_dir=str(ROOT / "data" / "ud_torch"), device=dev)
    check(u_d.shape == (400, 200, 2), f"path 9: u_d {u_d.shape}")
    print(f"path 9 u_d (400 meshgrid buoys, synthesized at Nx=32): "
          f"{time.perf_counter() - t0:.2f} s on {card}", flush=True)
    small_reference("small reference, path 9 (linear_solver=\"mg\")",
                    OCPConfig(ud_experiment="100_buoys",
                              unit_square_resolution=8,
                              use_line_search=False, num_steps=1,
                              ode_backend="pallas", psrc_method="fused",
                              linear_solver="mg"),
                    lambda p: system.initial_control(p, 4), 1.0)

    # --- 9a. Nx=64: "auto" picks two levels; three driver iterations ------
    nx = 64
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=nx,
                    use_line_search=True, LR=1.0, num_steps=3,
                    psrc_method="fused", ode_backend="pallas")
    t0 = time.perf_counter()
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ndof, _, n_p1 = square_sizes(nx)
    levels = mg_levels(prob.mg)
    check(prob.linear_solver == "mg" and prob.space.ndof == ndof
          and len(levels) == 1
          and prob.mg.space_c.ndof == square_sizes(nx // 2)[0]
          and tuple(prob.mg.ainv_c.shape) == (square_sizes(nx // 2)[1],) * 2
          and prob.mg.matvec == "stencil" and prob.projector.mode == "lu",
          f"path 9a: not two levels with the stencil matvec: "
          f"{prob.linear_solver}, {prob.space.ndof} dofs, {len(levels)}")
    print(f"path 9a: auto chose {prob.linear_solver!r}, 2 levels, "
          f"{prob.space.ndof} mixed dofs, coarse {prob.mg.space_c.ndof}, "
          f"leaf {prob.mg.ainv_c.shape[0]} velocity dofs, matvec "
          f"{prob.mg.matvec!r}, projector {prob.projector.mode!r}; set-up "
          f"{build_s:.2f} s by part {json.dumps(prob.setup_seconds)} on "
          f"{card}", flush=True)
    prob = dc.replace(prob, solve_log=[])
    f0 = system.initial_control(prob, case=4)
    res, counts64 = mg_driver_run("path 9a (Nx=64)", cfg, prob, f0, card)
    steady = [o + i for o, i in zip(res.outer_times[1:],
                                    res.inner_times[1:])]
    print(f"hires_nx64_gd_iteration_seconds: median "
          f"{statistics.median(steady)!r} (outer + inner of iterations "
          f"1-2: {steady!r}; set-up {build_s:.2f} s) on {card}", flush=True)
    print(f"path 9a: J0 {res.j_array[0]!r} beside the TPU record "
          f"{HIRES_J0[nx]} (information only)", flush=True)
    image_in_device_memory(prob.grid, f"rectangle, Nx={nx}, mg")
    records = state_kernels(prob, res.last_fwd, counts64,
                            f"rectangle, Nx={nx}, mg", card)
    print_stages("path 9a (Nx=64, mg)", prob, res.f, res.lr)
    stencil_times(prob, f"Nx={nx}", card)
    path9d_to_exit(cfg, prob, f0, card)

    # --- 9b. the dense LU against multigrid at Nx=64 ----------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob_d = system.build_problem(dc.replace(cfg, linear_solver="dense"),
                                  u_d=u_d, x0=x0, device=dev)
    torch.cuda.synchronize()
    print(f"path 9b: forced dense problem ({prob_d.space.ndof}² float64, "
          f"Stokes LU) in {time.perf_counter() - t0:.2f} s on {card}",
          flush=True)
    steps = {}
    for name, p in (("dense", prob_d), ("mg", prob)):
        t0 = time.perf_counter()
        steps[name] = system.gd_step(p, f0, cfg.LR)
        torch.cuda.synchronize()
        print(f"path 9b {name} gd_step (no line search): "
              f"{time.perf_counter() - t0:.2f} s, newton_iters="
              f"{steps[name].fwd.newton.iterations} on {card}", flush=True)
    a, b = steps["dense"], steps["mg"]
    dj = abs(float(a.J) - float(b.J)) / abs(float(a.J))
    dq = float((a.f_new.quad - b.f_new.quad).abs().max()
               / a.f_new.quad.abs().max())
    check(not a.diverged and not b.diverged and dj <= 1e-9 and dq <= 1e-9,
          f"path 9b: dense against mg: J rel {dj}, f_new rel {dq}")
    print(f"path 9b: dense against mg at Nx={nx}: J rel {dj!r}, f_new "
          f"{dq!r} of max|f_new|; peak device memory of 9b "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {card}",
          flush=True)
    del prob_d, steps, a, b
    torch.cuda.empty_cache()

    # --- 9c. Nx=192: three levels, the CG projection, one iteration -------
    nx = 192
    cfg = dc.replace(cfg, unit_square_resolution=nx, num_steps=1)
    t0 = time.perf_counter()
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ndof, _, n_p1 = square_sizes(nx)
    levels = mg_levels(prob.mg)
    check(prob.linear_solver == "mg" and prob.space.ndof == ndof
          and len(levels) == 2 and levels[0].ainv_c is None
          and prob.mg.space_c.ndof == square_sizes(nx // 2)[0]
          and tuple(levels[1].ainv_c.shape) == (square_sizes(nx // 4)[1],) * 2
          and all(c.matvec == "stencil" for c in levels)
          and prob.space.n_p1 == n_p1 and prob.projector.mode == "cg",
          f"path 9c: not three levels with the stencil matvec and the CG "
          f"projection: {prob.linear_solver}, {len(levels)}, "
          f"{prob.projector.mode}")
    print(f"path 9c: {prob.space.ndof} mixed dofs, levels {nx} → {nx // 2} "
          f"→ {nx // 4} (leaf {levels[1].ainv_c.shape[0]} velocity dofs), "
          f"{n_p1} P1 dofs → projector {prob.projector.mode!r}; set-up "
          f"{build_s:.2f} s by part {json.dumps(prob.setup_seconds)} on "
          f"{card}", flush=True)
    prob = dc.replace(prob, solve_log=[])
    f0 = system.initial_control(prob, case=4)
    res, counts192 = mg_driver_run("path 9c (Nx=192)", cfg, prob, f0, card)
    j_f0 = float(system.cost(prob, res.last_fwd.u_values, f0.quad))
    j_acc = float(system.cost(prob, system.forward(prob, res.f.quad)
                              .u_values, res.f.quad))
    check(res.lr > cfg.LR_MIN and j_acc < j_f0,
          f"path 9c: Armijo step not accepted: J {j_acc} at LR {res.lr}, "
          f"{j_f0} at the start")
    print(f"path 9c: Armijo accepted LR {res.lr!r} after "
          f"{res.inner_iterations[0]} probes, J {j_f0!r} → {j_acc!r}; "
          f"hires_nx192_gd_iteration_seconds "
          f"{res.outer_times[0] + res.inner_times[0]!r} (set-up "
          f"{build_s:.2f} s) on {card}", flush=True)
    print(f"path 9c: J0 {res.j_array[0]!r} beside the TPU record "
          f"{HIRES_J0[nx]} (information only)", flush=True)
    image_in_device_memory(prob.grid, f"rectangle, Nx={nx}, mg")
    records += state_kernels(prob, res.last_fwd, counts192,
                             f"rectangle, Nx={nx}, mg", card)
    print_stages("path 9c (Nx=192, mg)", prob, res.f, res.lr)
    stencil_times(prob, f"Nx={nx}", card)
    return records


# the JAX package's TPU records at ν = 0.01: results/golden_nu001/
# J_array.npy (Nx=32, dense, 10 buoys, 6 rungs, --fast) and
# results/hires_mg/summary.json, "nx64_nu0.01" (Nx=64, mg, 400 buoys)
GOLDEN_J = (2.334394094080693, 1.673866821199553, 1.4736841877039706)
HIRES_NU001_J = (54.2790339299728, 50.5543340684992, 42.097201303658494)
HIRES_NU001_NEWTON0 = 24


@contextlib.contextmanager
def solve_logs():
    """Problems built inside keep a solve log (one record per rung, NS and
    adjoint solve), also where a pipeline builds its own."""
    from ocean_torch import system

    build = system.build_problem
    system.build_problem = lambda *a, **k: dataclasses.replace(
        build(*a, **k), solve_log=[])
    try:
        yield
    finally:
        system.build_problem = build


def used_forwards(log):
    """Split a driver run's solve log into its forwards (each a run of
    "ns_rung" records and its "ns_newton" record): (the forwards whose
    state the run went on with, the rejected line-search probes). The run
    goes on with the last forward before each adjoint solve and with the
    last forward of the log (the final accepted probe)."""
    groups, cur, used_ids = [], [], set()
    for r in log:
        if r["solve"] == "adjoint":
            used_ids.add(len(groups) - 1)
            continue
        cur.append(r)
        if r["solve"] == "ns_newton":
            groups.append(cur)
            cur = []
    used_ids.add(len(groups) - 1)
    return ([g for i, g in enumerate(groups) if i in used_ids],
            [g for i, g in enumerate(groups) if i not in used_ids])


def rung_summary(log) -> str:
    return ", ".join(f"ν={r['nu']:.4g}: {r['iterations']}"
                     + ("" if r["converged"] else " STALLED")
                     for r in log if r["solve"] == "ns_rung")


def path10a_golden(tmp: str, card: str):
    """10a: the reference's golden configuration (10 buoys at x=0.1, ν =
    0.01, Nx=32) through ``pipelines.ocp.run`` with 6 rungs and the --fast
    bundle. Returns (kernel records, launches)."""
    import torch
    from ocean_torch import kernels, system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines import ocp
    from ocean_torch.pipelines.limits import ensure_ud

    dev = torch.device("cuda")
    cache = str(ROOT / "data" / "ud_torch")
    # u_d at ν = 1 (the recipe that reproduces the 400-buoy record), never
    # at ν = 0.01 into the shared cache
    u_d, _ = ensure_ud(OCPConfig(ud_experiment="10_buoys",
                                 unit_square_resolution=32), cache_dir=cache,
                       device=dev)
    check(u_d.shape == (10, 200, 2), f"path 10a: u_d {u_d.shape}")
    cfg = OCPConfig(ud_experiment="10_buoys", unit_square_resolution=32,
                    viscosity=0.01, newton_continuation=6,
                    use_line_search=True, num_steps=3, newton_reuse_lu=True,
                    psrc_method="fused", ode_backend="pallas",
                    dense_apply="inverse", reference_runs_dir=cache,
                    out_dir=str(Path(tmp) / "golden"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with solve_logs():
        res, prob = ocp.run(cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"path 10a (ocp.run, golden ν=0.01, Nx=32, 10 buoys, 6 rungs, "
          f"--fast): {res.iterations_run} iterations in "
          f"{time.perf_counter() - t0:.2f} s with set-up and artifacts",
          flush=True)
    check(prob.linear_solver == "dense" and prob.newton_continuation == 6
          and prob.projector.mode == "inverse" and prob.K == 10,
          "path 10a: not the golden configuration")
    used, rejected = used_forwards(prob.solve_log)
    check(len(used) == cfg.num_steps + 1
          and all(r["converged"] for g in used for r in g),
          f"path 10a: a rung or a Newton solve of a forward the run went on "
          f"with did not converge: {used}")
    stalled = sum(not g[-1]["converged"] for g in rejected)
    print(f"path 10a: first forward's rungs (Newton iterations) "
          f"{rung_summary(used[0])}; final solve {used[0][-1]['iterations']};"
          f" every rung and solve of the {len(used)} forwards the run went "
          f"on with converged; {stalled} of {len(rejected)} rejected "
          f"line-search probes stalled", flush=True)
    check_run("path 10a", res, prob, cfg, counts,
              "golden_nu001_gd_iteration_seconds", card)
    dj = abs(res.j_array[0] - GOLDEN_J[0]) / GOLDEN_J[0]
    print(f"path 10a: J0 {res.j_array[0]!r} beside the TPU record "
          f"{GOLDEN_J[0]} (relative gap {dj!r}; not held: the record's "
          f"u_d is the reference's); J {res.j_array!r} beside "
          f"{list(GOLDEN_J)}", flush=True)
    # the failure the ladder exists for, at the same control: the
    # reference's Newton from w = 0, a float64 LU a step
    vanilla = dataclasses.replace(prob, newton_continuation=0,
                                  newton_reuse_lu=False, fac0=None,
                                  solve_log=[])
    f0 = system.initial_control(vanilla, case=0)
    r0 = system.solve_ns(vanilla, f0.quad)
    check(not r0.converged and r0.residual_norm > 1.0,
          f"path 10a: vanilla Newton converged={r0.converged}, residual "
          f"{r0.residual_norm}")
    print(f"path 10a: vanilla Newton (no rungs) at the initial control: "
          f"converged={r0.converged} residual {r0.residual_norm!r} after "
          f"{r0.iterations} iterations", flush=True)
    # kernels 1–3 on the strong flow of the initial control, where buoys
    # escape
    fwd0 = system.forward(prob, f0.quad)
    escaped = int(fwd0.mask.sum())
    check(escaped >= 1, "path 10a: no buoy escapes at the initial control")
    print(f"path 10a: {escaped} of 10 buoys escape at the initial control",
          flush=True)
    records = state_kernels(prob, fwd0, counts, "rectangle, Nx=32, ν=0.01, "
                            "10 buoys", card)
    return records, counts


def path10b_hires(card: str) -> list:
    """10b: the hi-res study at ν = 0.01 (Nx=64, mg, 400 buoys, Armijo, 6
    rungs), two driver iterations; then one forward with a forced dense
    ladder at the initial control against mg. Returns the driver's J. The search starts at 2⁻⁷,
    the LR it accepts from the study's LR 1 after 8 probes (502 s of
    mostly stalled rungs on an NVIDIA H100 at 700 W), so J and the states
    are those of LR 1."""
    import torch
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.limits import ensure_ud

    dev = torch.device("cuda")
    u_d, x0 = ensure_ud(OCPConfig(ud_experiment="400_buoys",
                                  unit_square_resolution=32),
                        cache_dir=str(ROOT / "data" / "ud_torch"), device=dev)
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=64,
                    viscosity=0.01, newton_continuation=6,
                    use_line_search=True, LR=2.0 ** -7, num_steps=2,
                    psrc_method="fused", ode_backend="pallas")
    t0 = time.perf_counter()
    prob = dataclasses.replace(
        system.build_problem(cfg, u_d=u_d, x0=x0, device=dev), solve_log=[])
    torch.cuda.synchronize()
    check(prob.linear_solver == "mg" and prob.newton_continuation == 6,
          "path 10b: not the mg ladder")
    print(f"path 10b: Nx=64 ν=0.01 mg problem in "
          f"{time.perf_counter() - t0:.2f} s on {card}", flush=True)
    f0 = system.initial_control(prob, case=4)
    fwds = []
    res, _ = mg_driver_run("path 10b (Nx=64, ν=0.01)", cfg, prob, f0, card,
                           rejected_may_stall=True, forwards=fwds)
    first = prob.solve_log[:next(
        i for i, r in enumerate(prob.solve_log)
        if r["solve"] == "ns_newton") + 1]
    print(f"path 10b: iteration 0's first forward: rungs {rung_summary(first)}"
          f"; final Newton {first[-1]['iterations']} beside the record's "
          f"{HIRES_NU001_NEWTON0}, FGMRES cycles {first[-1]['krylov_cycles']}",
          flush=True)
    secs = [o + i for o, i in zip(res.outer_times, res.inner_times)]
    print(f"hires_nx64_nu001_gd_iteration_seconds: {secs[-1]!r} (iteration "
          f"1; iteration 0 {secs[0]!r} with {res.inner_iterations[0]} "
          f"probes) on {card}", flush=True)
    dj0 = abs(res.j_array[0] - HIRES_NU001_J[0]) / HIRES_NU001_J[0]
    print(f"path 10b: J {res.j_array!r} beside the TPU record "
          f"{list(HIRES_NU001_J[:2])}; J0 relative gap {dj0!r}", flush=True)
    check(dj0 < 1e-6, f"path 10b: J0 {res.j_array[0]} off the TPU record")
    j_10b = list(res.j_array)
    # the forced dense ladder at the initial control, without the mg
    # problem and the Stokes LU (the ladder factorizes J(w) each step)
    j_mg = float(system.cost(prob, fwds[0].u_values, f0.quad))
    del prob, fwds, res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob_d = dataclasses.replace(system.build_problem(
        dataclasses.replace(cfg, linear_solver="dense"), u_d=u_d, x0=x0,
        device=dev), solve_log=[], fac0=None)
    fwd_d = system.forward(prob_d, f0.quad)
    torch.cuda.synchronize()
    j_d = float(system.cost(prob_d, fwd_d.u_values, f0.quad))
    check(all(r["converged"] for r in prob_d.solve_log),
          f"path 10b: the dense ladder did not converge: {prob_d.solve_log}")
    dj = abs(j_d - j_mg) / abs(j_d)
    check(dj <= 1e-9, f"path 10b: dense against mg J0 rel {dj}")
    print(f"path 10b: forced dense ladder (37,507² float64 LU a step) at the "
          f"initial control: rungs {rung_summary(prob_d.solve_log)}, "
          f"{time.perf_counter() - t0:.2f} s; J0 {j_d!r} against mg "
          f"{j_mg!r}, rel {dj!r}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {card}",
          flush=True)
    del prob_d, fwd_d
    torch.cuda.empty_cache()
    return j_10b


def path10c_float32(cfg, u_d, x0, f, lr, res1, card: str) -> dict:
    """10c: path 1's configuration and control with the float32 knobs:
    ``dense_apply="inverse"``, ``newton_chord_f32`` on float32 LU
    factors, and both; one GD step each against path 1's (``res1``): J
    within 1e-9 relative, f_new within 1e-8·max|f_new| (the JAX package's
    bounds); then the median of 3 steps and the stages. Returns each
    variant's J by tag ("inverse" is ``bench.py::_build``'s step)."""
    import torch
    from ocean_torch import system

    dev = torch.device("cuda")
    scale = float(res1.f_new.quad.abs().max())
    js = {}
    for name, tag, kw in (
            ("dense_apply=inverse", "inverse", dict(dense_apply="inverse")),
            ("newton_chord_f32", "chord_f32", dict(newton_chord_f32=True)),
            ("both", "inverse_chord_f32", dict(dense_apply="inverse",
                                               newton_chord_f32=True))):
        prob = system.build_problem(dataclasses.replace(cfg, **kw), u_d=u_d,
                                    x0=x0, device=dev)
        res, _ = run_path(f"path 10c ({name})", prob, f, lr, PATH1,
                          f"gd_iteration_seconds_10000_buoys_{tag}", card)
        js[tag] = float(res.J)
        dj = abs(float(res.J) - float(res1.J)) / abs(float(res1.J))
        dq = float((res.f_new.quad - res1.f_new.quad).abs().max()) / scale
        check(dj < 1e-9 and dq < 1e-8,
              f"path 10c ({name}): J rel {dj}, f_new {dq} of max|f_new|")
        print(f"path 10c ({name}): J rel {dj!r} f_new {dq!r} of max|f_new| "
              f"against path 1, newton_iters {res.fwd.newton.iterations} "
              f"(path 1: {res1.fwd.newton.iterations}), Stokes factors "
              f"{type(prob.fac0).__name__} "
              f"{str(getattr(prob.fac0, 'lu', getattr(prob.fac0, 'ainv', None)).dtype)[6:]}",
              flush=True)
        print_stages(f"path 10c ({name})", prob, f, lr)
        del prob
    return js


# --- path 11: the sharded steps and gen-1 ------------------------------------
#
# Path 11 spawns its ranks (``ocean_torch.parallel.launch.spawn``); the rank
# functions below run in those processes. A failed check there exits the
# rank non-zero, which fails the launch and so the run.

PATH11_TIMEOUT_S = 300.0       # a rank that waits longer in a collective fails


def path1_config():
    """The main path's configuration (phase 3)."""
    from ocean_torch.config import OCPConfig
    return OCPConfig(ud_experiment="10000_buoys", unit_square_resolution=32,
                     use_line_search=False, num_steps=1,
                     psrc_method="fused", ode_backend="pallas",
                     newton_reuse_lu=True)


def hires_config():
    """Path 9a's configuration (Nx=64, 400 buoys, mg: what "auto" picks
    there), one step without the line search."""
    from ocean_torch.config import OCPConfig
    return OCPConfig(ud_experiment="400_buoys", unit_square_resolution=64,
                     use_line_search=False, LR=1.0, num_steps=1,
                     psrc_method="fused", ode_backend="pallas",
                     linear_solver="mg")


def build_on(cfg, device, ud_cfg=None):
    """The problem of ``cfg`` on ``device`` from the u_d cache (the main
    process synthesized it)."""
    from ocean_torch import system
    from ocean_torch.pipelines.limits import ensure_ud
    u_d, x0 = ensure_ud(ud_cfg or cfg,
                        cache_dir=str(ROOT / "data" / "ud_torch"),
                        device=device)
    return system.build_problem(cfg, u_d=u_d, x0=x0, device=device)


def rank_lanes(K: int, group) -> slice:
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return slice(r * (K // n), (r + 1) * (K // n))


def shard_kernels(prob_p, f, group, label: str) -> dict:
    """This rank's lanes of the padded problem ``prob_p`` at control ``f``:
    the kernels the sharded step launched, each on the inputs it handed
    them (the shard's x0, trajectories, residuals and point sources),
    equal (``torch.equal``) to its plain version. Returns the maximum
    errors by kernel (0 where equal)."""
    import dataclasses as dc
    import torch
    from ocean_torch import system
    from ocean_torch.adjoint.cuda_psrc import (point_source_limbs,
                                               point_source_limbs_plain)
    from ocean_torch.ode.cuda_adjoint import (adjoint_ode_steps,
                                              adjoint_ode_steps_plain)
    from ocean_torch.ode.cuda_ode import (primal_ode_steps,
                                          primal_ode_steps_plain)
    from ocean_torch.ode.grideval import velocity_to_grid, grad_to_grid
    from ocean_torch.ops.psum_cuda import (ozaki_slice_sums,
                                           ozaki_slice_sums_plain)
    from ocean_torch.ops.scatter import pow2_scale
    from ocean_torch.parallel.sharding import make_buoy_ode_impl

    fwd = system.forward(prob_p, f.quad,
                          ode_impl=make_buoy_ode_impl(group))
    ln = rank_lanes(prob_p.K, group)
    w = prob_p.buoy_weights[ln]
    prob = dc.replace(prob_p, u_d=prob_p.u_d[ln], x0=prob_p.x0[ln],
                      buoy_weights=w)
    mask = fwd.mask[ln]
    if prob.adjoint_mode != "consistent":      # as _adjoint_rhs_body drops
        mask = mask | (w == 0)
    fwd = system.ForwardState(fwd.w, fwd.x[ln], fwd.u_values[ln], mask,
                              fwd.newton, fwd.x_raw[ln], fwd.kfail[ln])
    ge, h, nt = prob.grid, prob.h, prob.nt
    u, _ = prob.space.split(fwd.w)
    errs = {}
    u_img = velocity_to_grid(ge, u)
    got = primal_ode_steps(ge, u_img, prob.x0, h, nt)
    plain = primal_ode_steps_plain(ge, u_img, prob.x0, h, nt)
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          f"{label}: primal_ode differs from the plain version on the shard")
    errs["primal_ode"] = max(float((a - b).abs().max())
                             for a, b in zip(got[:2], plain[:2]))
    g_img = grad_to_grid(ge, prob.projector.project(prob.space, u))
    resid = (fwd.u_values - prob.u_d).contiguous()
    if prob.adjoint_mode == "consistent":
        x_in = fwd.x_raw.contiguous()
        vlim = torch.where(fwd.mask, fwd.kfail.to(torch.int64) - 1, nt)
    else:
        x_in = fwd.x
        vlim = torch.full((prob.K,), nt, device=x_in.device)
    vlim = vlim.to(torch.int32)
    mu = adjoint_ode_steps(ge, g_img, x_in, resid, vlim, h)
    check(torch.equal(mu, adjoint_ode_steps_plain(ge, g_img, x_in, resid,
                                                  vlim, h)),
          f"{label}: adjoint_ode differs from the plain version on the shard")
    errs["adjoint_ode"] = 0.0
    got = scatter_inputs(prob, fwd)
    if prob.psrc_method == "fused":
        _, x, gamma = got["point_sources"]
        pts = x.reshape(-1, 2).contiguous()
        r = (gamma.reshape(-1, 2) / pow2_scale(gamma.reshape(-1, 2)))
        r = r.contiguous()
        check(all(torch.equal(a, b) for a, b in zip(
            point_source_limbs(ge, pts, r),
            point_source_limbs_plain(ge, pts, r))),
            f"{label}: point_sources differs from the plain version")
        errs["point_sources"] = 0.0
    else:
        ids, vals, scale, S = got["segment_sum"]
        check(torch.equal(ozaki_slice_sums(ids, vals, scale, S),
                          ozaki_slice_sums_plain(ids, vals, scale, S)),
              f"{label}: segment_sum differs from the plain version")
        errs["segment_sum"] = 0.0
    torch.cuda.synchronize()
    return errs


def ranks_agree(vals, group, label: str) -> None:
    """Every rank of ``group`` holds the bits of its first rank: that
    rank's values broadcast, the count of differing words summed with one
    ``all_reduce``."""
    import torch
    import torch.distributed as dist
    group = dist.group.WORLD if group is None else group
    v = torch.cat([torch.as_tensor(t, dtype=torch.float64).reshape(-1)
                   .to("cuda") for t in vals])
    v0 = v.clone()
    dist.broadcast(v0, src=dist.get_global_rank(group, 0), group=group)
    diff = (v.view(torch.int64) != v0.view(torch.int64)).sum()
    diff = diff.to(torch.float64).reshape(1)
    dist.all_reduce(diff, group=group)
    check(float(diff) == 0.0, f"{label}: {int(diff)} words differ from the "
          "first rank's")


def sharded_run(step, f, lr, label: str, repeats: int = 0,
                beside=None) -> dict:
    """Counts set to 0, one sharded step, counts read; then ``repeats``
    timed steps at the same control (each must give the same J), each
    after a timed call of ``beside`` where one is given (the
    single-device step in the same process). Returns the step's outputs,
    the counts and the seconds."""
    import torch
    from ocean_torch import kernels
    kernels.reset_launch_counts()
    out = step(f.quad, f.p2, lr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    f_quad, f_p2, lr_new, j, count, diverged = out
    times, times_beside = [], []
    for _ in range(repeats):
        if beside is not None:
            t0 = time.perf_counter()
            beside()
            torch.cuda.synchronize()
            times_beside.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        again = step(f.quad, f.p2, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(float(again[3]) == float(j), f"{label}: J moved between "
              "steps at one control")
    return {"f_quad": f_quad.cpu(), "f_p2": f_p2.cpu(), "lr": float(lr_new),
            "J": float(j), "mask_count": float(count),
            "diverged": bool(diverged), "launches": counts,
            "seconds": times, "seconds_beside": times_beside,
            "outputs": out}


def path11_1d(prob, f, lr, group, label: str, kernels_on: tuple,
              beside=None) -> dict:
    """11a/11b: the buoy-sharded step of ``prob`` on ``group``, counted,
    timed (median of 3, each beside ``beside`` where given), its kernels
    on this rank's shard held to their plain versions, the ranks'
    agreement; then the step with Armijo."""
    import torch.distributed as dist
    from ocean_torch.parallel import make_sharded_step, pad_problem
    n = dist.get_world_size(group)
    step = make_sharded_step(prob, group)
    res = sharded_run(step, f, lr, label, repeats=3, beside=beside)
    c = res["launches"]
    check(all(c[k] >= 1 for k in kernels_on)
          and all(c[k] == 0 for k in c if k not in kernels_on),
          f"{label}: launches {c}, expected exactly {kernels_on}")
    res["kernel_err"] = shard_kernels(pad_problem(prob, n), f, group, label)
    out = res.pop("outputs")
    ranks_agree([out[3], out[2], out[0], out[1], out[4]], group, label)
    step_ls = make_sharded_step(prob, group, use_line_search=True,
                                max_ls_iters=80)
    ls = sharded_run(step_ls, f, lr, label + ", Armijo")
    out = ls.pop("outputs")
    ranks_agree([out[3], out[2], out[0], out[1]], group, label + ", Armijo")
    res["armijo"] = ls
    res["K_pad"] = pad_problem(prob, n).K
    return res


def path11_2d(groups, label: str) -> dict:
    """11c: the dof×buoy-sharded mg step at path 9a's configuration,
    counted and timed once after the counted step."""
    import torch
    from ocean_torch import system
    from ocean_torch.parallel import make_sharded_step_2d
    from ocean_torch.config import OCPConfig
    cfg = hires_config()
    prob = build_on(cfg, torch.device("cuda", torch.cuda.current_device()),
                    OCPConfig(ud_experiment="400_buoys",
                              unit_square_resolution=32))
    check(prob.linear_solver == "mg", f"{label}: not the mg path")
    f = system.initial_control(prob, case=4)
    res = sharded_run(make_sharded_step_2d(prob, groups), f, cfg.LR, label,
                      repeats=1)
    out = res.pop("outputs")
    ranks_agree([out[3], out[0], out[1], out[4]], groups.dof, label)
    ranks_agree([out[3], out[0], out[1], out[4]], groups.buoy, label)
    return res, prob, f


def control_on(quad, p2, device):
    """A control handed to a rank (its two tensors, on the host)."""
    from ocean_torch import control as ctrl_mod
    return ctrl_mod.Control(quad.to(device), p2.to(device))


def path11_nccl_rank(rank, world, device, cfg, f_parts, lr, f2_parts):
    """11a, 12a and 11c on one nccl rank: the step on the world group
    (path 1, each timed step beside path 1's single-device ``gd_step`` in
    this process, then Armijo), ``gd_multi_step`` with the hooks beside
    the single-device one, the 2-D step on a 1 × 1 layout, and path 9a's
    single-device mg step as the 2-D reference."""
    from ocean_torch import system
    from ocean_torch.parallel import make_2d_groups
    groups = make_2d_groups(1, 1)
    prob = build_on(cfg, device)
    f = control_on(*f_parts, device)
    out = {"1d": path11_1d(prob, f, lr, None, "11a (nccl, 1 rank)", PATH1,
                           beside=lambda: system.gd_step(prob, f, lr))}
    out["multi"] = path12_multi(prob, f, lr, "12a (nccl, 1 rank)")
    del prob
    res, prob9, f9 = path11_2d(groups, "11c (nccl, 1 × 1)")
    ref = system.gd_step(prob9, f9, 1.0)
    out["2d"] = res
    out["2d_ref"] = {"J": float(ref.J), "f_quad": ref.f_new.quad.cpu(),
                     "mask_count": float(ref.fwd.mask.sum()),
                     "diverged": bool(ref.diverged)}
    return out


def path11_gloo_rank(rank, world, device, cfg, f_parts, lr, f2_parts):
    """11b and 11c on three gloo ranks sharing the card: path 1's step on
    all three (10⁴ lanes → 10,002), path 2's on ranks 0–1, the 2-D step
    on a 2 × 1 layout of ranks 0–1."""
    import torch.distributed as dist
    import dataclasses as dc
    from ocean_torch.parallel import make_2d_groups
    pair = dist.new_group([0, 1])
    groups = make_2d_groups(2, 1)
    prob = build_on(cfg, device)
    f = control_on(*f_parts, device)
    out = {"1d": path11_1d(prob, f, lr, None, f"11b (gloo, rank {rank} "
                           "of 3)", PATH1)}
    del prob
    if rank >= 2:
        return out
    prob2 = build_on(dc.replace(cfg, psrc_method="ozaki_pallas",
                                adjoint_mode="consistent"), device)
    f2 = control_on(*f2_parts, device)
    out["path2"] = path11_1d(prob2, f2, lr, pair,
                             f"11b path 2 (gloo, rank {rank} of 2)", PATH2)
    del prob2
    out["2d"], _, _ = path11_2d(groups, f"11c (gloo, rank {rank} of 2 × 1)")
    return out


def compare_step(label: str, got: dict, ref, rel_j: float, tol_f: float):
    """A sharded step's outputs against a single-device ``gd_step``: J
    within ``rel_j`` relative, f_new within ``tol_f``·max|f_new| (path 1's
    new control is large, see the printed max|f_new|: 1e-12 absolute
    would be below float64's spacing there)."""
    j_ref = float(ref.J)
    dj = abs(got["J"] - j_ref) / abs(j_ref)
    df = max(float((got[k] - r.cpu()).abs().max() / r.abs().max())
             for k, r in (("f_quad", ref.f_new.quad), ("f_p2", ref.f_new.p2)))
    check(not got["diverged"] and not ref.diverged, f"{label}: diverged")
    check(dj <= rel_j and df <= tol_f, f"{label}: J rel {dj}, f_new {df}")
    check(got["lr"] == ref.lr, f"{label}: LR {got['lr']} vs {ref.lr}")
    check(got["mask_count"] == float(ref.fwd.mask.sum()),
          f"{label}: escaped {got['mask_count']} vs "
          f"{int(ref.fwd.mask.sum())}")
    return dj, df


def path11_sharded(cfg, prob, f, lr, res1, f2, res2, card: str) -> tuple:
    """Path 11a–c: launch the ranks with path 1's configuration, control
    and LR and path 2's control, hold their steps to the single-device
    ones. Returns the launch counts of the counted sharded steps and what
    12a measured in the nccl rank."""
    import statistics
    import torch
    from ocean_torch import system
    from ocean_torch.parallel import launch

    res_ls = system.gd_step(prob, f, lr, use_line_search=True,
                            max_ls_iters=80)
    big = [float(r.f_new.quad.abs().max()) for r in (res1, res_ls, res2)]
    print(f"path 11 references: max|f_new| {big[0]!r} (path 1), "
          f"{big[1]!r} (Armijo), {big[2]!r} (path 2)", flush=True)
    torch.cuda.empty_cache()
    runs = {}
    for name, fn, world, backend in (
            ("nccl1", path11_nccl_rank, 1, "nccl"),
            ("gloo3", path11_gloo_rank, 3, "gloo")):
        t0 = time.perf_counter()
        runs[name] = launch.spawn(
            fn, world, backend, "cuda", timeout_s=PATH11_TIMEOUT_S,
            args=(cfg, (f.quad.cpu(), f.p2.cpu()), lr,
                  (f2.quad.cpu(), f2.p2.cpu())))
        print(f"path 11 launch {name}: {time.perf_counter() - t0:.2f} s "
              "with process start-up and set-up", flush=True)
    for name, ranks in runs.items():
        for r, out in enumerate(ranks):
            one = out["1d"]
            label = f"11 {name} rank {r}"
            dj, df = compare_step(label, one, res1, 1e-12, 1e-12)
            ls = one["armijo"]
            dj_ls, df_ls = compare_step(label + " Armijo", ls, res_ls,
                                        1e-12, 1e-12)
            probes = ls["launches"]["primal_ode"] - 1
            check(probes == res_ls.inner_iterations, f"{label}: {probes} "
                  f"probes, gd_step {res_ls.inner_iterations}")
            print(f"path {label}: J={one['J']!r} rel {dj!r} f_new rel {df!r} "
                  f"K_pad={one['K_pad']} launches={one['launches']} shard "
                  f"kernels equal to plain {one['kernel_err']}; Armijo LR "
                  f"{ls['lr']!r} probes {probes} (gd_step {res_ls.lr!r}, "
                  f"{res_ls.inner_iterations}) J rel {dj_ls!r} f_new "
                  f"{df_ls!r}", flush=True)
        t = ranks[0]["1d"]["seconds"]
        print(f"sharded_gd_iteration_seconds_10000_buoys_{name}: median "
              f"{statistics.median(t)!r} (repeats {t!r}) on {card}",
              flush=True)
        tb = ranks[0]["1d"]["seconds_beside"]
        if tb:
            print(f"path 1 gd_step in the same rank, each before a sharded "
                  f"step: median {statistics.median(tb)!r} (repeats "
                  f"{tb!r}) on {card}", flush=True)
    check(runs["gloo3"][0]["1d"]["K_pad"] == 10002, "11b: not 10,002 lanes")
    counts = dict(runs["nccl1"][0]["1d"]["launches"])
    for r in (0, 1):
        p2 = runs["gloo3"][r]["path2"]
        dj, df = compare_step(f"11b path 2 rank {r}", p2, res2, 1e-12, 1e-12)
        print(f"path 11b path 2 (gloo, rank {r} of 2): J={p2['J']!r} rel "
              f"{dj!r} f_new rel {df!r} escaped {p2['mask_count']} (path 2: "
              f"{int(res2.fwd.mask.sum())}) launches={p2['launches']} shard "
              f"kernels equal to plain {p2['kernel_err']}", flush=True)
    counts["segment_sum"] = runs["gloo3"][0]["path2"]["launches"][
        "segment_sum"]
    ref = runs["nccl1"][0]["2d_ref"]
    for name, out in (("gloo2", runs["gloo3"][0]["2d"]),
                      ("nccl1", runs["nccl1"][0]["2d"])):
        dj = abs(out["J"] - ref["J"]) / abs(ref["J"])
        df = float((out["f_quad"] - ref["f_quad"]).abs().max()
                   / ref["f_quad"].abs().max())
        check(not out["diverged"] and not ref["diverged"]
              and dj <= 1e-9 and df <= 1e-9
              and out["mask_count"] == ref["mask_count"],
              f"11c {name}: J rel {dj}, f_new {df}, escaped "
              f"{out['mask_count']} vs {ref['mask_count']}")
        print(f"path 11c ({name}): J={out['J']!r} rel {dj!r} f_new rel {df!r} "
              f"escaped {out['mask_count']} launches={out['launches']}",
              flush=True)
        print(f"sharded2d_hires_nx64_gd_iteration_seconds_{name}: "
              f"{out['seconds'][0]!r} on {card}", flush=True)
    print("path 11: gloo stages CUDA collectives through the host, and its "
          "ranks share one card: its times say what sharing one card costs, "
          "not what a user of several cards pays", flush=True)
    return counts, runs["nccl1"][0]["multi"]


def gen1_pipe_solver(**device):
    """The gen-1 Stokes problem on path 6's graded pipe with its obstacle:
    (space, NavierStokesSolver, control q). ``device`` goes to
    ``make_space``, ``make_boundary_quad`` and ``NavierStokesSolver``;
    without it each takes its default."""
    import numpy as np
    from ocean_torch import control as ctrl_mod
    from ocean_torch.fem import (make_space, make_boundary_quad,
                                 dirichlet_velocity_bc)
    from ocean_torch.gen1 import NavierStokesSolver
    from ocean_torch.mesh import mark_boundary_facets, structured

    eps = 1e-12
    mesh, _ = structured.pipe_mesh(obstacle=True, graded=True)
    space = make_space(mesh, **device)
    bq = make_boundary_quad(mesh, mark_boundary_facets(
        mesh, lambda x: np.abs(x[:, 0]) < eps), tag=1, **device)
    check(space.device.type == bq.points.device.type == "cuda",
          f"gen-1 pipe: space on {space.device}, boundary quadrature on "
          f"{bq.points.device}")
    bc = dirichlet_velocity_bc(mesh, space, lambda x: x[:, 0] > eps)
    ns = NavierStokesSolver(space, bq, *bc, alpha=1e-2, **device)
    q = ctrl_mod.from_expression(space, bq, lambda x: np.stack(
        [x[:, 1] * (2 - x[:, 1]) / 4, np.zeros(len(x))], axis=1))
    return space, ns, q


def path11_gen1(card: str):
    """11d: the gen-1 driver at the reference's size on the card (J
    descends, the centred FD table closes below 0.2 of gradj, the JAX
    test's level), then the gen-1 Stokes solve on path 6's graded pipe.
    Returns that solve's state."""
    import numpy as np
    import torch
    from ocean_torch.fem import assemble
    from ocean_torch.gen1 import main as gen1_main

    t0 = time.perf_counter()
    out = gen1_main.run(nx=32, K=5, num_steps=3, grad_check=True,
                        verbose=False, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    j = out["J"]
    best = min(err for _, err, _ in out["grad_check"]) / abs(out["gradj"])
    check(len(j) == 3 and all(np.isfinite(j))
          and all(b < a for a, b in zip(j, j[1:])),
          f"11d: gen-1 J does not descend: {j}")
    check(best < 0.2, f"11d: gen-1 FD check closes at {best} of gradj")
    print(f"path 11d gen-1 (nx=32, K=5, 3 steps, centred FD at 6 steps): "
          f"J={j!r} gradj={out['gradj']!r} best FD relative error "
          f"{best!r}", flush=True)
    print(f"gen1_run_seconds_nx32: {secs!r} (3 iterations and the 12 FD "
          f"forward solves) on {card}", flush=True)
    space, ns, q = gen1_pipe_solver(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w = ns.solve_stokes_step(q)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    u, p = space.split(w)
    check(bool(torch.isfinite(w).all()) and float(u.abs().max()) > 1e-6,
          "11d: the graded pipe's Stokes field is not finite and driven")
    print(f"path 11d gen-1 Stokes on the graded pipe with its obstacle "
          f"({space.ndof} dofs, dense LU): max|u| {float(u.abs().max())!r} "
          f"‖div u‖ {float(assemble.divergence_l2(space, u))!r} in "
          f"{secs:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB on {card}", flush=True)
    return w


# --- path 12: the surface and the loaders ----------------------------------
#
# 12a runs in path 11's nccl rank (``path11_nccl_rank``); 12b–d in the main
# process after path 11.

PATH12_STEPS = 2


def path12_multi(prob, f, lr, label: str) -> dict:
    """12a in a rank: ``PATH12_STEPS`` Armijo iterations of
    ``system.gd_multi_step`` with its three hooks on the world group (the
    buoy-sharded primal ODE and adjoint right-hand side, the cell-sharded
    matvec, which the dense solves of path 1 do not call), counts set to 0
    before and read after, beside as many iterations of the single-device
    ``gd_multi_step`` in this rank: the trajectories (J, LR, probes, escape
    counts, ‖div u‖) and the final control and LR equal bit for bit."""
    import torch
    import torch.distributed as dist
    from ocean_torch import kernels, system
    from ocean_torch.parallel import pad_problem
    from ocean_torch.parallel.dof_sharding import make_matvec_of
    from ocean_torch.parallel.sharding import (make_buoy_adjoint_rhs_impl,
                                               make_buoy_ode_impl)
    prob_p = pad_problem(prob, dist.get_world_size())
    hooks = dict(ode_impl=make_buoy_ode_impl(),
                 adjoint_rhs_impl=make_buoy_adjoint_rhs_impl(),
                 matvec_of=make_matvec_of())

    def timed(p, **kw):
        t0 = time.perf_counter()
        out = system.gd_multi_step(p, f, lr, PATH12_STEPS,
                                   use_line_search=True, max_ls_iters=80,
                                   **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (f_ref, lr_ref, ref), secs_ref = timed(prob)
    kernels.reset_launch_counts()
    (f_got, lr_got, got), secs = timed(prob_p, **hooks)
    counts = kernels.launch_counts()
    # a second pair in the other order: the host's spread, not the hooks
    (_, _, again), secs_again = timed(prob_p, **hooks)
    (_, _, ref_again), secs_ref_again = timed(prob)
    check(torch.equal(again.J, got.J) and torch.equal(ref_again.J, ref.J),
          f"{label}: J moved between calls at one control")
    forwards = PATH12_STEPS + int(got.inner_iterations.sum())
    check(counts["primal_ode"] == forwards
          and counts["adjoint_ode"] == counts["point_sources"] == PATH12_STEPS
          and all(counts[k] == 0 for k in counts if k not in PATH1),
          f"{label}: launches {counts}, expected {forwards} primal ODE and "
          f"{PATH12_STEPS} adjoint ODE and point-source launches")
    check(not bool(got.diverged.any()) and not bool(ref.diverged.any()),
          f"{label}: diverged")
    same = [k for k in ref._fields
            if not torch.equal(getattr(got, k), getattr(ref, k))]
    check(not same and lr_got == lr_ref
          and torch.equal(f_got.quad, f_ref.quad)
          and torch.equal(f_got.p2, f_ref.p2),
          f"{label}: gd_multi_step with the hooks differs from the "
          f"single-device one in {same or 'the final control or LR'}")
    return {"J": got.J.tolist(), "lr": got.lr.tolist(),
            "probes": got.inner_iterations.tolist(),
            "mask_count": got.mask_count.tolist(), "K_pad": prob_p.K,
            "launches": counts, "seconds": [secs, secs_again],
            "seconds_single": [secs_ref, secs_ref_again]}


def path12_surface(prob, f, lr, multi: dict, w11, card: str) -> None:
    """12a's results from path 11's nccl rank; 12b: the f_new of path 1's
    Armijo step through ``io.torch_ckpt`` and back with the loader's
    default device, and a GD step from it equal to one from the control in
    memory (path 1's own f_new, at LR 5, lies outside the Newton solve's
    basin: the next step's J is inf); 12c: the space
    builders and the gen-1 solver without a device, the Stokes solve equal
    to 11d's; 12d: ``import ocean_torch`` in a fresh interpreter."""
    import os
    import tempfile
    import torch
    from ocean_torch import system
    from ocean_torch.io import torch_ckpt

    print(f"path 12a (nccl, 1 rank): gd_multi_step with the three hooks, "
          f"{PATH12_STEPS} Armijo iterations on {multi['K_pad']} lanes, "
          f"equal bit for bit to the single-device call: J {multi['J']!r} "
          f"LR {multi['lr']!r} probes {multi['probes']} escaped "
          f"{multi['mask_count']} launches {multi['launches']}; seconds "
          f"{multi['seconds']!r} (single-device {multi['seconds_single']!r};"
          f" the pairs single, sharded, sharded, single) on {card}",
          flush=True)

    t0 = time.perf_counter()
    step = system.gd_step(prob, f, lr, use_line_search=True,
                          max_ls_iters=80)
    saved = step.f_new
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "q.pt")
        torch_ckpt.save_control(path, saved, step.lr, 1)
        loaded, lr_l, it_l = torch_ckpt.load_control(path)
    check(loaded.quad.device.type == loaded.p2.device.type == "cuda",
          f"12b: the loaded control is on {loaded.quad.device}")
    check(torch.equal(loaded.quad, saved.quad)
          and torch.equal(loaded.p2, saved.p2)
          and (lr_l, it_l) == (step.lr, 1),
          "12b: the checkpoint does not give back the saved control")
    a = system.gd_step(prob, saved, step.lr)
    b = system.gd_step(prob, loaded, lr_l)
    check(not a.diverged and bool(torch.isfinite(a.J)),
          f"12b: the step from the saved control diverged (J={float(a.J)})")
    check(torch.equal(a.J, b.J) and a.lr == b.lr and not b.diverged
          and torch.equal(a.f_new.quad, b.f_new.quad)
          and torch.equal(a.f_new.p2, b.f_new.p2),
          "12b: the GD step from the loaded control differs")
    torch.cuda.synchronize()
    print(f"path 12b: the Armijo step's f_new (LR {step.lr!r}) saved and "
          f"loaded back on {loaded.quad.device}, the GD step from it equal "
          f"bit for bit (J={float(b.J)!r}); {time.perf_counter() - t0:.2f} "
          "s", flush=True)

    t0 = time.perf_counter()
    space, ns, q = gen1_pipe_solver()
    check(ns.device.type == "cuda", f"12c: gen-1 solver on {ns.device}")
    w = ns.solve_stokes_step(q)
    check(torch.equal(w, w11), "12c: the gen-1 Stokes solve on the default "
          "device differs from 11d's")
    del ns
    torch.cuda.synchronize()
    print(f"path 12c: make_space, make_boundary_quad and NavierStokesSolver "
          f"without a device on {space.device}, the graded pipe's Stokes "
          f"state equal to 11d's; {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    code = ("import json, sys, torch, ocean_torch; "
            "from ocean_torch import OCPConfig, load_parameters; "
            "from ocean_torch.io import RunDirectory; "
            "from ocean_torch.ops import factorize, stencil_matvec; "
            "from ocean_torch.opt import grad_check; "
            "print(json.dumps({'bad': sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'ocean_jax', 'matplotlib', "
            "'h5py')), 'cuda': torch.cuda.is_initialized(), "
            "'config': ocean_torch.OCPConfig.__module__}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"12d: import ocean_torch failed: "
          f"{out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    check(got == {"bad": [], "cuda": False, "config": "ocean_torch.config"},
          f"12d: import ocean_torch gave {got}")
    print(f"path 12d: import ocean_torch in a fresh interpreter: no jax, "
          f"matplotlib or h5py, CUDA not initialized, OCPConfig from "
          f"ocean_torch.config; {time.perf_counter() - t0:.2f} s",
          flush=True)


# --- path 13: the host-stepped solver layer ---------------------------------
#
# The JAX package's records of its hi-res study (results/hires_mg/
# summary.json and run.log): nx64_nu0.01 iterations 0-1 (J, Newton
# iterations of each iteration's forward state, iteration 0's accepted LR
# and probes from LR 1) and nx256 iterations 0-1 (J, adjoint rounds and
# final relative residual).

HIRES_NU001_NEWTON = (24, 8)
HIRES_NU001_LR0, HIRES_NU001_PROBES0 = 2.0 ** -7, 8
HIRES256_J = (1.1585050541458255, 0.2390457894889173)
HIRES256_ADJOINT = ((5, 2.949e-11), (5, 2.289e-11))


@contextlib.contextmanager
def finished_states(into: list):
    """Newton stagers made inside append each forward state their
    ``finish`` returns to ``into`` (the states a runner goes on with are
    not returned by it)."""
    from ocean_torch import system

    make = system.make_newton_stager

    def wrapped(prob, **kw):
        st = make(prob, **kw)

        def finish(*args):
            out = st.finish(*args)
            into.append(out[0])
            return out
        return st._replace(finish=finish)

    system.make_newton_stager = wrapped
    try:
        yield
    finally:
        system.make_newton_stager = make


def run_runner(name: str, prob, f0, cfg, card: str, **kw):
    """``scripts/hires_mg_run_torch.py::run_gd_staged`` with the Armijo
    search from ``cfg.LR`` for ``cfg.num_steps`` iterations, counts set
    to 0 before and read after. Returns (J, seconds, Newton iterations,
    adjoint stats, the accepted (LR, probes) of each iteration, the log,
    the last forward state a stager finished, counts)."""
    import io
    import re
    import torch
    from ocean_torch import kernels

    sys.path.insert(0, str(ROOT / "scripts"))
    from hires_mg_run_torch import run_gd_staged

    fh, states = io.StringIO(), []
    kernels.reset_launch_counts()
    with finished_states(states):
        js, secs, nit, adj = run_gd_staged(
            prob, f0, cfg.LR, cfg.num_steps, fh, name, line_search=True,
            cfg=cfg, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    text = fh.getvalue()
    accepted = [(float(a), int(b)) for a, b in re.findall(
        r"line search accepted lr=(\S+) \((\d+) probes\)", text)]
    check(len(js) == cfg.num_steps == len(accepted),
          f"{name}: {len(js)} iterations, accepted {accepted}")
    check(all(v == v and abs(v) != float("inf") for v in js)
          and all(b < a for a, b in zip(js, js[1:])),
          f"{name}: J not finite and decreasing: {js}")
    check(all(adj["adjoint_rounds"]), f"{name}: adjoint rounds {adj}")
    # every forward ends in the stager's finish, which runs the ODE: the
    # first one, one a probe (an abandoned probe at its flatlined rung
    # too) and one a cold retry of a warm probe that stalled
    abandoned = text.count("abandoning probe")
    retried = text.count("cold-ladder retry")
    want = {"primal_ode": 1 + sum(p for _, p in accepted) + retried,
            "adjoint_ode": len(js), "point_sources": len(js),
            "p1_eval": 0, "segment_sum": 0, "table_ode": 0}
    check(counts == want and len(states) == want["primal_ode"],
          f"{name}: launches {counts}, expected {want} ({abandoned} "
          f"abandoned probes, {retried} cold retries)")
    print(f"{name}: J={js!r} accepted (LR, probes) {accepted} "
          f"newton_iterations={nit} adjoint rounds "
          f"{adj['adjoint_rounds']} final relative residual "
          f"{adj['adjoint_final_rel_res']!r}; {abandoned} probes abandoned "
          f"at a flatlined rung, {retried} warm probes retried cold, "
          f"{text.count('flatlined')} flatlined rungs; seconds {secs!r}; "
          f"launches {counts} on {card}", flush=True)
    return js, secs, nit, adj, accepted, text, states[-1], counts


def add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def path13a_driver_loops(cfg3, res3, tmp: str, card: str) -> dict:
    """13a: path 3's run with ``staged_driver=False`` (the per-stage
    mode): J, LR, probes and the final control equal bit for bit to path
    3's, which ran the staged mode. Returns the launches."""
    import torch
    from ocean_torch import kernels
    from ocean_torch.pipelines import limits

    cfg = dataclasses.replace(cfg3, staged_driver=False,
                              out_dir=str(Path(tmp) / "limits13a"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, _, _ = limits.run(cfg, fast_paths=True, verbose=False,
                           device="cuda",
                           ud_cache_dir=str(ROOT / "data" / "ud_torch"))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(res.j_array == res3.j_array and res.lr == res3.lr
          and res.inner_iterations == res3.inner_iterations
          and res.divs_u == res3.divs_u
          and torch.equal(res.f.quad, res3.f.quad)
          and torch.equal(res.f.p2, res3.f.p2),
          f"path 13a: the per-stage mode gives J {res.j_array} LR {res.lr} "
          f"probes {res.inner_iterations}, the staged mode (path 3) "
          f"{res3.j_array} {res3.lr} {res3.inner_iterations}")
    print(f"path 13a (limits.run, staged_driver=False, the per-stage "
          f"mode): J, LR {res.lr!r}, probes {res.inner_iterations} and the "
          f"final control equal bit for bit to path 3's staged mode; "
          f"{time.perf_counter() - t0:.2f} s with set-up and artifacts, "
          f"launches {counts} on {card}", flush=True)
    return counts


def path13b_stagers(u_d, x0, card: str):
    """13b: path 9a's problem (Nx=64, ν = 1, mg): the stepped Newton
    against ``newton_solve_mg`` (``solve_ns``), then with two forced
    re-freezes; the staged adjoint against ``_solve_adjoint_flagged``.
    Returns (kernel records, launches)."""
    import torch
    from ocean_torch import kernels, system
    from ocean_torch.config import OCPConfig

    dev = torch.device("cuda")
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=64,
                    psrc_method="fused", ode_backend="pallas")
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    check(prob.linear_solver == "mg", "path 13b: not the mg path")
    f0 = system.initial_control(prob, case=4)
    w0 = torch.zeros(prob.space.ndof, dtype=torch.float64, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ref = system.solve_ns(prob, f0.quad)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    stager = system.make_newton_stager(prob)
    t0 = time.perf_counter()
    w, it, rn, conv = system.run_newton_staged(stager, f0.quad, w0, prob.nu)
    torch.cuda.synchronize()
    t_st = time.perf_counter() - t0
    scale = float(ref.w.abs().max())
    gap = float((w - ref.w).abs().max())
    check(conv and ref.converged and it == ref.iterations
          and gap <= 1e-12 * scale,
          f"path 13b: stepped Newton {it} iterations, converged {conv}, "
          f"{gap} from newton_solve_mg's {ref.iterations} (max|w| {scale})")
    events = []
    w2, it2, rn2, conv2 = system.run_newton_staged(
        stager, f0.quad, w0, prob.nu, max_refreeze=2, stall_ratio=0.0,
        on_step=lambda i, r, e: events.append((i, r, e)))
    gap2 = float((w2 - ref.w).abs().max())
    refreezes = [(i, r) for i, r, e in events if e == "refreeze"]
    check(conv2 and len(refreezes) == 2 and gap2 <= 1e-9 * scale,
          f"path 13b: with max_refreeze=2 converged {conv2}, re-freezes "
          f"{refreezes}, {gap2} from newton_solve_mg")
    fwd, j0 = stager.finish(f0.quad, w, it, rn, conv)
    z_ref, ok_ref = system._solve_adjoint_flagged(prob, fwd)
    rounds = []
    z, g, gradj, div_u, ok = system.run_adjoint_staged(
        system.make_adjoint_stager(prob), f0, fwd,
        on_round=lambda r, rel: rounds.append((r, rel)))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    zgap = float((z - z_ref).abs().max())
    zscale = float(z_ref.abs().max())
    check(ok and ok_ref and zgap <= 1e-12 * zscale,
          f"path 13b: staged adjoint ok {ok}, {zgap} from "
          f"_solve_adjoint_flagged (max|z| {zscale})")
    want = {"primal_ode": 1, "adjoint_ode": 2, "point_sources": 2,
            "p1_eval": 0, "segment_sum": 0, "table_ode": 0}
    check(counts == want, f"path 13b: launches {counts}, expected {want}")
    print(f"path 13b (Nx=64, ν=1, mg): run_newton_staged {it} iterations "
          f"(newton_solve_mg {ref.iterations}), w {gap!r} from it (max|w| "
          f"{scale!r}), {t_st:.2f} s against {t_ref:.2f} s; max_refreeze=2 "
          f"stall_ratio=0: {it2} iterations, re-freezes after steps "
          f"{[i for i, _ in refreezes]}, converged, w {gap2!r} from "
          f"newton_solve_mg; run_adjoint_staged rounds {rounds}, z "
          f"{zgap!r} from _solve_adjoint_flagged (max|z| {zscale!r}); J "
          f"{float(j0)!r}; launches {counts} on {card}", flush=True)
    records = state_kernels(prob, fwd, counts, "rectangle, Nx=64, mg, "
                            "stepped Newton", card)
    return records, counts


def path13c_nu001(u_d, x0, card: str, j_10b: list):
    """13c: the ν = 0.01 hi-res study through ``run_gd_staged`` (Nx=64,
    mg, 6 rungs, Armijo from LR 1, 2 iterations; the stagnation break
    and the flatline abandon): iteration 0's LR and probes and J₀ held to
    the TPU record, J equal to path 10b's driver (``j_10b``, the same
    iterates from LR 2⁻⁷). J₁ is printed beside the record: the record's
    iteration 0 ran before the JAX package scaled the multigrid adjoint's
    preconditioner by 1/ν, so its g₀ and f₁ came from an adjoint that had
    not converged; J₀ hides that (its control term is 1e-7 of it), J₁
    does not. Returns (kernel records, launches)."""
    import torch
    from ocean_torch import system
    from ocean_torch.config import OCPConfig

    dev = torch.device("cuda")
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=64,
                    viscosity=0.01, newton_continuation=6,
                    use_line_search=True, LR=1.0, num_steps=2,
                    psrc_method="fused", ode_backend="pallas")
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    check(prob.linear_solver == "mg", "path 13c: not the mg path")
    f0 = system.initial_control(prob, case=4)
    js, secs, nit, adj, accepted, text, last, counts = run_runner(
        "path 13c (Nx=64, ν=0.01, run_gd_staged)", prob, f0, cfg, card)
    check(accepted[0] == (HIRES_NU001_LR0, HIRES_NU001_PROBES0),
          f"path 13c: iteration 0 accepted (LR, probes) {accepted[0]}, the "
          f"record {(HIRES_NU001_LR0, HIRES_NU001_PROBES0)}")
    gaps = [abs(a - b) / b for a, b in zip(js, HIRES_NU001_J)]
    print(f"path 13c: J {js!r} beside the TPU record "
          f"{list(HIRES_NU001_J[:2])} (relative gaps {gaps!r}; J1's record "
          f"came from an unconverged adjoint at iteration 0) and equal to "
          f"path 10b's driver {j_10b!r}; Newton iterations {nit} beside "
          f"the record's {list(HIRES_NU001_NEWTON)}; iteration 0 "
          f"{secs[0]:.1f} s from LR 1 (path 10b's driver from LR 1: 502.3 "
          f"s on an H100 80GB HBM3 at 700 W, its probes' stalled rungs "
          f"running 50 Newton steps) on {card}", flush=True)
    check(gaps[0] < 1e-6, f"path 13c: J0 {js[0]} off the TPU record")
    check(js == j_10b, f"path 13c: J {js} differs from path 10b's driver "
          f"{j_10b}")
    records = state_kernels(prob, last, counts, "rectangle, Nx=64, ν=0.01, "
                            "run_gd_staged", card)
    return records, counts


def path13d_nx256(u_d, x0, card: str):
    """13d: Nx=256 (592,387 dofs, 4 levels, CG projection) through
    ``run_gd_staged``: two Armijo iterations from LR 1 with the staged
    adjoint, J held to the TPU record. Returns (kernel records,
    launches)."""
    import torch
    from ocean_torch import system
    from ocean_torch.config import OCPConfig

    dev = torch.device("cuda")
    nx = 256
    cfg = OCPConfig(ud_experiment="400_buoys", unit_square_resolution=nx,
                    use_line_search=True, LR=1.0, num_steps=2,
                    psrc_method="fused", ode_backend="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    levels = mg_levels(prob.mg)
    check(prob.linear_solver == "mg"
          and prob.space.ndof == square_sizes(nx)[0] == 592387
          and len(levels) == 3 and prob.projector.mode == "cg",
          f"path 13d: {prob.space.ndof} dofs, {len(levels) + 1} levels, "
          f"projector {prob.projector.mode}")
    print(f"path 13d: Nx={nx}, {prob.space.ndof} mixed dofs, "
          f"{len(levels) + 1} levels (leaf {levels[-1].ainv_c.shape[0]} "
          f"velocity dofs), projector {prob.projector.mode!r}; set-up "
          f"{build_s:.2f} s by part {json.dumps(prob.setup_seconds)} on "
          f"{card}", flush=True)
    f0 = system.initial_control(prob, case=4)
    js, secs, nit, adj, accepted, text, last, counts = run_runner(
        f"path 13d (Nx={nx}, run_gd_staged)", prob, f0, cfg, card,
        adj_max_rounds=12)
    gaps = [abs(a - b) / b for a, b in zip(js, HIRES256_J)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"path 13d: J {js!r} beside the TPU record {list(HIRES256_J)} "
          f"(relative gaps {gaps!r}); adjoint (rounds, final relative "
          f"residual) {list(zip(adj['adjoint_rounds'], adj['adjoint_final_rel_res']))}"
          f" beside the record's {list(HIRES256_ADJOINT)}; Newton "
          f"iterations {nit}; seconds {secs!r}; peak device memory "
          f"{peak:.1f} GiB on {card}", flush=True)
    check(max(gaps) < 1e-6, f"path 13d: J {js} off the TPU record")
    records = state_kernels(prob, last, counts, f"rectangle, Nx={nx}, mg, "
                            "run_gd_staged", card)
    return records, counts


# --- path 14: the benchmark and the production entry points -----------------
#
# The JAX package's production records on its TPU: results/flagship_10k/
# (J_array.npy; timings.txt: 12 probes at iteration 0, then 1 each; 30
# iterations, exit "num_steps") and results/lshape_res50/ (J_array.npy: 28
# iterations of one probe each, stopped on the driver's convergence exit,
# |J₂₇ − J₂₆| = 9.9e-4 < conv_crit 1e-3). The script reads nothing under
# ``results/``: the values stand here, and tests/test_torch_bench.py holds
# them to the files.
FLAGSHIP_J = (
    28.92400479679003, 5.975766158515137, 3.0751862795488005,
    2.319831947108554, 1.8621785397980997, 1.52399324357724,
    1.2663500924924804, 1.0686587547620015, 0.9163450100453474,
    0.7985129737986334, 0.7069530245161371, 0.6354509640262123,
    0.5792922403186018, 0.5348914121595776, 0.49951657118216763,
    0.47108246871821, 0.44799502093998633, 0.4290339400006302,
    0.4132639325649059, 0.39996733974777987, 0.38859293401044015,
    0.378716917411393, 0.37001317070654594, 0.36223051655256144,
    0.3551753310534318, 0.3486982195080266, 0.3426838025935659,
    0.3370428761697246, 0.33170639233326504, 0.32662082987468466)
FLAGSHIP_PROBES = (12, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1)
LSHAPE_J = (
    0.3233596950649691, 0.2914594033529099, 0.26356135999798,
    0.23915301465517258, 0.21779364767467513, 0.19910105388578714,
    0.18274192442942794, 0.16842522819943717, 0.15589624565396737,
    0.14493199621592012, 0.1353372649669945, 0.12694109587628688,
    0.11959384198133904, 0.11316460761723457, 0.10753882737893439,
    0.10261616186876116, 0.09830880672137221, 0.09453993246384723,
    0.09124230837441605, 0.08835708142090004, 0.08583273204167496,
    0.08362418110955172, 0.08169198028522301, 0.08000159406951202,
    0.0785228030831282, 0.07722915615399839, 0.0760974986072287,
    0.07510755994627477)
LSHAPE_PROBES = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                 1, 1, 1, 1, 1, 1, 1, 1)
RECORD_RTOL = 1e-6
# bench.py's output keys (tests/test_torch_bench.py holds them to it)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline")
STAGE_KEYS = ("ns_newton_solve", "primal_ode_scan", "gradu_projection",
              "adjoint_ode", "point_sources", "adjoint_assemble_solve",
              "micro_eval_p1_tensor_2e6pts", "micro_eval_velocity_2e6pts")
STAGES_OUT_KEYS = ("K", "ndof", "backend", "stages_seconds",
                   "stages_sum_seconds", "full_fused_gd_iteration_seconds",
                   "lu_tflops_est", "note")


def record_probes(out: Path) -> tuple:
    """The probe count of each iteration in a run's ``timings.txt``."""
    return tuple(int(line.split(":")[1])
                 for line in (out / "timings.txt").read_text().splitlines()
                 if "inner loop iterations" in line)


def record_gaps(name: str, out: Path, record: tuple, probes: tuple):
    """A production run written into ``out`` against the JAX package's
    record: the same number of iterations, every J within RECORD_RTOL
    relative and the same probe counts. Returns the J array and the
    relative gaps."""
    import numpy as np
    j = np.load(out / "J_array.npy")
    got = record_probes(out)
    n = min(len(j), len(record))
    rec = np.asarray(record[:n])
    gaps = np.abs(j[:n] - rec) / np.abs(rec)
    print(f"{name}: J={j.tolist()!r} probes={list(got)} largest relative "
          f"gap to the record {float(gaps.max())!r} (iteration "
          f"{int(gaps.argmax())})", flush=True)
    check(len(j) == len(record), f"{name}: {len(j)} iterations, the record "
          f"{len(record)}")
    check(float(gaps.max()) < RECORD_RTOL, f"{name}: J off the record by "
          f"{float(gaps.max())}")
    check(got == probes, f"{name}: probes {got}, the record {probes}")
    return j, gaps


def path14_entry_points(j_10c: dict, card: str) -> dict:
    """Path 14: ``bench_torch.py`` (the headline, ``--stages``,
    ``--multi-k``) and the two production scripts at full length, through
    the functions a user's command line calls. Returns the launches of
    the whole path."""
    import contextlib
    import io
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from ocean_torch import kernels
    from ocean_torch.utils import timing

    sys.path.insert(0, str(ROOT / "scripts"))
    import bench_torch
    import flagship_refresh_torch
    import lshape_production_torch

    os.environ["BENCH_ITERS"] = "3"
    os.environ.pop("BENCH_PROFILE_DIR", None)
    os.environ.pop("LSHAPE_STEPS", None)
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    t14 = time.perf_counter()

    # --- 14a. the headline: one warm-up and 3 timed steps ------------------
    kernels.reset_launch_counts()
    rec, res = bench_torch.main()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    total = add_counts(total, counts)
    steps = 1 + 3
    want = {"primal_ode": steps, "adjoint_ode": steps,
            "point_sources": steps, "p1_eval": 0, "segment_sum": 0,
            "table_ode": 0}
    check(counts == want, f"path 14a: launches {counts}, expected {want}")
    check(tuple(rec) == BENCH_KEYS and rec["metric"] ==
          "gd_iteration_seconds_10000_buoys"
          and rec["vs_baseline"] == bench_torch.BASELINE_SECONDS
          / rec["value"], f"path 14a: record {rec}")
    j = float(res.J)
    check(j == j_10c["inverse"], f"path 14a: J {j!r}, path 10c's "
          f"dense_apply=\"inverse\" step {j_10c['inverse']!r}")
    print(f"path 14a (bench_torch.main): J={j!r} equal bit for bit to path "
          f"10c's dense_apply=\"inverse\" step; launches {counts}; "
          f"gd_iteration_seconds_10000_buoys {rec['value']!r} vs_baseline "
          f"{rec['vs_baseline']!r} on {card}", flush=True)
    del res

    with tempfile.TemporaryDirectory() as tmp:
        # --- 14b. the stages ------------------------------------------------
        kernels.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = bench_torch.stages_main(tmp)
        total = add_counts(total, kernels.launch_counts())
        on_disk = json.loads((Path(tmp) / "stages.json").read_text())
        numbers = list(out["stages_seconds"].values()) + [
            out[k] for k in ("stages_sum_seconds",
                             "full_fused_gd_iteration_seconds",
                             "lu_tflops_est")]
        check(tuple(out) == STAGES_OUT_KEYS
              and tuple(out["stages_seconds"]) == STAGE_KEYS
              and on_disk == out and out["backend"] == card
              and all(math.isfinite(v) and v > 0 for v in numbers),
              f"path 14b: stages record {out}")
        print(f"path 14b (bench_torch.stages_main): {json.dumps(out)}",
              flush=True)

        # --- 14c. the per-K envelope ----------------------------------------
        kernels.reset_launch_counts()
        env = bench_torch.multi_k_main(tmp)
        total = add_counts(total, kernels.launch_counts())
        check(tuple(env) == tuple(bench_torch.K_BASELINES)
              and json.loads((Path(tmp) / "multi_k.json").read_text())
              == env, f"path 14c: cells {list(env)}")
        for k_exp, cell in env.items():
            am = ""
            if "seconds_amortized" in cell:
                diff = cell["scan_vs_host_J_max_rel_diff_3it"]
                check(diff == 0.0, f"path 14c {k_exp}: gd_multi_step J "
                      f"differs from the host loop by {diff}")
                am = (f", amortized over {cell['amortized_steps']} "
                      f"{cell['seconds_amortized']!r} s (x"
                      f"{cell['vs_baseline_amortized']!r}), multi-step vs "
                      f"host J difference {diff!r}")
            print(f"path 14c envelope K={k_exp.split('_')[0]}: "
                  f"{cell['seconds']!r} s (x{cell['vs_baseline']!r}) "
                  f"against the reference CPU's {cell['baseline_seconds']} "
                  f"s{am} on {card}", flush=True)
    # what the amortized cells iterate: the host loop's first 3 steps
    # without line search from the benchmark's control
    from ocean_torch import system
    for k_exp in bench_torch.AMORTIZE:
        _, prob_k, f_k, lr_k = bench_torch._build(k_exp)
        steps = []
        for _ in range(3):
            r = system.gd_step(prob_k, f_k, lr_k)
            steps.append((float(r.J), r.diverged, int(r.fwd.mask.sum())))
            f_k = r.f_new
        print(f"path 14c {k_exp}: the host loop's (J, diverged, escaped) "
              f"{steps!r}", flush=True)
        del prob_k, f_k, r

    with tempfile.TemporaryDirectory() as tmp:
        # --- 14d. the flagship at full length -------------------------------
        out = Path(tmp) / "flagship"
        out.mkdir()
        # the record as the previous run, for the script's comparison
        np.save(out / "J_array.npy", np.asarray(FLAGSHIP_J))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = flagship_refresh_torch.main(
                ["--iters", "30", "--out", str(out)])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        total = add_counts(total, counts)
        print(f"path 14d (scripts/flagship_refresh_torch.py, 30 "
              f"iterations): {time.perf_counter() - t0:.2f} s with set-up "
              f"and artifacts; summary {json.dumps(summary)}", flush=True)
        check(summary["iterations_run"] == 30
              and summary["exit_reason"] == "num_steps",
              f"path 14d: {summary['iterations_run']} iterations, exit "
              f"{summary['exit_reason']}")
        _, gaps = record_gaps("path 14d", out, FLAGSHIP_J, FLAGSHIP_PROBES)
        check(summary["J_vs_previous_run_max_rel_diff"] == float(gaps.max()),
              "path 14d: the script's comparison with the previous run "
              "differs from the record's gap")
        forwards = 1 + sum(FLAGSHIP_PROBES)
        want = {"primal_ode": forwards, "adjoint_ode": 30,
                "point_sources": 30, "p1_eval": 0, "segment_sum": 0,
                "table_ode": 0}
        check(counts == want, f"path 14d: launches {counts}, expected {want}")

        # --- 14e. the L-shape to its convergence exit -----------------------
        # under a CUDA-only profiler, so the program records its spans:
        # kernel 6 runs once in every primal_ode span (the gather backend)
        out = Path(tmp) / "lshape"
        kernels.reset_launch_counts()
        timing.clear()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            res_l = lshape_production_torch.main(["--out", str(out)])
        counts = kernels.launch_counts()
        total = add_counts(total, counts)
        print(f"path 14e (scripts/lshape_production_torch.py, traced): "
              f"{buf.getvalue().strip().splitlines()[-1]} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        spans = [r for r in timing.recorded() if r.name == "primal_ode"]
        on = sum(r.attrs.get("table_kernel") == 1 for r in spans)
        timing.clear()
        forwards = 1 + sum(LSHAPE_PROBES)
        want = {"primal_ode": 0, "adjoint_ode": 0, "point_sources": 0,
                "p1_eval": 0, "segment_sum": 0, "table_ode": forwards}
        check(counts == want, f"path 14e: launches {counts}, expected {want}")
        check(len(spans) == on == counts["table_ode"],
              f"path 14e: {len(spans)} primal_ode spans, {on} with "
              f"table_kernel 1, {counts['table_ode']} table_ode launches")
        print(f"path 14e: {len(spans)} primal_ode spans, each with "
              f"table_kernel 1 and one table_ode launch", flush=True)
        j = res_l.j_array
        print(f"path 14e: exit {res_l.exit_reason} after "
              f"{res_l.iterations_run} iterations; the last |ΔJ| "
              f"{abs(j[-1] - j[-2])!r}, the one before "
              f"{abs(j[-2] - j[-3])!r}, beside the record's "
              f"{abs(LSHAPE_J[27] - LSHAPE_J[26])!r} and "
              f"{abs(LSHAPE_J[26] - LSHAPE_J[25])!r} (conv_crit 1e-3)",
              flush=True)
        record_gaps("path 14e", out, LSHAPE_J, LSHAPE_PROBES)
        check(res_l.iterations_run == len(LSHAPE_J)
              and res_l.exit_reason == "converged",
              f"path 14e: {res_l.iterations_run} iterations, exit "
              f"{res_l.exit_reason}; the record stopped converged after "
              f"{len(LSHAPE_J)}")

    print(f"path 14: {time.perf_counter() - t14:.2f} s, launches {total} on "
          f"{card}", flush=True)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "ocean_torch" / "csrc").is_dir():
        print("chip_smoke: ocean_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]   # the hard inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ocean_torch import control as ctrl_mod, kernels, system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.limits import ensure_ud
    from ocean_torch.ode import (solve_adjoint_ode, solve_adjoint_ode_cuda,
                                 solve_adjoint_ode_consistent)
    from ocean_torch.ode import cuda_ode
    from ocean_torch.ode.grideval import velocity_to_grid, grad_to_grid

    dev = torch.device("cuda")

    # --- 1. device -------------------------------------------------------
    card = gpu_line()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(logs)) or 'cached'})", flush=True)
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # --- 3. setup at the main path's configuration ------------------------
    cfg = path1_config()
    t0 = time.perf_counter()
    u_d, x0 = ensure_ud(cfg, cache_dir=str(ROOT / "data" / "ud_torch"),
                        device=dev)
    print(f"u_d: {u_d.shape} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    f = system.initial_control(prob, case=4)
    lr = cfg.LR
    torch.cuda.synchronize()
    print(f"problem: ndof={prob.space.ndof} K={prob.K} nt={prob.nt} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    warm = system.gd_step(prob, f, lr)
    torch.cuda.synchronize()
    print(f"warm-up GD step: {time.perf_counter() - t0:.2f} s "
          f"J={float(warm.J)!r}", flush=True)

    # --- 4. kernels against their plain versions ---------------------------
    ge = prob.grid
    Hy, Hx = ge.hg_shape
    Gy, Gx = ge.vg_shape
    K, nt, h = prob.K, prob.nt, prob.h
    fwd = warm.fwd
    u, _ = prob.space.split(fwd.w)
    records = []

    # kernel 1: primal ODE
    u_img = velocity_to_grid(ge, u)
    err, ms, plain, _ = primal_ode_check(ge, u_img, prob.x0, h, nt,
                                         "path 1", card)
    b, by = primal_bound(ge, K, nt)
    records.append(ode_record("primal_ode", RECTANGLE, err, ms, plain,
                              (b, by)))
    print(f"primal_ode: bound_ms={b:.4f} dynamic shared "
          f"memory {cuda_ode.shared_bytes(ge)} B a block (staging rows and "
          f"the {16 * Hy * Hx} B image)", flush=True)

    # kernel 2: adjoint ODE
    grad_u = prob.projector.project(prob.space, u)
    g_img = grad_to_grid(ge, grad_u)
    resid = (fwd.u_values - prob.u_d).contiguous()
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=dev)
    err, ms, plain = adjoint_ode_check(ge, g_img, fwd.x, resid, vlimit, h,
                                       "path 1", card)
    b, by = adjoint_bound(ge, K, nt)
    records.append(ode_record("adjoint_ode", RECTANGLE, err, ms, plain,
                              (b, by)))
    print(f"adjoint_ode: bound_ms={b:.4f}", flush=True)

    # kernels 3 and 5 take what path 1's point-source stage hands them
    got1 = scatter_inputs(prob, fwd)
    records.append(point_sources_record(*got1["point_sources"]))

    # kernel 4: ∇u at all K·nt trajectory points of path 1
    records.append(p1_eval_record(ge, g_img, fwd.x))

    # kernel 5: the per-point terms of the non-fused point-source stage,
    # from path 1's trajectories and μ
    records.append(segment_sum_record(*got1["segment_sum"]))
    del got1

    hard_inputs(ge)
    lshape_hard_inputs(dev)
    domain_hard_inputs(dev)

    # --- 5. small-input reference: card kernels vs CPU plain versions -----
    small = dict(ud_experiment="100_buoys", unit_square_resolution=8,
                 use_line_search=False, num_steps=1, ode_backend="pallas",
                 newton_reuse_lu=True)
    small_reference("small reference, path 1",
                    OCPConfig(psrc_method="fused", **small),
                    lambda p: system.initial_control(p, 4), lr)
    # [4, 0] ejects 41 of the 100 buoys at this size ([3, 0] ejects none)
    small_reference("small reference, path 2",
                    OCPConfig(psrc_method="ozaki_pallas",
                              adjoint_mode="consistent", **small),
                    lambda p: ctrl_mod.constant(p.space, p.bq, [4.0, 0.0]),
                    lr)

    # --- 6. path 1, the main path -----------------------------------------
    res1, counts1 = run_path("main path", prob, f, lr, PATH1,
                             "gd_iteration_seconds_10000_buoys", card)
    print_stages("path 1", prob, f, lr)

    # --- 7. path 2: exact segment-sum point sources, consistent adjoint ---
    cfg2 = dataclasses.replace(cfg, psrc_method="ozaki_pallas",
                               adjoint_mode="consistent")
    prob2 = system.build_problem(cfg2, u_d=u_d, x0=x0, device=dev)
    # the outflow control of tests/test_consistent_adjoint.py, made
    # stronger until it ejects a buoy
    for push in (3.0, 4.0, 6.0):
        f2 = ctrl_mod.constant(prob2.space, prob2.bq, [push, 0.0])
        escaped = int(system.forward(prob2, f2.quad).mask.sum())
        if escaped:
            break
    print(f"path 2 control: constant [{push}, 0.0] ejects {escaped} of "
          f"{prob2.K} buoys", flush=True)
    check(escaped >= 1, "path 2: no control ejected a buoy")
    res2, counts2 = run_path(
        "path 2 (ozaki_pallas, consistent)", prob2, f2, lr, PATH2,
        "gd_iteration_seconds_10000_buoys_ozaki_consistent", card)
    print_stages("path 2", prob2, f2, lr)
    fwd2 = res2.fwd
    b_oz = system.adjoint_rhs(prob2, fwd2)
    b_fu = system.adjoint_rhs(
        dataclasses.replace(prob2, psrc_method="fused"), fwd2)
    rel = float((b_oz - b_fu).abs().max() / b_fu.abs().max())
    check(rel <= TOL, f"path 2: ozaki_pallas and fused RHS differ by {rel} "
          "of max|b|")
    print(f"path 2 adjoint RHS, ozaki_pallas vs fused: {rel!r} of max|b|",
          flush=True)
    scatter_times("path 2", scatter_inputs(prob2, fwd2), card)
    # the two ODE kernels on this state's inputs: the [4, 0] flow for the
    # primal; the raw trajectories with their frozen buoys and the vlimit
    # windows of the consistent adjoint
    u2, _ = prob2.space.split(fwd2.w)
    _, _, _, escaped2 = primal_ode_check(
        prob2.grid, velocity_to_grid(prob2.grid, u2), prob2.x0, h, nt,
        "path 2", card)
    check(escaped2 == escaped, f"path 2: the kernel alone ejects {escaped2} "
          f"buoys, the path {escaped}")
    grad_u2 = prob2.projector.project(prob2.space, u2)
    vlimit2 = torch.where(fwd2.mask, fwd2.kfail.to(torch.int64) - 1, nt)
    adjoint_ode_check(prob2.grid, grad_to_grid(prob2.grid, grad_u2),
                      fwd2.x_raw.contiguous(),
                      (fwd2.u_values - prob2.u_d).contiguous(),
                      vlimit2.to(torch.int32), h, "path 2", card)

    # --- 8. the grid= adjoint entry points (kernel 4) ----------------------
    kernels.reset_launch_counts()
    mu_par = solve_adjoint_ode(prob.space, grad_u, fwd.x, fwd.u_values,
                               prob.u_d, fwd.mask, h, method="parallel",
                               grid=ge)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["p1_eval"] == 1,
          "solve_adjoint_ode(grid=) did not launch p1_eval once")
    mu_seq = solve_adjoint_ode_cuda(ge, grad_u, fwd.x, fwd.u_values,
                                    prob.u_d, fwd.mask, h)
    err_par = float((mu_par - mu_seq).abs().max())
    check(err_par <= TOL, f"parallel adjoint vs kernel: {err_par} > {TOL}")
    mu_con = solve_adjoint_ode_consistent(
        prob2.space, grad_u2, fwd2.x_raw, fwd2.u_values, prob2.u_d,
        fwd2.mask, fwd2.kfail, h, grid=prob2.grid)
    torch.cuda.synchronize()
    counts3 = kernels.launch_counts()
    check(counts3["p1_eval"] == 2,
          "solve_adjoint_ode_consistent(grid=) did not launch p1_eval once")
    mu_win = solve_adjoint_ode_cuda(
        prob2.grid, grad_u2, fwd2.x_raw, fwd2.u_values, prob2.u_d,
        torch.zeros_like(fwd2.mask), h, vlimit=vlimit2)
    err_con = float((mu_con - mu_win).abs().max())
    check(err_con <= TOL, f"consistent adjoint vs kernel: {err_con} > {TOL}")
    print(f"grid= adjoint entry points: parallel vs kernel {err_par!r}, "
          f"consistent vs kernel (vlimit) {err_con!r}, max|mu| "
          f"{float(mu_par.abs().max())!r} / {float(mu_con.abs().max())!r}, "
          f"launches={counts3}", flush=True)

    # --- 9. small-input reference of the optimisation run -----------------
    import tempfile
    import numpy as np
    from ocean_torch.pipelines import limits, ocp
    from ocean_torch.pipelines.ud_construction import seed_positions

    rng = np.random.default_rng(7)
    ud_s = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    ud_s[..., 1] -= 0.1
    armijo = dict(use_line_search=True, num_steps=3, ode_backend="pallas",
                  psrc_method="fused")
    cfg_sq = OCPConfig(ud_experiment="100_buoys", unit_square_resolution=8,
                       newton_reuse_lu=True, **armijo)
    cfg_l8 = OCPConfig(ud_experiment="3_buoys", L_shape=True,
                       L_shape_resolution=8, **armijo)
    small_reference_armijo("small Armijo reference, square (Nx=8, K=100)",
                           cfg_sq, lambda p: system.initial_control(p, 4),
                           ud_s, seed_positions(100))
    small_reference_armijo("small Armijo reference, L-shape (resolution 8)",
                           cfg_l8, lambda p: system.initial_control(p, 0))

    # --- 10. the gradient check on the card -------------------------------
    gradient_check("gradient check, L-shape (resolution 16)",
                   dataclasses.replace(cfg_l8, L_shape_resolution=16),
                   lambda p: system.initial_control(p, 0))
    gradient_check("gradient check, square (Nx=8, K=100)", cfg_sq,
                   lambda p: system.initial_control(p, 4), ud_s,
                   seed_positions(100))

    with tempfile.TemporaryDirectory() as tmp:
        # --- 11. path 3: the flagship run through limits.run --------------
        cfg3 = OCPConfig(ud_experiment="10000_buoys",
                         unit_square_resolution=32, use_line_search=True,
                         LR=5.0, num_steps=5,
                         out_dir=str(Path(tmp) / "limits"))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res3, prob3, _ = limits.run(
            cfg3, fast_paths=True, verbose=False, device=dev,
            ud_cache_dir=str(ROOT / "data" / "ud_torch"))
        torch.cuda.synchronize()
        counts_p3 = kernels.launch_counts()
        print(f"path 3 (limits.run, K=10⁴, Armijo): {res3.iterations_run} "
              f"iterations in {time.perf_counter() - t0:.2f} s with set-up "
              "and artifacts", flush=True)
        check(prob3.K == 10000 and prob3.newton_reuse_lu
              and prob3.psrc_method == "fused"
              and prob3.ode_backend == "pallas"
              and prob3.projector.mode == "inverse",
              "path 3: not the fast paths")
        print("path 3 runs dense_apply=\"inverse\" (the JAX package's "
              "--fast bundle): its seconds are not comparable with runs of "
              "the float64 LU applies", flush=True)
        check_run("path 3", res3, prob3, cfg3, counts_p3,
                  "gd_iteration_seconds_10000_buoys_armijo", card)
        # the JAX package's record of this run on a TPU (double-single
        # float32 arithmetic): results/reuse_soak/soak.json, flagship_10k
        j_tpu, probes_tpu = 28.924004796784402, 12
        dj3 = abs(res3.j_array[0] - j_tpu) / j_tpu
        print(f"path 3: first J {res3.j_array[0]!r} beside the TPU record "
              f"{j_tpu} (relative difference {dj3!r}), first "
              f"inner_iterations {res3.inner_iterations[0]} beside "
              f"{probes_tpu}", flush=True)
        check(dj3 < 1e-6 and res3.inner_iterations[0] == probes_tpu,
              "path 3: first J or probe count off the TPU record")

        # --- 12. path 4: the L-shape run through ocp.run -------------------
        cfg4 = OCPConfig(ud_experiment="3_buoys", L_shape=True,
                         L_shape_resolution=50, use_line_search=True,
                         ode_backend="pallas", psrc_method="fused",
                         num_steps=3, out_dir=str(Path(tmp) / "ocp"))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res4, prob4 = ocp.run(cfg4, verbose=False, device=dev)
        torch.cuda.synchronize()
        counts_p4 = kernels.launch_counts()
        print(f"path 4 (ocp.run, L-shape resolution 50, ndof="
              f"{prob4.space.ndof}): {res4.iterations_run} iterations in "
              f"{time.perf_counter() - t0:.2f} s with set-up and artifacts",
              flush=True)
        check(prob4.K == 3, f"path 4: K = {prob4.K}")
        check(not bool(res4.last_fwd.mask.any()), "path 4: a buoy is masked")
        check_run("path 4", res4, prob4, cfg4, counts_p4,
                  "lshape_res50_gd_iteration_seconds", card)
        # the JAX package's record (float32 factors with refinement on a
        # TPU): results/reuse_soak/soak.json, lshape_res50
        j_tpu4 = 0.3233596950649691
        dj4 = abs(res4.j_array[0] - j_tpu4) / j_tpu4
        print(f"path 4: first J {res4.j_array[0]!r} beside the TPU record "
              f"{j_tpu4} (relative difference {dj4!r})", flush=True)
        check(dj4 < 1e-6, "path 4: first J off the TPU record")

    # --- 13. the five kernels at a real size on the L-shape ---------------
    lshape_real_size(prob4, res4.last_fwd.w, records, card)
    # kernel 6 at the L-shape cell's shapes (its three starts, nt=200) and
    # at 10⁴ starts on the L-shape and on the rectangle
    u4, _ = prob4.space.split(res4.last_fwd.w)
    u1, _ = prob.space.split(warm.fwd.w)
    lshape = "L-shape, resolution 50"
    table_records = table_ode_records(
        ((lshape, prob4, u4, prob4.x0),
         (lshape, prob4, u4, lshape_seeds(prob4.grid, dev)),
         (RECTANGLE, prob, u1, prob.x0)), card)

    # --- 14. path 5: the "left" diagonal at the main path's width --------
    cfg5 = dataclasses.replace(cfg, mesh_diagonal="left")
    prob5 = system.build_problem(cfg5, u_d=u_d, x0=x0, device=dev)
    check(prob5.space.locator.diagonal == "left", "path 5: not the left "
          "diagonal")
    f5 = system.initial_control(prob5, case=4)
    res5, counts5 = run_path("path 5 (left diagonal)", prob5, f5, lr, PATH1,
                             "gd_iteration_seconds_10000_buoys_left", card)
    print_stages("path 5", prob5, f5, lr)
    domain_records = path5_kernels(prob5, res5, counts5, card)
    # the "grid" backend at the same state: the primal ODE through the
    # kernel's plain version, the same trajectories
    kernels.reset_launch_counts()
    res5g = system.gd_step(dataclasses.replace(prob5, ode_backend="grid"),
                           f5, lr)
    torch.cuda.synchronize()
    counts5g = kernels.launch_counts()
    check(counts5g["primal_ode"] == 0 and counts5g["adjoint_ode"] == 0,
          f"path 5, grid backend: launches {counts5g}")
    check(torch.equal(res5g.fwd.x, res5.fwd.x)
          and torch.equal(res5g.fwd.u_values, res5.fwd.u_values)
          and torch.equal(res5g.fwd.mask, res5.fwd.mask),
          "path 5: the grid backend's trajectories differ from kernel 1's")
    print(f"path 5, ode_backend=\"grid\": trajectories equal to kernel 1's, "
          f"J={float(res5g.J)!r} (kernels {float(res5.J)!r}), launches "
          f"{counts5g}", flush=True)
    small_reference("small reference, path 5 (left diagonal)",
                    OCPConfig(psrc_method="fused", mesh_diagonal="left",
                              **small),
                    lambda p: system.initial_control(p, 4), lr)

    # --- 15. path 6: the pipe domains, function level ----------------------
    pipe_record_sizes(dev, card)
    domain_records += pipe_real_size(dev, card)

    # --- 16. path 7: the verification harnesses -----------------------------
    path7_verification(prob, card)

    # --- 17. path 8: the initial-control study at K=10⁴ ---------------------
    counts_p8 = path8_initial_control(u_d, x0, card)

    # --- 18. path 9: the high-resolution multigrid path ----------------------
    domain_records += path9_hires(card)

    # --- 19. path 10: the golden viscosity and the float32 knobs --------------
    with tempfile.TemporaryDirectory() as tmp:
        golden_records, counts_p10a = path10a_golden(tmp, card)
    domain_records += golden_records
    j_10b = path10b_hires(card)
    j_10c = path10c_float32(cfg, u_d, x0, f, lr, res1, card)

    # --- 20. path 11: the sharded steps and gen-1 ---------------------------
    counts_p11, multi = path11_sharded(cfg, prob, f, lr, res1, f2, res2, card)
    w11 = path11_gen1(card)

    # --- 21. path 12: the surface and the loaders ---------------------------
    t0 = time.perf_counter()
    path12_surface(prob, f, lr, multi, w11, card)
    print(f"path 12b-d: {time.perf_counter() - t0:.2f} s on {card}",
          flush=True)

    # --- 22. path 13: the host-stepped solver layer --------------------------
    u_d400, x0_400 = ensure_ud(OCPConfig(ud_experiment="400_buoys",
                                         unit_square_resolution=32),
                               cache_dir=str(ROOT / "data" / "ud_torch"),
                               device=dev)
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        counts_p13 = path13a_driver_loops(cfg3, res3, tmp, card)
    for sub, extra in ((path13b_stagers, ()), (path13c_nu001, (j_10b,)),
                       (path13d_nx256, ())):
        t0 = time.perf_counter()
        recs, counts = sub(u_d400, x0_400, card, *extra)
        domain_records += recs
        counts_p13 = add_counts(counts_p13, counts)
        print(f"{sub.__name__}: {time.perf_counter() - t0:.2f} s on {card}",
              flush=True)
    print(f"path 13: {time.perf_counter() - t13:.2f} s, launches "
          f"{counts_p13} on {card}", flush=True)

    # --- 23. path 14: the benchmark and the production entry points --------
    counts_p14 = path14_entry_points(j_10c, card)

    launches = {n: counts1[n] for n in PATH1}
    launches.update({n: counts2[n] for n in PATH2 if n not in PATH1})
    launches["p1_eval"] = counts3["p1_eval"]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        rec["launches_path3"] = counts_p3[rec["name"]]
        rec["launches_path4"] = counts_p4[rec["name"]]
        rec["launches_path8"] = counts_p8[rec["name"]]
        rec["launches_path11"] = counts_p11[rec["name"]]
        rec["launches_path12"] = multi["launches"][rec["name"]]
        rec["launches_path13"] = counts_p13[rec["name"]]
        rec["launches_path14"] = counts_p14[rec["name"]]
        rec["geometry"] = RECTANGLE
    for rec in table_records:
        rec["launches"] = counts1["table_ode"] + counts2["table_ode"]
        for path, counts in (("3", counts_p3), ("4", counts_p4),
                             ("8", counts_p8), ("11", counts_p11),
                             ("12", multi["launches"]), ("13", counts_p13),
                             ("14", counts_p14)):
            rec["launches_path" + path] = counts.get("table_ode", 0)
    print(json.dumps({"kernels": records + table_records + domain_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
