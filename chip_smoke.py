#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ocean_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: require CUDA (no CPU fallback); print the card's name and
   power limit as nvidia-smi reports them;
2. build: compile the five CUDA kernels from ``ocean_torch/csrc`` (one
   nvcc per source, in parallel) and print the seconds and what ptxas
   says of registers, spills and shared memory (its "Used" line names
   shared memory only where a kernel has some; no launch asks for
   dynamic shared memory);
3. setup at the scalability configuration of ``bench.py::_build`` (unit
   square [0,2]², Nx=32, K=10⁴ buoys, nt=200, line search off, dense
   solver, chord Newton on the Stokes factor, CUDA ODE and point-source
   kernels): synthesize u_d (cached in ``data/ud_torch/``), build the
   problem, and run one warm-up GD step whose state feeds phase 4;
4. each kernel against its plain PyTorch version on the same inputs at
   the main path's shapes: maximum error against the stated tolerance,
   kernel and plain times (CUDA events), the integer sums (point sources,
   segment sum) bit-identical to the plain version and between two
   launches, and the ``index_add_`` yardstick where one exists; then the
   two scatter kernels on the small hard inputs of
   ``tests/torch_kernel_cases.py`` (one square or segment, one per lane,
   points on nodes and the diagonal, ragged M, zero and negative weights,
   dropped ids, ±scale), each equal to the plain version;
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
   scatter kernels' times on this state's inputs (shorter groups);
8. the parallel-prefix adjoint entry points with the grid tables
   (``solve_adjoint_ode(method="parallel", grid=)`` on path 1's state,
   ``solve_adjoint_ode_consistent(grid=)`` on path 2's): each launches
   the ∇u evaluation kernel once and matches the sequential adjoint
   kernel.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

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
# = 33.
OPS_PRIMAL_STEP = 75
OPS_ADJOINT_STEP = 60
OPS_PSRC_POINT = 95
OPS_P1_EVAL_POINT = 41
OPS_OZAKI_VALUE = 33

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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches after one
    warm-up, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def stage_seconds(prob, f, lr) -> dict:
    """Host-clock seconds of each stage of one GD step, in the order
    ``system.gd_step`` runs them, each ending in a synchronize."""
    import torch
    from ocean_torch import system
    from ocean_torch.fem import assemble
    from ocean_torch.solve import solve_operator_reuse_t

    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return val

    newton = timed("ns_newton", lambda: system._solve_ns(prob, f.quad))
    u, _ = prob.space.split(newton.w)
    ode = timed("primal_ode", lambda: system._primal_ode(prob, u))
    grad_u = timed("gradu_projection",
                   lambda: prob.projector.project(prob.space, u))
    state = (ode.x, ode.u_values, ode.mask, ode.x_raw, ode.kfail)
    mu = timed("adjoint_ode",
               lambda: system._adjoint_mu(prob, grad_u, *state))
    b = timed("point_sources",
              lambda: system._adjoint_sources(prob, u, mu, *state))
    op = timed("adjoint_assemble", lambda: assemble.adjoint_operator(
        prob.space, prob.bq, newton.w, prob.bc_dofs))
    z, _ = timed("adjoint_solve", lambda: solve_operator_reuse_t(
        op, b, prob.bc_vals, newton.fac, refine_iters=prob.refine_iters))

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


def p1_eval_record(ge, g_img, x) -> dict:
    """Kernel 4 (∇u at every trajectory point) against its plain version:
    values within TOL, inside flags identical."""
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
    ms = cuda_ms(lambda: eval_p1_tensor_cuda(ge, g_img, x), 20)
    plain = cuda_ms(lambda: eval_p1_tensor_grid(ge, g_img, x), 5)
    n = x.numel() // 2
    Gy, Gx = ge.vg_shape
    nbytes = 8 * (2 * n + 4 * Gy * Gx + 4 * n) + n
    b, by = bound_ms(nbytes, OPS_P1_EVAL_POINT * n)
    print(f"p1_eval: max_abs_err={err!r} N={n} outside={int((~ik).sum())} "
          f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f}", flush=True)
    return dict(name="p1_eval", route="cuda",
                source="ocean_torch/csrc/p1_eval.cu",
                replaces="ocean_jax/ode/pallas_eval.py:201",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None)


def point_sources_record(ge, x, gamma) -> dict:
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
    W = p2_patch_weights(s, t).reshape(-1, 9)
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
    print(f"point_sources: max_abs_err={err!r} vs_f64_sum={err_f64!r} "
          f"M={M} active={active} ms={ms:.4f} plain_ms={plain:.4f} "
          f"index_add_ms={lib:.4f} bound_ms={b:.4f}", flush=True)
    return dict(name="point_sources", route="cuda",
                source="ocean_torch/csrc/point_sources.cu",
                replaces="ocean_jax/adjoint/pallas_psrc.py:226",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def segment_sum_record(cell, vals, scale, num_cells: int) -> dict:
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
    print(f"segment_sum: max_abs_err={err!r} (int64 slice sums) "
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
    """The two scatter kernels on the small hard inputs of
    ``tests/torch_kernel_cases.py``, each equal (``torch.equal``) to its
    plain version on the card. The point sources run on the main path's
    Nx=32 grid (``ge32``) and on an Nx=64 grid."""
    import torch
    import torch_kernel_cases as kernel_cases
    from ocean_torch.adjoint import cuda_psrc
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import structured
    from ocean_torch.ode.grideval import make_grideval
    from ocean_torch.ops import psum_cuda

    dev = ge32.dof_to_node.device
    ge64 = make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), 64, 64), dev))
    for nx, ge in ((32, ge32), (64, ge64)):
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
    print(f"hard inputs: point_sources {len(kernel_cases.PSRC_CASES)} cases "
          f"× Nx 32 and 64, segment_sum "
          f"{len(kernel_cases.SEG_CASES)} cases: all equal to the plain "
          "versions", flush=True)


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
    from ocean_torch.ode.grideval import velocity_to_grid, grad_to_grid
    from ocean_torch.ode.cuda_ode import (primal_ode_steps,
                                          primal_ode_steps_plain)
    from ocean_torch.ode.cuda_adjoint import (adjoint_ode_steps,
                                              adjoint_ode_steps_plain)

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
    cfg = OCPConfig(ud_experiment="10000_buoys", unit_square_resolution=32,
                    use_line_search=False, num_steps=1,
                    psrc_method="fused", ode_backend="pallas",
                    newton_reuse_lu=True)
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
    xk, uk, fk, kk = primal_ode_steps(ge, u_img, prob.x0, h, nt)
    torch.cuda.synchronize()
    xp, up, fp, kp = primal_ode_steps_plain(ge, u_img, prob.x0, h, nt)
    err = max(float((xk - xp).abs().max()), float((uk - up).abs().max()))
    check(torch.equal(fk, fp) and torch.equal(kk, kp),
          "primal_ode: failed/kfail differ from the plain version")
    check(err <= TOL, f"primal_ode: max error {err} > {TOL}")
    ms = cuda_ms(lambda: primal_ode_steps(ge, u_img, prob.x0, h, nt), 20)
    plain = cuda_ms(lambda: primal_ode_steps_plain(ge, u_img, prob.x0, h,
                                                   nt), 3)
    nbytes = 8 * (K * 2 + Hy * Hx * 2 + 2 * K * nt * 2) + 4 * 2 * K
    b, by = bound_ms(nbytes, OPS_PRIMAL_STEP * K * (nt - 1))
    records.append(dict(name="primal_ode", route="cuda",
                        source="ocean_torch/csrc/primal_ode.cu",
                        replaces="ocean_jax/ode/pallas_ode.py:480",
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b, bound_by=by, library_ms=None))
    print(f"primal_ode: max_abs_err={err!r} escaped={int(fk.sum())} "
          f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f}", flush=True)

    # kernel 2: adjoint ODE
    grad_u = prob.projector.project(prob.space, u)
    g_img = grad_to_grid(ge, grad_u)
    resid = (fwd.u_values - prob.u_d).contiguous()
    vlimit = torch.full((K,), nt, dtype=torch.int32, device=dev)
    mk = adjoint_ode_steps(ge, g_img, fwd.x, resid, vlimit, h)
    torch.cuda.synchronize()
    mp = adjoint_ode_steps_plain(ge, g_img, fwd.x, resid, vlimit, h)
    err = float((mk - mp).abs().max())
    check(err <= TOL, f"adjoint_ode: max error {err} > {TOL}")
    check(bool(torch.isfinite(mk).all()), "adjoint_ode: non-finite μ")
    ms = cuda_ms(lambda: adjoint_ode_steps(ge, g_img, fwd.x, resid, vlimit,
                                           h), 20)
    plain = cuda_ms(lambda: adjoint_ode_steps_plain(ge, g_img, fwd.x, resid,
                                                    vlimit, h), 3)
    nbytes = 8 * (3 * K * nt * 2 + Gy * Gx * 4) + 4 * K
    b, by = bound_ms(nbytes, OPS_ADJOINT_STEP * K * (nt - 1))
    records.append(dict(name="adjoint_ode", route="cuda",
                        source="ocean_torch/csrc/adjoint_ode.cu",
                        replaces="ocean_jax/ode/pallas_adjoint.py:326",
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b, bound_by=by, library_ms=None))
    print(f"adjoint_ode: max_abs_err={err!r} ms={ms:.4f} "
          f"plain_ms={plain:.4f} bound_ms={b:.4f}", flush=True)

    # kernels 3 and 5 take what path 1's point-source stage hands them
    got1 = scatter_inputs(prob, fwd)
    records.append(point_sources_record(*got1["point_sources"]))
    del xp, up, mp

    # kernel 4: ∇u at all K·nt trajectory points of path 1
    records.append(p1_eval_record(ge, g_img, fwd.x))

    # kernel 5: the per-point terms of the non-fused point-source stage,
    # from path 1's trajectories and μ
    records.append(segment_sum_record(*got1["segment_sum"]))
    del got1

    hard_inputs(ge)

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
    _, counts1 = run_path("main path", prob, f, lr, PATH1,
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
        escaped = int(system._forward(prob2, f2.quad).mask.sum())
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
    u2, _ = prob2.space.split(fwd2.w)
    grad_u2 = prob2.projector.project(prob2.space, u2)
    mu_con = solve_adjoint_ode_consistent(
        prob2.space, grad_u2, fwd2.x_raw, fwd2.u_values, prob2.u_d,
        fwd2.mask, fwd2.kfail, h, grid=prob2.grid)
    torch.cuda.synchronize()
    counts3 = kernels.launch_counts()
    check(counts3["p1_eval"] == 2,
          "solve_adjoint_ode_consistent(grid=) did not launch p1_eval once")
    vlimit2 = torch.where(fwd2.mask, fwd2.kfail.to(torch.int64) - 1, nt)
    mu_win = solve_adjoint_ode_cuda(
        prob2.grid, grad_u2, fwd2.x_raw, fwd2.u_values, prob2.u_d,
        torch.zeros_like(fwd2.mask), h, vlimit=vlimit2)
    err_con = float((mu_con - mu_win).abs().max())
    check(err_con <= TOL, f"consistent adjoint vs kernel: {err_con} > {TOL}")
    print(f"grid= adjoint entry points: parallel vs kernel {err_par!r}, "
          f"consistent vs kernel (vlimit) {err_con!r}, max|mu| "
          f"{float(mu_par.abs().max())!r} / {float(mu_con.abs().max())!r}, "
          f"launches={counts3}", flush=True)

    launches = {n: counts1[n] for n in PATH1}
    launches.update({n: counts2[n] for n in PATH2 if n not in PATH1})
    launches["p1_eval"] = counts3["p1_eval"]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
