#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ocean_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: require CUDA (no CPU fallback); print the card's name and
   power limit as nvidia-smi reports them;
2. build: compile the three CUDA kernels from ``ocean_torch/csrc`` (one
   nvcc per source, in parallel) and print the seconds;
3. setup at the scalability configuration of ``bench.py::_build`` (unit
   square [0,2]², Nx=32, K=10⁴ buoys, nt=200, line search off, dense
   solver, chord Newton on the Stokes factor, CUDA ODE and point-source
   kernels): synthesize u_d (cached in ``data/ud_torch/``), build the
   problem, and run one warm-up GD step whose state feeds phase 4;
4. each kernel against its plain PyTorch version on the same inputs at
   the main path's shapes: maximum error against the stated tolerance,
   kernel and plain times (CUDA events), and for the point sources two
   launches bit-identical plus the ``index_add_`` yardstick;
5. a small-input reference check: one GD step at Nx=8, K=100 through the
   kernels on the card against the plain versions on the CPU;
6. the main path: launch counts set to 0, one GD step from
   ``initial_control(case=4)``, counts read (each kernel must have run);
   J finite, not diverged, Newton converged; then the median seconds of
   3 repeats at the fixed control.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

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
# × (multiply + 4 split operations) = 95.
OPS_PRIMAL_STEP = 75
OPS_ADJOINT_STEP = 60
OPS_PSRC_POINT = 95

TOL = 1e-12


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
    from ocean_torch.adjoint import point_source_rhs
    from ocean_torch.fem import assemble
    from ocean_torch.ode import solve_adjoint_ode_cuda
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
    mu = timed("adjoint_ode", lambda: solve_adjoint_ode_cuda(
        prob.grid, grad_u, ode.x, ode.u_values, prob.u_d, ode.mask, prob.h))
    b = timed("point_sources", lambda: point_source_rhs(
        prob.space, u, ode.x, mu, prob.u_d, ode.mask, prob.h, prob.center,
        method=prob.psrc_method, grid=prob.grid, u_values=ode.u_values))
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "ocean_torch" / "csrc").is_dir():
        print("chip_smoke: ocean_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ocean_torch import kernels, system
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.limits import ensure_ud
    from ocean_torch.pipelines.ud_construction import seed_positions
    from ocean_torch.ode.grideval import velocity_to_grid, grad_to_grid
    from ocean_torch.ode.cuda_ode import (primal_ode_steps,
                                          primal_ode_steps_plain)
    from ocean_torch.ode.cuda_adjoint import (adjoint_ode_steps,
                                              adjoint_ode_steps_plain)
    from ocean_torch.adjoint.cuda_psrc import (
        point_source_limbs, point_source_limbs_plain, gamma_scale)
    from ocean_torch.ode.grideval import grid_coords, p2_patch_weights

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
            if "registers" in line or "spill" in line:
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

    # kernel 3: point sources, on the γ the main path builds
    mu = torch.where(fwd.mask[:, None, None], 0.0, mk)
    gamma = h * ((prob.u_d - fwd.u_values) + mu)
    gamma = torch.where((~fwd.mask)[:, None, None], gamma, 0.0)
    pts = fwd.x.reshape(-1, 2).contiguous()
    scale = gamma_scale(gamma.reshape(-1, 2))
    r = (gamma.reshape(-1, 2) / scale).contiguous()
    hk, lk = point_source_limbs(ge, pts, r)
    hk2, lk2 = point_source_limbs(ge, pts, r)
    torch.cuda.synchronize()
    check(torch.equal(hk, hk2) and torch.equal(lk, lk2),
          "point_sources: two launches differ")
    hp, lp = point_source_limbs_plain(ge, pts, r)

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
    records.append(dict(name="point_sources", route="cuda",
                        source="ocean_torch/csrc/point_sources.cu",
                        replaces="ocean_jax/adjoint/pallas_psrc.py:226",
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b, bound_by=by, library_ms=lib))
    print(f"point_sources: max_abs_err={err!r} vs_f64_sum={err_f64!r} "
          f"M={M} active={active} ms={ms:.4f} plain_ms={plain:.4f} "
          f"index_add_ms={lib:.4f} bound_ms={b:.4f}", flush=True)
    del xp, up, mp, hp, lp, W, vals, nodes

    # --- 5. small-input reference: card kernels vs CPU plain versions -----
    # (u_d from a seed: a generated one would share the cache key
    # "100_buoys" with other resolutions)
    small = OCPConfig(ud_experiment="100_buoys", unit_square_resolution=8,
                      use_line_search=False, num_steps=1,
                      psrc_method="fused", ode_backend="pallas",
                      newton_reuse_lu=True)
    rng = np.random.default_rng(7)
    ud_s = 0.1 + 0.02 * rng.standard_normal((100, 200, 2))
    ud_s[..., 1] -= 0.1
    x0_s = seed_positions(100)
    res = {}
    for where in ("cpu", "cuda"):
        p = system.build_problem(small, u_d=ud_s, x0=x0_s, device=where)
        res[where] = system.gd_step(p, system.initial_control(p, 4), lr)
    dj = abs(float(res["cuda"].J) - float(res["cpu"].J)) / abs(
        float(res["cpu"].J))
    dq = float((res["cuda"].f_new.quad.cpu() - res["cpu"].f_new.quad).abs()
               .max() / res["cpu"].f_new.quad.abs().max())
    check(dj < 1e-10 and dq < 1e-8,
          f"small reference: J rel {dj}, f_new rel {dq}")
    print(f"small reference (Nx=8, K=100): J rel {dj!r} f_new rel {dq!r}",
          flush=True)

    # --- 6. the main path -------------------------------------------------
    kernels.reset_launch_counts()
    res = system.gd_step(prob, f, lr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    j = float(res.J)
    check(all(n >= 1 for n in counts.values()),
          f"a kernel did not run on the main path: {counts}")
    check(j == j and abs(j) != float("inf"), f"non-finite J {j}")
    check(not res.diverged, "GD step diverged")
    check(res.fwd.newton.converged, "Newton did not converge")
    check(res.f_new.quad.shape == f.quad.shape
          and bool(torch.isfinite(res.f_new.quad).all()),
          "bad control update")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        r_ = system.gd_step(prob, f, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dj = abs(float(r_.J) - j) / abs(j)
        check(dj < 1e-12, f"GD step at a fixed control drifts: {dj}")
    times.sort()
    print(f"main path: J={j!r} newton_iters={res.fwd.newton.iterations} "
          f"escaped={int(res.fwd.mask.sum())} launches={counts}", flush=True)
    print(f"gd_iteration_seconds_10000_buoys: median {times[1]!r} "
          f"(repeats {times!r}) on {card}", flush=True)

    stages = stage_seconds(prob, f, lr)
    print(f"stages (s, host clock, one GD step): {json.dumps(stages)} "
          f"sum {sum(stages.values())!r}", flush=True)

    for rec in records:
        rec["launches"] = counts[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
