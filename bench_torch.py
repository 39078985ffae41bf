"""Headline benchmark of the PyTorch/CUDA port (``ocean_torch``): seconds
per GD iteration at 10,000 buoys, Nx=32. The counterpart of ``bench.py``,
with its configuration, modes, environment variables and output keys.

Baseline (BASELINE.md / plotting/histogram_plotting.py:9-10): the reference
FEniCS/dolfin CPU implementation takes 1500 s per gradient-descent
iteration at K=10⁴ (unit square Nx=32, line search off — the
Pipeline_limits configuration). vs_baseline = 1500 / our_seconds.

Prints ONE JSON line:
  {"metric": "gd_iteration_seconds_10000_buoys", "value": <s>,
   "unit": "s", "vs_baseline": <speedup>}

The measured step is the full outer iteration (primal NS Newton solve +
∇u projection + primal/adjoint buoy ODEs + point-source RHS + adjoint NS
solve + control update + cost), ``ocean_torch.system.gd_step`` at a fixed
control, each repetition ending in ``torch.cuda.synchronize()`` and the
host read of J. ``BENCH_ITERS`` (default 3) sets the repetitions, whose
median is reported; ``BENCH_PROFILE_DIR`` wraps them in
``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace
there.

Extra modes:
  --stages    per-stage breakdown of the K=10⁴ iteration (Newton, primal
              ODE, ∇u projection, adjoint ODE, point sources, adjoint
              solve, and the two field evaluations at all K·nt points),
              the full step and an LU-rate estimate; writes
              <out-dir>/stages.json
  --multi-k   iteration time at K=10/100/400/10000 against the reference's
              0.10 / 11.98 / 77.82 / 1500 s CPU baselines
              (plotting/histogram_plotting.py:9-10), and at K=10 and 100
              ``system.gd_multi_step`` amortized over 20 iterations;
              writes <out-dir>/multi_k.json
  --device    "cuda" (default; raises without a card) or "cpu"
  --out-dir   default results/bench_stages_torch/

    python bench_torch.py [--stages | --multi-k]
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from ocean_torch import system
from ocean_torch.config import OCPConfig
from ocean_torch.device import resolve_device
from ocean_torch.fem.interpolate import eval_p1_tensor, eval_velocity
from ocean_torch.pipelines.limits import ensure_ud

ROOT = os.path.dirname(os.path.abspath(__file__))
UD_CACHE = os.path.join(ROOT, "data", "ud_torch")
OUT_DIR = os.path.join(ROOT, "results", "bench_stages_torch")

BASELINE_SECONDS = 1500.0          # reference CPU, K=10^4 (BASELINE.md)
K_EXPERIMENT = "10000_buoys"
# reference CPU seconds per GD iteration by buoy count
# (plotting/histogram_plotting.py:9-10)
K_BASELINES = {"10_buoys": 0.10, "100_buoys": 11.98, "400_buoys": 77.82,
               "10000_buoys": 1500.0}
# gd_multi_step iterations a timed call (bench.py's cells): at K=400 and
# K=10⁴ the limits configuration diverges without line search (every buoy
# escapes), so iterating the control would time non-convergent states, not
# solver work. On the u_d synthesized at Nx=32 the K=100 trajectory turns
# non-finite at its third step too, in both packages
# (scripts/multi_k_trajectory_cpu.py): that cell's amortized time is
# mostly of such states
AMORTIZE = {"10_buoys": 20, "100_buoys": 20}


def _build(k_experiment=K_EXPERIMENT, device="cuda", **overrides):
    """The benchmark problem with the fast paths on: the chord Newton on
    the Stokes factor, the CUDA point-source and ODE kernels and the
    explicit float32 inverse of the dense applies. ``overrides`` replace
    fields of the config (the tests build at Nx=8). Returns (config,
    problem, initial control, LR)."""
    dev = resolve_device(device)
    cfg = OCPConfig(ud_experiment=k_experiment, unit_square_resolution=32,
                    use_line_search=False, num_steps=1,
                    psrc_method="fused",
                    ode_backend="pallas", dense_apply="inverse")
    cfg = dataclasses.replace(cfg, **overrides)
    u_d, x0 = ensure_ud(cfg, cache_dir=UD_CACHE, device=dev)
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device=dev)
    prob = dataclasses.replace(prob, newton_reuse_lu=True)
    f = system.initial_control(prob, case=4)
    return cfg, prob, f, cfg.LR


def _sync(x):
    """Force completion: wait for the card, then read one value of ``x``
    (a tensor, or a tuple whose first item is one) on the host."""
    leaf = x if isinstance(x, torch.Tensor) else x[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.reshape(-1)[:1].cpu()
    return x


def _timeit(fn, *args, reps=3):
    _sync(fn(*args))                       # warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _backend(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60)
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def stages_main(out_dir=OUT_DIR, device="cuda", **overrides):
    """Per-stage breakdown of one K=10⁴ GD iteration, each stage timed
    alone (warm-up, then the median of 3, each ending in a synchronize),
    and the full step. Writes ``<out_dir>/stages.json`` and returns its
    record."""
    cfg, prob, f, lr = _build(device=device, **overrides)
    fq = f.quad
    fwd = _sync(system.forward(prob, fq))
    u, _ = prob.space.split(fwd.w)
    grad_u = _sync(prob.projector.project(prob.space, u))
    state = (fwd.x, fwd.u_values, fwd.mask, fwd.x_raw, fwd.kfail)
    mu = _sync(system._adjoint_mu(prob, grad_u, *state))
    b = _sync(system._adjoint_sources(prob, u, mu, *state))

    def adj_solve(bb):
        op, op_c = system.adjoint_operators(prob, fwd.w)
        return system.solve_adjoint_system(prob, fwd, bb, op, op_c)[0]

    # micro-probes: the field evaluations at all K·nt trajectory points
    # (2·10⁶ at K=10⁴) through the plain PyTorch point location
    pts = fwd.x.reshape(-1, 2)
    stages = {
        "ns_newton_solve": _timeit(lambda q: system.solve_ns(prob, q).w, fq),
        "primal_ode_scan": _timeit(
            lambda uu: system._primal_ode(prob, uu).x, u),
        "gradu_projection": _timeit(
            lambda uu: prob.projector.project(prob.space, uu), u),
        "adjoint_ode": _timeit(
            lambda gu: system._adjoint_mu(prob, gu, *state), grad_u),
        "point_sources": _timeit(
            lambda m: system._adjoint_sources(prob, u, m, *state), mu),
        "adjoint_assemble_solve": _timeit(adj_solve, b),
        "micro_eval_p1_tensor_2e6pts": _timeit(
            lambda q: eval_p1_tensor(prob.space, grad_u, q)[0], pts),
        "micro_eval_velocity_2e6pts": _timeit(
            lambda q: eval_velocity(prob.space, u, q)[0], pts),
    }
    full = _timeit(
        lambda q: system.gd_step(prob, f, lr, use_line_search=False).J, fq)

    # achieved-rate estimate for the dominant dense stage: one LU of the
    # (ndof × ndof) saddle operator is 2/3·N³ flops
    n = prob.space.ndof
    lu_flops = (2.0 / 3.0) * n ** 3
    out = {
        "K": prob.K, "ndof": n, "backend": _backend(prob.device),
        "stages_seconds": stages,
        "stages_sum_seconds": float(sum(stages.values())),
        "full_fused_gd_iteration_seconds": full,
        "lu_tflops_est": lu_flops / stages["adjoint_assemble_solve"] / 1e12,
        "note": ("no fused program: each stage runs as its own PyTorch "
                 "calls ending in a synchronize, as the step's stages do "
                 "back to back without one; the stage sum adds the two "
                 "micro-probes, which the step does not run, and leaves "
                 "out the gradient, update, cost and div u, which it "
                 "does; lu_tflops_est treats the whole adjoint assemble + "
                 "solve as one LU of the ndof² operator, while "
                 "dense_apply=\"inverse\" applies the explicit float32 "
                 "inverse there (a nominal rate)"),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "stages.json"), "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))
    return out


def multi_k_main(out_dir=OUT_DIR, device="cuda", cells=K_BASELINES,
                 amortize=AMORTIZE, **overrides):
    """Iteration time against the reference's per-K CPU baselines
    (``cells``: experiment → reference seconds). The cells of
    ``amortize`` also time ``system.gd_multi_step`` over that many
    iterations a call, and compare its first 3 J with 3 host-loop
    ``gd_step`` calls. Prints one JSON line a metric, writes
    ``<out_dir>/multi_k.json`` and returns its record."""
    results = {}
    for k_exp, base in cells.items():
        cfg, prob, f, lr = _build(k_exp, device=device, **overrides)

        def step(fc):
            return system.gd_step(prob, fc, lr, use_line_search=False)

        res = step(f)
        _require(not bool(res.diverged), f"{k_exp}: the GD step diverged")
        _sync(res.J)
        t = _timeit(lambda fc: step(fc).J, f)
        cell = {"seconds": t, "baseline_seconds": base,
                "vs_baseline": base / t}
        n_am = amortize.get(k_exp)
        if n_am:
            def multi(fc, n=n_am):
                _, _, traj = system.gd_multi_step(prob, fc, lr, n,
                                                  use_line_search=False)
                return traj.J
            # trajectory parity: gd_multi_step against the host loop on
            # the first 3 iterations (relative; NaN-safe, the limits
            # configuration can ascend or escape without line search)
            f_h, js_host = f, []
            for _ in range(3):
                r = step(f_h)
                js_host.append(float(r.J))
                f_h = r.f_new
            js_multi = np.asarray(multi(f, 3), float)
            rel = np.nanmax(np.abs(js_multi - np.asarray(js_host))
                            / np.maximum(np.abs(js_host), 1e-300))
            t_am = _timeit(multi, f) / n_am
            cell.update({
                "seconds_amortized": t_am,
                "amortized_steps": n_am,
                "vs_baseline_amortized": base / t_am,
                "scan_vs_host_J_max_rel_diff_3it": float(rel)})
            print(json.dumps({
                "metric": f"gd_iteration_seconds_{k_exp}_amortized{n_am}",
                "value": t_am, "unit": "s", "vs_baseline": base / t_am}),
                flush=True)
        results[k_exp] = cell
        print(json.dumps({"metric": f"gd_iteration_seconds_{k_exp}",
                          "value": t, "unit": "s",
                          "vs_baseline": base / t}), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_k.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    return results


def main(device="cuda", **overrides):
    """The headline: prints one JSON line and returns (its record, the
    last step's ``GDStepResult``)."""
    cfg, prob, f, lr = _build(device=device, **overrides)

    def one_step(f_ctrl, lr_):
        return system.gd_step(prob, f_ctrl, lr_, use_line_search=False)

    res = one_step(f, lr)                  # warm-up
    _sync(res.J)
    _require(not bool(res.diverged),
             "fast-path GD step diverged (stale-LU Newton); rerun with "
             "newton_reuse_lu=False")

    iters = int(os.environ.get("BENCH_ITERS", "3"))
    profile_dir = os.environ.get("BENCH_PROFILE_DIR")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if prob.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # Fixed-control repetitions: the step's work is the same at any
    # control, and the limits configuration's GD diverges without line
    # search (every buoy escapes), so an iterating loop would time
    # non-finite states instead of solver work
    times = []
    with (torch.profiler.profile(activities=activities) if profile_dir
          else contextlib.nullcontext()) as prof:
        for _ in range(iters):
            t0 = time.perf_counter()
            res = one_step(f, lr)
            if prob.device.type == "cuda":
                torch.cuda.synchronize(prob.device)
            j_it = float(res.J)
            times.append(time.perf_counter() - t0)
            _require(np.isfinite(j_it) and not bool(res.diverged),
                     f"non-finite benchmark iteration (J={j_it})")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "bench_torch_trace.json"))
    value = float(np.median(times))
    record = {
        "metric": "gd_iteration_seconds_10000_buoys",
        "value": value,
        "unit": "s",
        "vs_baseline": BASELINE_SECONDS / value,
    }
    print(json.dumps(record), flush=True)
    return record, res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--multi-k", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()
    if args.stages:
        stages_main(args.out_dir, device=args.device)
    elif args.multi_k:
        multi_k_main(args.out_dir, device=args.device)
    else:
        main(device=args.device)
