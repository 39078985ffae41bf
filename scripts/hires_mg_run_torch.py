"""The high-resolution study of ``scripts/hires_mg_run.py`` on the port
(``ocean_torch``): gradient-descent iterations of the limits-style
configuration (400 meshgrid buoys, constant initial control, the Armijo
line search from LR 1) on the multigrid path, driven one Newton step and
one adjoint refinement round at a time from the host.

``run_gd_staged`` is the JAX runner's loop with its arguments and its
crash-resume ``.npz``: a probe whose continuation rung flatlines is
abandoned (the line search shrinks the LR), the solve at ν gives up after
8 flat Newton steps, probes above ν = 0.05 start warm from the accepted
state and retry through the cold ladder when the warm solve stalls, and
each finished iteration is saved so that a run can resume.

Run on a card (the u_d of ``400_buoys`` is synthesized at Nx=32 into
``data/ud_torch/`` on first use):

    python scripts/hires_mg_run_torch.py --resolutions 64 --viscosity 0.01 \\
        --newton-continuation 6 --line-search --iters 2

It writes ``<out>/summary.json`` and appends to ``<out>/run.log``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def log(msg, fh):
    print(msg, flush=True)
    fh.write(msg + "\n")
    fh.flush()


def run_gd_staged(prob, f, lr, iters, fh, tag, state_path=None,
                  line_search=False, cfg=None, adj_max_rounds=4,
                  newton_max_iter=50, newton_refreeze=0,
                  log_newton_steps=False, conv_crit=0.0):
    """Gradient-descent iterations over the staged stages of
    ``ocean_torch.system``. Returns (J per iteration, seconds per
    iteration, Newton iterations of each iteration's forward state,
    {"adjoint_rounds", "adjoint_final_rel_res"}).

    On the multigrid path every forward is the stepped Newton
    (``run_newton_staged``; the ν-ladder rung by rung when
    ``cfg.newton_continuation`` > 0 and ν < 1) and every adjoint the
    staged one (``run_adjoint_staged``, ``adj_max_rounds`` rounds); on
    the dense path the stages of ``make_staged_pair``.

    ``line_search=True``: Armijo backtracking with the reference's
    semantics (the LR is never reset between iterations), at most 15
    probes an iteration; a probe whose Newton solve did not converge is
    never accepted. When the search ends on such a probe the run stops on
    the last accepted state. ``state_path``: after each iteration
    (control, LR, J, seconds, Newton iterations, adjoint rounds) go to
    this ``.npz``; a run given an existing file resumes after its last
    iteration. ``newton_refreeze``: ``max_refreeze`` of the solves at ν;
    ``log_newton_steps`` logs their steps; ``conv_crit`` > 0 stops once
    consecutive J differ by less, after iteration 5."""
    import torch
    from ocean_torch import system as sys_mod
    from ocean_torch.control import Control

    progs = sys_mod.make_staged_pair(prob)
    lr = float(lr)
    js, times, newton_iters = [], [], []
    adj_rounds, adj_rels = [], []
    start = 0
    if state_path and os.path.exists(state_path):
        st = np.load(state_path)
        f = Control(torch.as_tensor(st["quad"], device=prob.device),
                    torch.as_tensor(st["p2"], device=prob.device))
        adj_rounds = [int(v) for v in st["adj_rounds"]]
        adj_rels = [float(v) for v in st["adj_rels"]]
        js = [float(v) for v in st["js"]]
        times = [float(v) for v in st["times"]]
        newton_iters = [int(v) for v in st["newton_iters"]]
        lr = float(st["lr"])
        start = len(js)
        log(f"{tag}: resuming at iteration {start} (lr={lr:g})", fh)
    tau = cfg.tau if cfg else 0.5
    lr_min = cfg.LR_MIN if cfg else 1e-8
    c_armijo = cfg.c_armijo if cfg else 1e-4
    n_rungs = cfg.newton_continuation if cfg else 0
    ladder = n_rungs > 0 and prob.nu < 1.0
    stepped = prob.linear_solver == "mg"
    if stepped:
        stager = sys_mod.make_newton_stager(prob)
        adj_stager = sys_mod.make_adjoint_stager(prob)

        on_step = None
        if log_newton_steps:
            def on_step(it_, rn_, event):
                log(f"{tag}:   newton step {it_} rn={rn_:.3e}"
                    f"{' [refreeze]' if event else ''}", fh)

        def forward(f_, w_warm=None):
            w = (torch.zeros(prob.space.ndof, dtype=torch.float64,
                             device=prob.device)
                 if w_warm is None else w_warm)
            if ladder and w_warm is None:
                for k, nu_k in enumerate(sys_mod.continuation_viscosities(
                        prob.nu, n_rungs)):
                    t0 = time.time()
                    w, rit, rrn, rconv = sys_mod.run_newton_staged(
                        stager, f_.quad, w, nu_k, nu_scale=nu_k / prob.nu,
                        max_refreeze=newton_refreeze, stagnation_break=8)
                    log(f"{tag}: rung {k} nu={nu_k:.4g} newton={rit} "
                        f"({time.time() - t0:.1f}s)", fh)
                    if not rconv and rrn > 1e-3:
                        # a flatlined rung poisons every rung below it:
                        # fail the probe fast, the Armijo loop shrinks
                        # the LR; a slow rung that still contracts (rn
                        # below 1e-3) stays on the ladder
                        log(f"{tag}: rung {k} flatlined (rn={rrn:.3e}); "
                            "abandoning probe", fh)
                        return stager.finish(f_.quad, w, rit, rrn, False)
            # a flatlined solve at ν gives up after 8 flat steps: the
            # caller's cold-ladder retry is the productive fallback
            w, nit, rn, conv = sys_mod.run_newton_staged(
                stager, f_.quad, w, prob.nu, max_iter=newton_max_iter,
                max_refreeze=newton_refreeze, on_step=on_step,
                stagnation_break=8)
            return stager.finish(f_.quad, w, nit, rn, conv)

        fwd, j_dev = forward(f)

        # probes start warm from the accepted state only at ν ≥ 0.05: at
        # ν = 0.01 every warm probe stalls (the frozen Stokes leaf misses
        # the convection a changed control brings) while the cold ladder
        # converges, so the warm attempt there is waste
        warm_ok = ladder and prob.nu >= 0.05

        def probe(f_, g_, lr_):
            f_new = stager.axpy(f_, g_, lr_)
            fwd_new, j_new_dev = forward(
                f_new, w_warm=(fwd.w if warm_ok else None))
            if warm_ok and not fwd_new.newton.converged:
                log(f"{tag}: warm probe stalled (rn="
                    f"{fwd_new.newton.residual_norm:.3e}); "
                    "cold-ladder retry", fh)
                fwd_new, j_new_dev = forward(f_new)
            return f_new, fwd_new, j_new_dev
    else:
        fwd, j_dev = progs.begin(f.quad)

        def probe(f_, g_, lr_):
            return progs.probe(f_, g_, lr_)
    j_old = float(j_dev)
    for i in range(start, iters):
        t0 = time.time()
        if stepped:
            adj_last = [0, float("nan")]   # this iteration's rounds, rel

            def on_round(rd, rel):
                adj_last[0], adj_last[1] = rd, rel
                log(f"{tag} it={i} adjoint round {rd}: rel res "
                    f"{rel:.3e}", fh)

            z, g, gradj_dev, div_dev, adj_ok = sys_mod.run_adjoint_staged(
                adj_stager, f, fwd, max_rounds=adj_max_rounds,
                on_round=on_round)
            adj_rounds.append(adj_last[0])
            adj_rels.append(adj_last[1])
        else:
            z, g, gradj_dev, div_dev, adj_ok = progs.grad(f, fwd)
        if not adj_ok:
            raise RuntimeError(
                f"{tag}: adjoint refinement not converged at iteration "
                f"{i} (raise adj_max_rounds)")
        if line_search:
            cond = -c_armijo * float(gradj_dev)
            for inner in range(15):
                f_c, fwd_c, j_dev = probe(f, g, lr)
                j_new = float(j_dev)
                # a probe whose Newton did not converge carries a state
                # that is not a solution: never accept it
                if fwd_c.newton.converged and j_old - j_new >= lr * cond:
                    break
                new_lr = max(tau * lr, lr_min)
                if new_lr == lr:
                    break                  # floored: a re-probe is the same
                lr = new_lr
            if not fwd_c.newton.converged:
                log(f"{tag}: line search exhausted at iteration {i} "
                    f"with a non-converged probe (lr={lr:g}, rn="
                    f"{fwd_c.newton.residual_norm:.3e}); stopping on the "
                    "last accepted state", fh)
                break
            log(f"{tag} it={i} line search accepted lr={lr:g} "
                f"({inner + 1} probes)", fh)
        else:
            f_c, fwd_c, j_dev = probe(f, g, lr)
            j_new = float(j_dev)
        # the recorded J: old u_values, new control
        j = float(progs.record(fwd.u_values, f_c.quad))
        dt = time.time() - t0
        if not np.isfinite(j):
            raise RuntimeError(f"{tag}: non-finite J at iteration {i}")
        if not fwd.newton.converged:
            raise RuntimeError(
                f"{tag}: Newton not converged at iteration {i} (residual "
                f"{fwd.newton.residual_norm:.3e})")
        js.append(j)
        times.append(dt)
        newton_iters.append(int(fwd.newton.iterations))
        log(f"{tag} it={i} J={j:.6e} newton={newton_iters[-1]} "
            f"t={dt:.2f}s [staged]", fh)
        f, fwd, j_old = f_c, fwd_c, j_new
        if state_path:
            np.savez(state_path, quad=f.quad.cpu().numpy(),
                     p2=f.p2.cpu().numpy(), js=np.asarray(js),
                     times=np.asarray(times),
                     newton_iters=np.asarray(newton_iters),
                     lr=np.asarray(lr), adj_rounds=np.asarray(adj_rounds),
                     adj_rels=np.asarray(adj_rels))
        if (conv_crit > 0 and i > 5
                and abs(js[-1] - js[-2]) < conv_crit):
            log(f"{tag}: converged at it={i} "
                f"(|dJ|={abs(js[-1] - js[-2]):.3e} < {conv_crit:g})", fh)
            break
    return js, times, newton_iters, {
        "adjoint_rounds": adj_rounds,
        "adjoint_final_rel_res": adj_rels}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolutions", type=int, nargs="*", default=[64, 96])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--line-search", action="store_true")
    ap.add_argument("--viscosity", type=float, default=1.0)
    ap.add_argument("--newton-continuation", type=int, default=0)
    ap.add_argument("--mg-pre", type=int, default=2)
    ap.add_argument("--mg-post", type=int, default=2)
    ap.add_argument("--mg-coarse-krylov", type=int, default=0)
    ap.add_argument("--mg-leaf-budget", type=int, default=0)
    ap.add_argument("--adj-max-rounds", type=int, default=4)
    ap.add_argument("--newton-max-iter", type=int, default=50)
    ap.add_argument("--newton-refreeze", type=int, default=0)
    ap.add_argument("--log-newton-steps", action="store_true")
    ap.add_argument("--conv-crit", type=float, default=0.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "hires_mg_torch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from ocean_torch import system as sys_mod
    from ocean_torch.config import OCPConfig
    from ocean_torch.pipelines.limits import ensure_ud

    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "summary.json")
    summary = {"runs": {}}
    if os.path.exists(summary_path):
        with open(summary_path) as sf:
            summary = json.load(sf)
    with open(os.path.join(args.out, "run.log"), "a") as fh:
        u_d, x0 = ensure_ud(OCPConfig(ud_experiment="400_buoys",
                                      unit_square_resolution=32),
                            cache_dir=os.path.join(ROOT, "data", "ud_torch"),
                            device=args.device)
        for nx in args.resolutions:
            tag = (f"nx{nx}" if args.viscosity == 1.0
                   else f"nx{nx}_nu{args.viscosity:g}")
            cfg = OCPConfig(ud_experiment="400_buoys",
                            unit_square_resolution=nx,
                            use_line_search=False, num_steps=args.iters,
                            linear_solver="mg", viscosity=args.viscosity,
                            mg_pre=args.mg_pre, mg_post=args.mg_post,
                            mg_coarse_krylov=args.mg_coarse_krylov,
                            mg_leaf_budget=args.mg_leaf_budget,
                            newton_continuation=args.newton_continuation,
                            psrc_method="fused", ode_backend="pallas")
            t0 = time.time()
            prob = sys_mod.build_problem(cfg, u_d=u_d, x0=x0,
                                         device=args.device)
            log(f"built {tag}: ndof={prob.space.ndof} coarse="
                f"{prob.mg.space_c.ndof} ({time.time() - t0:.1f}s)", fh)
            f = sys_mod.initial_control(prob, case=4)
            js, times, nit, adj = run_gd_staged(
                prob, f, args.lr, args.iters, fh, tag,
                state_path=os.path.join(args.out, f"state_{tag}.npz"),
                line_search=args.line_search, cfg=cfg,
                adj_max_rounds=args.adj_max_rounds,
                newton_max_iter=args.newton_max_iter,
                newton_refreeze=args.newton_refreeze,
                log_newton_steps=args.log_newton_steps,
                conv_crit=args.conv_crit)
            summary["runs"][tag] = {
                "ndof": prob.space.ndof, "viscosity": args.viscosity,
                "newton_continuation": args.newton_continuation,
                "lr": args.lr, "line_search": args.line_search, "J": js,
                "seconds_per_iter": times, "newton_iterations": nit, **adj}
            with open(summary_path, "w") as sf:
                json.dump(summary, sf, indent=2)
        log("summary written", fh)


if __name__ == "__main__":
    main()
