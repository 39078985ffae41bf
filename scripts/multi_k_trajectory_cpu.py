"""What ``bench_torch.py --multi-k`` (and ``bench.py --multi-k``) iterate in
an amortized cell, in both packages on the CPU: three GD steps without
line search from the benchmark's control (``bench.py::_build``'s
configuration: Nx=32, the synthesized u_d, ``dense_apply="inverse"``,
the chord Newton on the Stokes factor), with J, the diverged flag and the
escaped buoys of each step.

The JAX package runs its float64 table paths (``ode_backend="gather"``,
``psrc_method="scatter"``: its Pallas kernels would run in interpret mode
on the CPU), the port the plain versions of its kernels; the two agree
to ~1e-12 on a step (``tests/test_torch_chord_f32.py``). The u_d is
synthesized by the port into ``--cache`` and read by both.

    python scripts/multi_k_trajectory_cpu.py [--k 100_buoys] [--cache DIR]

A few minutes: the port builds its float32 inverse on the CPU.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def port_steps(k_exp: str, cache: str, n: int = 3) -> list:
    import bench_torch
    from ocean_torch import system
    bench_torch.UD_CACHE = cache
    _, prob, f, lr = bench_torch._build(k_exp, device="cpu")
    rows = []
    for _ in range(n):
        r = system.gd_step(prob, f, lr, use_line_search=False)
        rows.append((float(r.J), bool(r.diverged), int(r.fwd.mask.sum())))
        f = r.f_new
    return rows


def jax_steps(k_exp: str, cache: str, n: int = 3) -> list:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ocean_jax import system as jsys
    from ocean_jax.config import OCPConfig
    from ocean_jax.pipelines.limits import ensure_ud
    cfg = OCPConfig(ud_experiment=k_exp, unit_square_resolution=32,
                    use_line_search=False, num_steps=1,
                    psrc_method="scatter", ode_backend="gather",
                    dense_apply="inverse")
    u_d, x0 = ensure_ud(cfg, cache_dir=cache)
    prob = dataclasses.replace(jsys.build_problem(cfg, u_d=u_d, x0=x0),
                               newton_reuse_lu=True)
    f = jsys.initial_control(prob, case=4)
    rows = []
    for _ in range(n):
        r = jsys.gd_step(prob, f, jnp.asarray(cfg.LR), use_line_search=False)
        rows.append((float(r.J), bool(r.diverged), int(r.fwd.mask.sum())))
        f = r.f_new
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", default="100_buoys")
    ap.add_argument("--cache", default=os.path.join(ROOT, ".smoke_tree",
                                                    "ud_cpu_nx32"))
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(4)
    port = port_steps(args.k, args.cache)
    print(f"port (J, diverged, escaped): {port!r}", flush=True)
    ref = jax_steps(args.k, args.cache)
    print(f"JAX  (J, diverged, escaped): {ref!r}", flush=True)
    jp, jj = np.array([r[0] for r in port]), np.array([r[0] for r in ref])
    both = np.isfinite(jp) & np.isfinite(jj)
    print(f"finite J in both: {int(both.sum())} of {len(jp)}, largest "
          f"relative gap {float(np.max(np.abs(jp - jj)[both] / np.abs(jj)[both]))!r}; "
          f"non-finite in the same steps: "
          f"{bool(np.array_equal(np.isfinite(jp), np.isfinite(jj)))}",
          flush=True)


if __name__ == "__main__":
    main()
