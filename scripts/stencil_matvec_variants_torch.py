#!/usr/bin/env python3
"""Time layouts of the multigrid path's stencil matvec on one card, and
split one FGMRES cycle of the Nx=64 multigrid Newton step into device and
host time.

    python3 scripts/stencil_matvec_variants_torch.py

For the mixed NS operator at the Stokes state on the [0,2]² square at
Nx=64 and Nx=192, float32 and float64, each variant is checked against
``Operator.matvec64`` and timed with CUDA events (the mean of 20
applications queued behind a ~20 ms matrix product, median of 3 rounds):

* ``ops/stencil.py`` as it is (``stencil_matvec``);
* node-major (H, C, K) coefficients, one gather of the windows, the
  product and a sum over the innermost axis (no batched GEMM);
* channel-major (C, K, H) coefficients and an int32 window table, the
  product and a sum over the middle axis;
* a CSR sparse product of the same matrix (``torch.sparse``).

Beside each, the byte bound of the function (coefficients read once, x
read and y written once) at 3.35 TB/s. Then ``torch.profiler`` over one
FGMRES cycle (60 Arnoldi steps) of the first Newton step at Nx=64: the
summed device time of the kernels against the cycle's wall time, which
is the device's busy share. Needs one NVIDIA GPU; imports no JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps=20, rounds=3) -> float:
    import torch
    busy = torch.ones(8192, 8192, device="cuda")
    out = torch.empty_like(busy)
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(busy, busy, out=out)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def variants(prob):
    """(name, dtype → apply(x)) for the stencil layouts and CSR."""
    import torch
    from ocean_torch.fem import assemble
    from ocean_torch.ops import stencil

    st, n = prob.mg.st_mixed, prob.space.ndof
    op = assemble.ns_operator(
        prob.space, prob.bq, torch.zeros(n, dtype=torch.float64,
                                         device="cuda"),
        prob.nu, prob.bc_dofs)
    H, C, K = st.s_shape
    bc = op.bc_dofs
    out_cm = ((st.out_map % C) * H + st.out_map // C)   # (c, node) order
    gather_t32 = st.gather.t().contiguous().to(torch.int32)

    k = op.cell_dofs.shape[1]
    parts = [(op.cell_dofs, op.cell_mats), (op.facet_dofs, op.facet_mats)]
    rows = torch.cat([d[:, :, None].expand(-1, k, k).reshape(-1)
                      for d, _ in parts])
    cols = torch.cat([d[:, None, :].expand(-1, k, k).reshape(-1)
                      for d, _ in parts])
    vals = torch.cat([m.reshape(-1) for _, m in parts])
    free = torch.ones(n, dtype=torch.bool, device="cuda")
    free[bc] = False
    keep = free[rows]
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows[keep], bc]),
                     torch.cat([cols[keep], bc])]),
        torch.cat([vals[keep], torch.ones_like(bc, dtype=vals.dtype)]),
        (n, n)).coalesce().to_sparse_csr()

    def make(dtype):
        s = stencil.build_coefficients(st, op, dtype)            # (H, C, K)
        s_cm = s.permute(1, 2, 0).contiguous()                   # (C, K, H)
        a = csr.to(dtype)

        def node_major(x):
            xe = torch.cat([x, x.new_zeros(1)])
            y = (s * xe[st.gather][:, None, :]).sum(-1)
            return y.reshape(-1)[st.out_map].index_copy(0, bc, x[bc])

        def channel_major(x):
            xe = torch.cat([x, x.new_zeros(1)])
            X = torch.index_select(xe, 0, gather_t32.reshape(-1))
            y = (s_cm * X.reshape(1, K, H)).sum(1)
            return y.reshape(-1)[out_cm].index_copy(0, bc, x[bc])

        return {
            "stencil_matvec": (lambda x: stencil.stencil_matvec(st, s, bc, x),
                               s.numel() * s.element_size()),
            "node_major_sum": (node_major, s.numel() * s.element_size()),
            "channel_major_sum": (channel_major,
                                  s.numel() * s.element_size()),
            "csr": (lambda x: a @ x,
                    a.values().numel() * (a.values().element_size() + 4)),
        }
    return op, make


def profile_cycle(prob, f0) -> dict:
    """One FGMRES cycle of the first Newton step under torch.profiler."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from ocean_torch.fem import assemble
    from ocean_torch.solve import krylov, mg as mg_mod

    n = prob.space.ndof
    w0 = torch.zeros(n, dtype=torch.float64, device="cuda")
    op0 = assemble.ns_operator(prob.space, prob.bq, w0, prob.nu,
                               prob.bc_dofs)
    M32 = mg_mod.make_block_preconditioner(prob.mg, prob.space, op0,
                                           dtype=torch.float32)
    mv32 = mg_mod._stencil_or_scatter(prob.mg.st_mixed, op0, torch.float32)
    r = assemble.ns_residual(prob.space, prob.bq, w0, f0.quad, prob.nu)
    b = (-r.index_fill(0, prob.bc_dofs, 0.0)).float()
    krylov.fgmres(mv32, b, M=M32, restart=60, max_restarts=1, tol=1e-30)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        krylov.fgmres(mv32, b, M=M32, restart=60, max_restarts=1,
                      tol=1e-30)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    dev_s = sum(dev_time(e) for e in kernels) / 1e6
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    top = sorted(kernels, key=lambda e: -dev_time(e))[:8]
    return {"wall_s": wall, "device_s": dev_s, "busy_share": dev_s / wall,
            "launches": launches,
            "top_kernels": [(e.key[:70], dev_time(e) / 1e3, e.count)
                            for e in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ocean_torch import system
    from ocean_torch.config import OCPConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rng = torch.Generator("cuda").manual_seed(3)
    result = {"card": card, "matvec": {}}
    for nx in (64, 192):
        cfg = OCPConfig(ud_experiment="4_buoys", unit_square_resolution=nx,
                        T=0.05, dt=0.005, linear_solver="mg")
        prob = system.build_problem(
            cfg, u_d=torch.zeros(4, 10, 2), x0=torch.ones(4, 2),
            device="cuda")
        op, make = variants(prob)
        n = prob.space.ndof
        x = torch.randn(n, dtype=torch.float64, device="cuda", generator=rng)
        ref = op.matvec64(x)
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
            xd = x.to(dtype)
            for name, (fn, coef_bytes) in make(dtype).items():
                err = float((fn(xd).double() - ref).abs().max()
                            / ref.abs().max())
                assert err < tol, (name, dtype, err)
                ms = cuda_ms(lambda: fn(xd))
                bound = ((coef_bytes + 2 * n * xd.element_size())
                         / PEAK_BYTES_PER_S * 1e3)
                key = f"Nx={nx} {str(dtype)[6:]} {name}"
                result["matvec"][key] = {"ms": ms, "bound_ms": bound,
                                         "rel_err": err}
                print(f"{key}: ms={ms:.4f} bound_ms={bound:.4f} "
                      f"rel_err={err:.2e} on {card}", flush=True)
        if nx == 64:
            f0 = system.initial_control(prob, case=4)
            result["fgmres_cycle_nx64"] = profile_cycle(prob, f0)
            print(f"one FGMRES cycle (60 Arnoldi steps) at Nx=64: "
                  f"{json.dumps(result['fgmres_cycle_nx64'])} on {card}",
                  flush=True)
        del prob, op
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
