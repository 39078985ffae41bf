#!/usr/bin/env python3
"""Time the two ODE kernels of ``ocean_torch`` (primal, adjoint) from two
checkouts on the same card, on the same inputs, and compare their outputs
bit for bit.

    python3 scripts/compare_ode_kernels_torch.py PARENT_ROOT CHANGE_ROOT

Each root holds a checkout with ``ocean_torch/``. The inputs are the
path-1 inputs of ``chip_smoke.py`` (unit square, Nx=32, K=10⁴ meshgrid
seeds, nt=200, the velocity and ∇u fields of one GD step from
``initial_control(case=4)``) and, on the L-shape at resolution 50, 10⁴
meshgrid seeds inside the L in a smooth analytic flow, a random ∇u image
and random-walk trajectories; they are built once with the second root's
package and saved. Then one process per turn, in the order parent,
change, change, parent, loads them, builds that root's kernels, launches
each kernel through that root's wrapper and prints the CUDA-event mean
of 20 launches queued behind a ~20 ms matrix product (so that they run
back to back; the median of 5 rounds) and a SHA-256 of the outputs.
Before the turns it compiles both roots' ``primal_ode.cu`` and
``adjoint_ode.cu`` to cubins and compares the instruction streams
(``cuobjdump -sass``) of the rectangle's and the L-shape's
"right"-diagonal instantiations, by name: "the old domains do not pay
for the new ones" then means the same machine code. The last line is one
JSON object with the four turns, whether the outputs of the two roots
are identical and what the SASS comparison found; the exit code is 0
only if both hold. Needs one NVIDIA GPU with nvcc; imports no JAX.
"""

import hashlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path


def make_inputs(root: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch
    from ocean_torch import system
    from ocean_torch.config import OCPConfig
    from ocean_torch.ode.grideval import grad_to_grid, velocity_to_grid
    from ocean_torch.pipelines.limits import ensure_ud

    cfg = OCPConfig(ud_experiment="10000_buoys", unit_square_resolution=32,
                    use_line_search=False, num_steps=1, psrc_method="fused",
                    ode_backend="pallas", newton_reuse_lu=True)
    u_d, x0 = ensure_ud(cfg, cache_dir=str(Path(out).parent / "ud"),
                        device="cuda")
    prob = system.build_problem(cfg, u_d=u_d, x0=x0, device="cuda")
    res = system.gd_step(prob, system.initial_control(prob, 4), cfg.LR)
    u, _ = prob.space.split(res.fwd.w)
    grad_u = prob.projector.project(prob.space, u)
    # the L-shape at resolution 50: a smooth flow on its half-grid (zero in
    # the missing block), seeds inside the L, random ∇u and walks
    import numpy as np
    rng = np.random.default_rng(5)
    H = 101
    gy, gx = np.meshgrid(np.linspace(0.0, 2.0, H), np.linspace(0.0, 2.0, H),
                         indexing="ij")
    img = np.stack([0.4 * np.sin(3.0 * gy) - 0.9 + 0.1 * gx,
                    0.8 * np.cos(2.0 * gx) + 0.3 * gy], -1)
    img[(gx < 1.0) & (gy > 1.0)] = 0.0
    sx, sy = np.meshgrid(np.linspace(0.02, 1.98, 116),
                         np.linspace(0.02, 1.98, 116))
    seeds = np.stack([sx.ravel(), sy.ravel()], 1)
    seeds = seeds[(seeds[:, 1] <= 1.0) | (seeds[:, 0] >= 1.0)][:10000]
    walk = np.clip(seeds[:, None, :] + np.cumsum(
        0.01 * rng.standard_normal((10000, prob.nt, 2)), 1), -0.05, 2.05)
    torch.save({"u_img": velocity_to_grid(prob.grid, u).cpu(),
                "x0": prob.x0.cpu(), "h": prob.h, "nt": prob.nt,
                "g_img": grad_to_grid(prob.grid, grad_u).cpu(),
                "x": res.fwd.x.cpu(),
                "resid": (res.fwd.u_values - prob.u_d).cpu(),
                "l_u_img": torch.as_tensor(img.reshape(-1, 2)),
                "l_x0": torch.as_tensor(seeds),
                "l_g_img": torch.as_tensor(
                    rng.standard_normal((51 * 51, 2, 2))),
                "l_x": torch.as_tensor(walk),
                "l_resid": torch.as_tensor(
                    0.1 * rng.standard_normal(walk.shape))}, out)


def one_turn(root: str, inputs: str) -> None:
    sys.path.insert(0, root)
    import torch
    from ocean_torch.fem.spaces import make_space
    from ocean_torch.mesh import structured
    from ocean_torch.ode.cuda_adjoint import adjoint_ode_steps
    from ocean_torch.ode.cuda_ode import primal_ode_steps
    from ocean_torch.ode.grideval import make_grideval

    dev = torch.device("cuda")
    d = torch.load(inputs)
    ge = make_grideval(make_space(structured.rectangle_mesh(
        (0.0, 0.0), (2.0, 2.0), 32, 32), dev))
    u_img, x0, g_img, x, resid = (d[k].to(dev) for k in
                                  ("u_img", "x0", "g_img", "x", "resid"))
    h, nt = d["h"], d["nt"]
    vlimit = torch.full((x.shape[0],), nt, dtype=torch.int32, device=dev)
    busy = torch.ones(8192, 8192, device=dev)
    sink = torch.empty_like(busy)

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(busy, busy, out=sink)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    lge = make_grideval(make_space(structured.l_shape_mesh(50), dev))
    lu_img, lx0, lg_img, lx, lresid = (d["l_" + k].to(dev) for k in
                                       ("u_img", "x0", "g_img", "x",
                                        "resid"))
    runs = {
        "primal_ode": lambda: primal_ode_steps(ge, u_img, x0, h, nt),
        "adjoint_ode": lambda: (adjoint_ode_steps(ge, g_img, x, resid,
                                                  vlimit, h),),
        "lshape_primal_ode": lambda: primal_ode_steps(lge, lu_img, lx0, h,
                                                      nt),
        "lshape_adjoint_ode": lambda: (adjoint_ode_steps(
            lge, lg_img, lx, lresid, vlimit, h),)}
    sha = hashlib.sha256()
    for run in runs.values():
        for t in run():
            sha.update(t.cpu().numpy().tobytes())
    rounds = [[ms(run) for run in runs.values()] for _ in range(5)]
    print(json.dumps({"root": root, "sha256": sha.hexdigest(), **{
        name + "_ms": sorted(r[i] for r in rounds)[2]
        for i, name in enumerate(runs)}}))


def right_diagonal_sass(root: str, tmp: str) -> dict:
    """Instruction streams (opcode and operands, addresses dropped) of the
    rectangle's and the L-shape's "right"-diagonal instantiations of the
    primal and the adjoint ODE kernels of ``root``, by mangled name: every
    instantiation whose geometry is ``RectGeom`` or ``LshapeGeom`` itself
    (not ``LeftDiag<...>`` or a ``PipeGeom``)."""
    sys.path.insert(0, root)
    from ocean_torch import kernels
    sys.path.pop(0)
    nvcc = kernels.nvcc()
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    functions = {}
    for source in ("primal_ode.cu", "adjoint_ode.cu"):
        cubin = str(Path(tmp) / (source + ".cubin"))
        src = str(Path(root) / "ocean_torch" / "csrc" / source)
        subprocess.run([nvcc] + flags + ["-cubin", "-o", cubin, src],
                       check=True, timeout=600)
        text = subprocess.run(
            [str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin],
            check=True, capture_output=True, text=True, timeout=600).stdout
        name = None
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                functions[name] = []
            elif name is not None:
                found = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
                if found:
                    functions[name].append(found.group(1))
    return {n: f for n, f in functions.items()
            if "LeftDiag" not in n and "PipeGeom" not in n}


def main() -> int:
    if sys.argv[1:2] == ["--sass"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(right_diagonal_sass(sys.argv[2], tmp)))
        return 0
    if sys.argv[1:2] == ["--inputs"]:
        make_inputs(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--turn"]:
        one_turn(sys.argv[2], sys.argv[3])
        return 0
    parent, change = (str(Path(p).resolve()) for p in sys.argv[1:3])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    streams = [json.loads(subprocess.run(
        [sys.executable, __file__, "--sass", root], check=True,
        capture_output=True, text=True,
        timeout=900).stdout.strip().splitlines()[-1])
        for root in (parent, change)]
    old, new = streams
    sass = {"right_diagonal_sass_identical":
            bool(old) and all(new.get(n) == f for n, f in old.items()),
            "instructions_parent": {n: len(f) for n, f in old.items()},
            "instructions_change": {n: len(new[n]) for n in old
                                    if n in new}}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = str(Path(tmp) / "inputs.pt")
        subprocess.run([sys.executable, __file__, "--inputs", change, inputs],
                       check=True, timeout=600)
        turns = []
        for root in (parent, change, change, parent):
            out = subprocess.run(
                [sys.executable, __file__, "--turn", root, inputs],
                check=True, capture_output=True, text=True, timeout=600)
            turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]), flush=True)
    same = len({t["sha256"] for t in turns}) == 1
    print(json.dumps({"card": card, "turns": turns,
                      "outputs_identical": same, **sass}))
    return 0 if same and sass["right_diagonal_sass_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
