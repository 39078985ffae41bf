#!/usr/bin/env python3
"""Time the two ODE kernels of ``ocean_torch`` (primal, adjoint) from two
checkouts on the same card, on the same inputs, and compare their outputs
bit for bit.

    python3 scripts/compare_ode_kernels_torch.py PARENT_ROOT CHANGE_ROOT

Each root holds a checkout with ``ocean_torch/``. The inputs are the
path-1 inputs of ``chip_smoke.py`` (unit square, Nx=32, K=10⁴ meshgrid
seeds, nt=200, the velocity and ∇u fields of one GD step from
``initial_control(case=4)``), built once with the second root's package
and saved; then one process per turn, in the order parent, change,
change, parent, loads them, builds that root's kernels, launches each
kernel through that root's wrapper and prints the CUDA-event mean of 20
launches queued behind a ~20 ms matrix product (so that they run back to
back) and a SHA-256 of the outputs. Before the turns it compiles both
roots' ``primal_ode.cu`` to a cubin and compares the instruction streams
(``cuobjdump -sass``) of the rectangle's instantiations: "the rectangle
does not pay" then means the same machine code. The last line is one
JSON object with the four turns, whether the outputs of the two roots
are identical and what the SASS comparison found. Needs one NVIDIA GPU
with nvcc; imports no JAX.
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
    torch.save({"u_img": velocity_to_grid(prob.grid, u).cpu(),
                "x0": prob.x0.cpu(), "h": prob.h, "nt": prob.nt,
                "g_img": grad_to_grid(prob.grid, grad_u).cpu(),
                "x": res.fwd.x.cpu(),
                "resid": (res.fwd.u_values - prob.u_d).cpu()}, out)


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

    primal = lambda: primal_ode_steps(ge, u_img, x0, h, nt)
    adjoint = lambda: adjoint_ode_steps(ge, g_img, x, resid, vlimit, h)
    sha = hashlib.sha256()
    for t in (*primal(), adjoint()):
        sha.update(t.cpu().numpy().tobytes())
    rounds = [(ms(primal), ms(adjoint)) for _ in range(5)]
    rounds.sort()
    print(json.dumps({"root": root, "sha256": sha.hexdigest(),
                      "primal_ode_ms": sorted(r[0] for r in rounds)[2],
                      "adjoint_ode_ms": sorted(r[1] for r in rounds)[2]}))


def rectangle_sass(root: str, tmp: str) -> list:
    """Instruction streams (opcode and operands, addresses dropped) of the
    rectangle's instantiations of the primal ODE kernel of ``root``, the
    device-memory image first, then the shared-memory image."""
    sys.path.insert(0, root)
    from ocean_torch import kernels
    sys.path.pop(0)
    nvcc = kernels.nvcc()
    cubin = str(Path(tmp) / "primal_ode.cubin")
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = str(Path(root) / "ocean_torch" / "csrc" / "primal_ode.cu")
    subprocess.run([nvcc] + flags + ["-cubin", "-o", cubin, src], check=True,
                   timeout=600)
    text = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin], check=True,
        capture_output=True, text=True, timeout=600).stdout
    functions, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            functions[name] = []
        elif name is not None:
            found = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
            if found:
                functions[name].append(found.group(1))
    rect = sorted(n for n in functions if "Lshape" not in n)
    return [functions[n] for n in rect]


def main() -> int:
    if sys.argv[1:2] == ["--sass"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(rectangle_sass(sys.argv[2], tmp)))
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
    sass = {"primal_ode_rectangle_sass_identical": streams[0] == streams[1],
            "instructions_parent": [len(f) for f in streams[0]],
            "instructions_change": [len(f) for f in streams[1]]}
    print(json.dumps(sass), flush=True)
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
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
