"""The L-shape production run of ``scripts/lshape_production.py`` on the
port (``ocean_torch``), at the reference resolution 50.

Reference configuration (``OCP_dolfin.py`` with L_shape=True): 3 analytic
buoys, Armijo line search, LR=5, resolution 50 (17,378 mixed dofs, the
dense path), ``LSHAPE_STEPS`` iterations (default 30) through
``pipelines.ocp.run``, which stops earlier on the convergence exit. Writes
the run's artifacts under ``--out`` (default
``results/lshape_res50_torch/``; the JAX package's record is never
written).

    python scripts/lshape_production_torch.py [--out DIR]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "results", "lshape_res50_torch")


def main(argv=None):
    """Run the L-shape; returns the driver's ``GDRunResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from ocean_torch.config import OCPConfig
    from ocean_torch.device import resolve_device
    from ocean_torch.pipelines import ocp

    device = resolve_device(args.device)
    print(f"backend: {device.type}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)
    cfg = OCPConfig(L_shape=True, L_shape_resolution=50,
                    ud_experiment="3_buoys",
                    num_steps=int(os.environ.get("LSHAPE_STEPS", "30")),
                    use_line_search=True, LR=5.0,
                    out_dir=args.out + "/")
    t0 = time.time()
    res, prob = ocp.run(cfg, verbose=True, device=device)
    print(f"done in {time.time()-t0:.1f}s: {res.iterations_run} iterations,"
          f" J {res.j_array[0]:.4e} -> {res.j_array[-1]:.4e},"
          f" exit={res.exit_reason}", flush=True)
    if not res.j_array[-1] < res.j_array[0]:
        raise RuntimeError(f"J did not descend: {res.j_array}")
    return res


if __name__ == "__main__":
    main()
