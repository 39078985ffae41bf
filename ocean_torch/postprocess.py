"""Post-processing and cross-experiment reporting (port of
``ocean_jax/postprocess.py``), the reference's plotting toolbox:

  * ``cost_curve_overlay``: several runs' ``J_array.npy`` cost curves in
    one figure,
  * ``aggregate_timings``: a ``timings.txt`` parsed into average outer and
    inner times and totals,
  * ``timing_histogram``: log-scale bars of seconds per iteration against
    buoy count, beside the reference's published CPU times,
  * ``replot_field``: a saved velocity field (a port checkpoint ``.npz``
    or a dolfin ``.h5``) drawn again.

matplotlib is imported when a figure is drawn (``io/plots.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np

from .io import plots

# the reference's published CPU times per GD iteration
# (plotting/histogram_plotting.py)
REFERENCE_BUOY_COUNTS = [10, 100, 400, 10000]
REFERENCE_ITERATION_TIMES = [0.10, 11.98, 77.82, 1500.0]


def cost_curve_overlay(runs: Dict[str, str], path: str,
                       title: str = r"Reduced cost $j(q)$") -> None:
    """runs: {label: path of a J_array.npy}."""
    plt = plots._pyplot()
    plt.figure()
    plt.xlabel("Iteration")
    plt.ylabel("Cost")
    plt.title(title)
    for label, jpath in runs.items():
        plt.plot(np.load(jpath), label=label)
    plt.legend(loc="best")
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def aggregate_timings(timings_path: str) -> Dict[str, float]:
    """The iteration count, average outer and inner seconds, their totals
    and the total inner iterations of a ``timings.txt``."""
    outer, inner, iters = [], [], []
    with open(timings_path) as fh:
        for line in fh:
            m = re.search(r"outer loop time: ([0-9.eE+-]+)", line)
            if m:
                outer.append(float(m.group(1)))
            m = re.search(r"inner loop time: ([0-9.eE+-]+)", line)
            if m:
                inner.append(float(m.group(1)))
            m = re.search(r"inner loop iterations: (\d+)", line)
            if m:
                iters.append(int(m.group(1)))
    outer_a, inner_a = np.asarray(outer), np.asarray(inner)
    return {
        "iterations": len(outer),
        "avg_outer_time": float(outer_a.mean()) if len(outer) else 0.0,
        "avg_inner_time": float(inner_a.mean()) if len(inner) else 0.0,
        "total_outer_time": float(outer_a.sum()),
        "total_inner_time": float(inner_a.sum()),
        "total_time": float(outer_a.sum() + inner_a.sum()),
        "total_inner_iterations": int(np.sum(iters)) if iters else 0,
    }


def timing_histogram(path: str,
                     buoy_counts: Sequence[int] = None,
                     iteration_times: Sequence[float] = None,
                     compare_reference: bool = True) -> None:
    """Log-scale bars of the average GD-iteration seconds against buoy
    count: the caller's measured times, beside the reference's CPU times
    where ``compare_reference``."""
    plt = plots._pyplot()
    plt.figure()
    counts = list(buoy_counts or REFERENCE_BUOY_COUNTS)
    xs = np.arange(len(counts), dtype=float)
    width = 0.38
    if compare_reference:
        plt.bar(xs - width / 2, REFERENCE_ITERATION_TIMES[:len(counts)],
                width, label="reference (FEniCS, CPU)", color="gray")
        if iteration_times is not None:
            plt.bar(xs + width / 2, iteration_times, width,
                    label="ocean_torch (GPU)", color="tab:blue")
    else:
        plt.bar(xs, iteration_times, width * 2, color="tab:blue")
    plt.yscale("log")
    plt.xticks(xs, [str(c) for c in counts])
    plt.xlabel("number of buoys")
    plt.ylabel("avg time per GD iteration [s]")
    plt.legend(loc="best")
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def replot_field(checkpoint_path: str, out_path: str, nx: int = 32,
                 extent: Tuple[float, float] = (2.0, 2.0),
                 name: str = "u") -> None:
    """Draw a saved velocity field on the Nx square: a port (or JAX)
    ``.npz`` field checkpoint, or a dolfin ``.h5`` checkpoint."""
    from .mesh import rectangle_mesh
    mesh = rectangle_mesh((0.0, 0.0), extent, nx, nx)
    if checkpoint_path.endswith(".h5"):
        from .fem import make_space
        from .io.dolfin_h5 import read_checkpoint_velocity
        u = read_checkpoint_velocity(checkpoint_path, mesh,
                                     make_space(mesh, "cpu"), name)
    else:
        with np.load(checkpoint_path) as data:
            u = data["u"]
    plots.plot_velocity_field(mesh, np.asarray(u[: mesh.num_vertices]),
                              out_path)
