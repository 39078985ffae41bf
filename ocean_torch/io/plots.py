"""Matplotlib figure set (port of ``ocean_jax/io/plots.py``), the
reference's plots:

  * the mesh with the Γ₁/Γ₂ boundary coloured,
  * per-iteration and final flow fields,
  * the cost curve J,
  * buoy trajectories against the desired ones,
  * per-buoy velocity against u_d.

Figures are a byproduct on the host, not the compute path: every function
takes numpy arrays and draws with the Agg backend. matplotlib is imported
when a figure is drawn, never when this module is imported; the
pipelines ask ``available()`` first and, without matplotlib, skip the
figures and write everything else.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..mesh.structured import Mesh2D

SKIP_LINE = "figures skipped: matplotlib is not installed"


def available() -> bool:
    """Whether matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _mesh_boundary_lines(l_shape: bool):
    """The hand-drawn boundary segments, the Γ₁ and the Γ₂ segment ids."""
    if l_shape:
        return ([[[0.0, 2.0], [0.0, 0.0]], [[0.0, 0.0], [0.0, 1.0]],
                 [[0.0, 1.0], [1.0, 1.0]], [[1.0, 1.0], [1.0, 2.0]],
                 [[1.0, 2.0], [2.0, 2.0]], [[2.0, 2.0], [2.0, 0.0]]],
                [1, 4], [0, 2, 3, 5])
    return ([[[0.0, 2.0], [0.0, 0.0]], [[0.0, 0.0], [0.0, 2.0]],
             [[0.0, 2.0], [2.0, 2.0]], [[2.0, 2.0], [2.0, 0.0]]],
            [1, 3], [0, 2])


def plot_mesh(mesh: Mesh2D, path: str, l_shape: bool = False) -> None:
    plt = _pyplot()
    plt.figure()
    plt.title(r"discretized domain $\Omega_h$")
    plt.xlabel(r"$x$")
    plt.ylabel(r"$y$")
    plt.triplot(mesh.vertices[:, 0], mesh.vertices[:, 1], mesh.cells,
                lw=0.3, color="tab:blue")
    lines, g1, g2 = _mesh_boundary_lines(l_shape)
    for i, line in enumerate(lines):
        color = "orange" if i in g1 else "blue"
        label = (r"$\Gamma_1$" if i == g1[0]
                 else (r"$\Gamma_2$" if i == g2[0] else None))
        plt.plot(line[0], line[1], color=color, label=label)
    plt.legend(loc="best", bbox_to_anchor=(1.02, 1))
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def plot_velocity_field(mesh: Mesh2D, u_vertex: np.ndarray, path: str,
                        title: str = r"Velocity field $u$") -> None:
    """Quiver coloured by magnitude; u_vertex: (nv, 2) vertex values."""
    plt = _pyplot()
    plt.figure()
    mag = np.linalg.norm(u_vertex, axis=1)
    q = plt.quiver(mesh.vertices[:, 0], mesh.vertices[:, 1],
                   u_vertex[:, 0], u_vertex[:, 1], mag)
    plt.colorbar(q)
    plt.title(title)
    plt.xlabel(r"$x$")
    plt.ylabel(r"$y$")
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def plot_cost(j_array: Sequence[float], path: str) -> None:
    plt = _pyplot()
    plt.figure()
    plt.xlabel(r"Iteration")
    plt.ylabel(r"Cost")
    plt.title(r"Reduced cost $j(q)$")
    plt.plot(np.asarray(j_array), color="black")
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def _dotted(k: int):
    base = k + 1
    return (0, (base, base // 2))


def plot_buoy_movement(x: np.ndarray, x_d: Optional[np.ndarray],
                       seeds: np.ndarray, path: str,
                       l_shape: bool = False) -> None:
    """Trajectory overlay. x: (K, nt, 2); x_d: (K, nt, 2) desired
    trajectories or None. At most 30 buoys are drawn."""
    plt = _pyplot()
    plt.figure()
    plt.xlabel(r"$x$")
    plt.ylabel(r"$y$")
    plt.title(r"Buoy movement result")
    K = x.shape[0]
    ax = plt.gca()
    ax.set_aspect("equal", adjustable="box")
    for i in range(min(K, 30)):
        plt.scatter(seeds[i, 0], seeds[i, 1], color="red", zorder=5)
        if K <= 10:
            plt.text(seeds[i, 0], seeds[i, 1] + 0.1, rf"$x_{i+1}(0)$",
                     ha="center", va="center")
        if x_d is not None:
            plt.plot(x_d[i, :, 0], x_d[i, :, 1],
                     label=r"$x_d$" if i == 0 else "", color="black",
                     alpha=0.5)
        plt.plot(x[i, :, 0], x[i, :, 1], label=rf"$x_{i+1}$" if K <= 10
                 else None, color="b", linestyle=_dotted(i + 1))
    lines, _, _ = _mesh_boundary_lines(l_shape)
    for line in lines:
        plt.plot(line[0], line[1], color="gray")
    if K <= 10:
        plt.legend(loc="best", bbox_to_anchor=(1.02, 1))
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def plot_velocity_comparison(time_interval: np.ndarray, u_d: np.ndarray,
                             u_values: np.ndarray, k: int,
                             path: str) -> None:
    """Buoy k's velocity against u_d over time."""
    plt = _pyplot()
    plt.figure()
    plt.title(rf"Velocity comparison for buoy k={k + 1}")
    plt.xlabel("Time")
    plt.ylabel("Velocity")
    ls = _dotted(k + 1)
    plt.plot(time_interval, u_d[k, :, 0], label=r"$u_{d,1}$",
             color="black", alpha=0.8)
    plt.plot(time_interval, u_d[k, :, 1], label=r"$u_{d,2}$",
             color="black", alpha=0.8)
    plt.plot(time_interval, u_values[k, :, 0], label=r"$u_{1}$",
             linestyle=ls, color="b")
    plt.plot(time_interval, u_values[k, :, 1], label=r"$u_{2}$",
             linestyle=ls, color="b")
    plt.legend(loc="best")
    plt.savefig(path, bbox_inches="tight")
    plt.close()
