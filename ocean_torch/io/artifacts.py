"""Run-artifact writers (own copy of ``ocean_jax/io/artifacts.py``, which
imports no JAX but belongs to the JAX package).

The directory layout and the text and array artifacts of the reference's
``OCP_dolfin.py``, in its formats: ``variables.txt``, ``timings.txt``,
``u_divergence.txt``, ``J_array.npy``, ``norm_table.txt``, the grad-check
tables and the folder tree created at startup. File names, keys and
formats equal the JAX package's, so the reference's plotting scripts
parse either.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np


class RunDirectory:
    """The reference's output tree (``OCP_dolfin.py:50-61``)."""

    SUBDIRS = ("buoy_movements", "buoy_movements/frames", "flow_fields",
               "paraview", "paraview/checkpoint", "checkpoints", "q_backup")

    def __init__(self, base: str):
        self.base = base
        os.makedirs(base, exist_ok=True)
        for sub in self.SUBDIRS:
            os.makedirs(os.path.join(base, sub), exist_ok=True)

    def path(self, *parts: str) -> str:
        return os.path.join(self.base, *parts)


def write_variables(path: str, nx: int, ud_type: str, t0, T, dt, viscosity,
                    K, LR, LR_MAX, LR_MIN, conv_crit, num_steps) -> None:
    """``variables.txt`` with the reference's exact keys/format
    (``OCP_dolfin.py:495-507``)."""
    with open(path, "w") as fh:
        fh.write("mesh resolution: %s \n" % nx)
        fh.write("ud type: %s \n" % ud_type)
        fh.write("t0: %s \n" % t0)
        fh.write("T: %s \n" % T)
        fh.write("dt: %s \n" % dt)
        fh.write("viscosity: %s \n" % viscosity)
        fh.write("buoy count: %s \n" % K)
        fh.write("LR: %s \n" % LR)
        fh.write("LR_MAX: %s \n" % LR_MAX)
        fh.write("LR_MIN: %s \n" % LR_MIN)
        fh.write("conv. crit.: %s \n" % conv_crit)
        fh.write("gradient descent steps: %s \n" % num_steps)


def write_timings(path: str, outer: Sequence[float], inner: Sequence[float],
                  inner_iters: Sequence[int]) -> None:
    """``timings.txt`` (``OCP_dolfin.py:476-482``) — same format, so the
    reference's ``plotting/timing_calculations.py`` parses it unchanged."""
    with open(path, "w") as fh:
        for k, it in enumerate(inner_iters):
            fh.write(f"Iteration {k}:\n")
            fh.write(f"  outer loop time: {outer[k]:.6f} seconds\n")
            fh.write(f"  inner loop time: {inner[k]:.6f} seconds\n")
            fh.write(f"  inner loop iterations: {it}\n")
            fh.write("-" * 40 + "\n")


def write_divergence(path: str, divs: Sequence[float]) -> None:
    """``u_divergence.txt`` (``OCP_dolfin.py:489-492``; header repeated per
    row exactly as the reference does)."""
    with open(path, "w") as fh:
        for i, d in enumerate(divs):
            fh.write("div(u) \t \t \t i  \n")
            fh.write(f" {d} \t {i} \n")


def write_norms(path: str, l2: float, h1: float) -> None:
    with open(path, "w") as fh:
        fh.write("L2: %s \n" % l2)
        fh.write("H1: %s \n" % h1)


def write_norm_table(path: str, l2: float, h1: float) -> None:
    """``norm_table.txt`` (``initial_control_test.py:455-457``,
    ``Pipeline_limits.py:440-443``)."""
    with open(path, "w") as fh:
        fh.write("l2 \t \t \t h1  \n")
        fh.write(f" {l2} \t {h1} \n")


def write_grad_table(path: str, gradj: float,
                     rows: Iterable[tuple]) -> None:
    """``grad_J_error_{i}.txt`` (``OCP_dolfin.py:269-277``). rows:
    (gradapprox, error, h)."""
    with open(path, "w") as fh:
        fh.write("reduced Gradient j \t \t approximated gradient J \t "
                 "Error \t \t \t h_i \n")
        for ga, err, h in rows:
            fh.write(f" {gradj} \t {ga} \t {err} \t {h} \n")


def save_j_array(path: str, j_array: Sequence[float]) -> None:
    with open(path, "wb") as fh:
        np.save(fh, np.asarray(j_array))
