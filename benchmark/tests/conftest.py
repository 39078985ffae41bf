"""Small sizes of the cells for runs on the CPU, and one run of each
that several tests read."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "square_k10000.armijo": dict(
        resolution=6, starts={"grid": [[0.1, 0.4, 4], [0.25, 1.75, 4]]},
        alpha_buoys=16, num_steps=8),
    "lshape_res50.armijo": dict(resolution=8, num_steps=8),
    "square_k10.armijo": dict(resolution=8),
}


def small_run(cell, seed=5, seconds=0.5, trace=False, **kw):
    from benchmark import harness
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", overrides=SMALL[cell], **kw)


@pytest.fixture(scope="session")
def small_runs():
    return {cell: small_run(cell, trace=True) for cell in SMALL}
