"""Whole runs on the CPU at small sizes: the reference agrees with
ocean_torch on both geometries, the window adds up, the last line has
the contract's shape, no JAX module is loaded, and a run without a card
fails."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import check, harness

from conftest import ROOT, SMALL


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_reference_agrees_with_the_program(small_runs, cell):
    r = small_runs[cell]
    assert r["correct"], r["table"]
    assert r["sample"][0] == 0 and len(r["sample"]) == 3
    assert set(r["table"]) == set(check.NUMBERS)
    for k, (v, lim) in r["table"].items():
        assert v <= lim, k


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_window_adds_up(small_runs, cell):
    w = small_runs[cell]["window"]
    assert sum(w["iteration_times"]) == pytest.approx(w["seconds"])
    assert w["iterations"] == len(w["iteration_times"])
    assert 1 <= len(w["jobs"]) and sum(w["jobs"]) <= w["seconds"] + 1e-9
    assert len(w["inner_iterations"]) <= w["iterations"]
    e = harness.end_to_end(small_runs[cell])
    assert e["iter_s"] == pytest.approx(w["seconds"] / w["iterations"])


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(small_runs, cell, trace):
    spec = harness.benchmark_spec()
    units = {m["name"]: m["unit"]
             for m in harness.end_to_end_metrics(spec, cell)}
    line = json.loads(json.dumps(harness.result_line(
        small_runs[cell], cell, trace, units)))
    assert list(line) == (["correct", "attempted", "failed", "metrics",
                           "device"] + (["breakdown"] if trace else [])
                          + ["check"])
    assert line["attempted"] == 3 and line["failed"] == 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        names = {m["name"] for m in harness.per_layer_metrics(spec, cell)}
        assert set(line["metrics"]) <= names
        assert ("driver.iter_s" if cell == "square_k10.armijo"
                else "linesearch.probes_per_iter") in line["metrics"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == set(units)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for k, (v, lim) in line["check"].items():
        assert isinstance(v, float) and isinstance(lim, (int, float))


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import small_run\n"
        "small_run('lshape_res50.armijo', seconds=0.0)\n"
        "from benchmark import harness\n"
        "print(harness.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_no_program_and_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from benchmark import inputs\n"
        "from benchmark.reference import ocp\n"
        "cfg = {'domain': 'lshape', 'resolution': 4, 'viscosity': 1.0,\n"
        "       't0': 0.0, 'T': 0.1, 'dt': 0.01, 'alpha': 1e-6,\n"
        "       'alpha_buoys': 3, 'initial_control': 'taylor_green',\n"
        "       'starts': {'points': [[0.5, 0.5], [1.5, 0.5], [1.5, 1.5]]},\n"
        "       'ud': {'kind': 'lshape_analytic'}, 'c_armijo': 1e-4,\n"
        "       'tau': 0.5, 'LR_MIN': 1e-6, 'max_line_search_iters': 80}\n"
        "x0, u_d = inputs.make(cfg, {'start_jitter': 0.25}, 3, 'cpu')\n"
        "ref = ocp.Reference(cfg, x0, u_d, 'cpu')\n"
        "ref.iteration(ref.initial_control(), 5.0)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'ocean_torch', 'ocean_jax', 'jax', 'jaxlib',\n"
        "                'flax'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "square_k10000.armijo", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
