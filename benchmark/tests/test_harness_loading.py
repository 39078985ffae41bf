"""Cells, configurations, traffic and per-layer metrics are found by
name, and a new cell and metric come in as new files alone."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

from conftest import ROOT


def test_every_cell_of_the_benchmark_loads():
    spec = harness.benchmark_spec()
    names = [w["name"] for w in spec["workloads"]]
    assert sorted(names) == harness.cell_names()
    for w in spec["workloads"]:
        cell, cfg, traffic = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] == cfg["name"]
        assert cell["traffic"] == w["traffic"]
        assert set(cell["limits"]) == set(
            __import__("benchmark.check").check.NUMBERS)
        assert traffic["clients"] == 1


def test_every_configuration_file_is_named_in_the_spec():
    spec = harness.benchmark_spec()
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]


def test_every_per_layer_metric_has_a_reader():
    spec = harness.benchmark_spec()
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        for c in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in
                                  harness.end_to_end_metrics(spec, c)}


def test_metrics_are_listed_per_cell():
    spec = harness.benchmark_spec()
    sq = {m["name"] for m in harness.per_layer_metrics(
        spec, "square_k10000.armijo")}
    ls = {m["name"] for m in harness.per_layer_metrics(
        spec, "lshape_res50.armijo")}
    assert "kernels.roofline_pct" in sq - ls
    assert "linalg.lu_roofline_pct" in ls - sq
    k10 = {m["name"] for m in harness.end_to_end_metrics(
        spec, "square_k10.armijo")}
    assert k10 == {"peak_mem_gib", "setup_s"}


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell and a metric by new files and
    new entries of BENCHMARK.json; the harness there lists and loads
    them, and no file that was there is edited."""
    dst = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    before = {p: p.read_bytes() for p in (dst / "benchmark").rglob("*")
              if p.is_file()}
    (dst / "benchmark/workloads/square_k10000.steady.json").write_text(
        json.dumps({"config": "square_k10000", "traffic": "steady",
                    "limits": {}}))
    (dst / "benchmark/traffic/steady.json").write_text(
        json.dumps({"loop": "closed", "clients": 1, "start_jitter": 0.0,
                    "warmup_iterations": 2,
                    "check": {"drawn": 1, "drawn_from": [1, 2]}}))
    (dst / "benchmark/metrics/loop.jobs.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window['jobs']))\n")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "square_k10000.steady",
                              "config": "square_k10000",
                              "traffic": "steady", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "loop.jobs", "unit": "jobs",
                              "better": "higher",
                              "source": "program_counter", "layer": "d",
                              "moves": "solve_s",
                              "workloads": ["square_k10000.steady"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import harness\n"
        "spec = harness.benchmark_spec()\n"
        "print(harness.cell_names())\n"
        "cell, cfg, tr = harness.load_cell('square_k10000.steady')\n"
        "print(cfg['name'], tr['start_jitter'])\n"
        "ms = [m['name'] for m in harness.per_layer_metrics(\n"
        "    spec, 'square_k10000.steady')]\n"
        "print(ms)\n"
        "class C: window = {'jobs': [1.0, 2.0]}\n"
        "print(harness.load_metric('loop.jobs').read(C))\n")
    out = subprocess.run([sys.executable, "-c", code, str(dst)],
                         capture_output=True, text=True, check=True).stdout
    lines = out.strip().splitlines()
    assert "square_k10000.steady" in lines[0]
    assert lines[1] == "square_k10000 0.0"
    assert lines[2] == "['loop.jobs']"
    assert lines[3] == "2.0"
    for p, data in before.items():
        assert p.read_bytes() == data
