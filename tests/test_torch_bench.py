"""``bench_torch.py`` and the port's production scripts
(``scripts/flagship_refresh_torch.py``, ``scripts/lshape_production_torch.py``)
against ``bench.py`` and the JAX scripts.

* The JAX files are read with ``ast``, never imported (``bench.py``'s
  ``_build`` would build a K=10⁴ problem): the configurations, the
  ``dataclasses.replace`` keywords, ``initial_control(case=)``, the
  baselines, the amortized step counts, the arguments, the environment
  variables and the output keys are equal in the port's files. So are the
  records that ``chip_smoke.py``'s path 14 holds the production runs to.
* ``main``, ``stages_main`` and ``multi_k_main`` run on the CPU at Nx=8
  (K=100 for the first two: a K=10⁴ step takes seconds on the CPU), with
  the u_d cache in a temporary directory.
* In a fresh interpreter, the three entry points import neither JAX nor
  the JAX package, and without a card they raise instead of running on
  the CPU.

No JAX program is compiled; about 20 s alone.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

torch.set_num_threads(2)

BENCH, PORT = "bench.py", "bench_torch.py"
FLAGSHIP = ("scripts/flagship_refresh.py",
            "scripts/flagship_refresh_torch.py")
LSHAPE = ("scripts/lshape_production.py",
          "scripts/lshape_production_torch.py")


def _tree(rel: str) -> ast.Module:
    return ast.parse((ROOT / rel).read_text())


def _func(tree, name: str) -> ast.FunctionDef:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise AssertionError(f"no function {name}")


def _calls(node, name: str) -> list:
    """Calls of ``name`` or ``<anything>.name`` under ``node``."""
    out = []
    for c in ast.walk(node):
        if isinstance(c, ast.Call):
            f = c.func
            if (isinstance(f, ast.Name) and f.id == name) or (
                    isinstance(f, ast.Attribute) and f.attr == name):
                out.append(c)
    return out


def _keywords(call: ast.Call, drop=()) -> dict:
    return {k.arg: ast.dump(k.value) for k in call.keywords
            if k.arg is not None and k.arg not in drop}


def _assigned(node, name: str):
    """The value assigned to the plain name ``name`` under ``node``."""
    for a in ast.walk(node):
        if isinstance(a, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in a.targets):
            return a.value
    raise AssertionError(f"no assignment to {name}")


def _keys(d: ast.Dict) -> list:
    return [ast.literal_eval(k) for k in d.keys]


def _one(calls: list) -> ast.Call:
    assert len(calls) == 1, [ast.dump(c) for c in calls]
    return calls[0]


# --- (a) the port's files against the JAX files ------------------------------

def test_build_is_bench_build():
    """``_build``: the same OCPConfig, the same ``dataclasses.replace`` of
    the problem and the same initial control."""
    jax_b, port_b = _func(_tree(BENCH), "_build"), _func(_tree(PORT),
                                                         "_build")
    assert (_keywords(_one(_calls(port_b, "OCPConfig")))
            == _keywords(_one(_calls(jax_b, "OCPConfig"))))

    def replace_of_prob(fn):
        return _one([c for c in _calls(fn, "replace")
                     if isinstance(c.args[0], ast.Name)
                     and c.args[0].id == "prob"])
    assert (_keywords(replace_of_prob(port_b))
            == _keywords(replace_of_prob(jax_b)) == {
                "newton_reuse_lu": ast.dump(ast.Constant(True))})
    assert (_keywords(_one(_calls(port_b, "initial_control")))
            == _keywords(_one(_calls(jax_b, "initial_control"))))
    assert [a.arg for a in jax_b.args.args] == [
        a.arg for a in port_b.args.args][:1]


@pytest.mark.parametrize("name", ["BASELINE_SECONDS", "K_EXPERIMENT",
                                  "K_BASELINES", "AMORTIZE"])
def test_constants_are_bench_constants(name):
    got = ast.literal_eval(_assigned(_tree(PORT), name))
    assert got == ast.literal_eval(_assigned(_tree(BENCH), name))
    assert getattr(bench_torch, name) == got


def _headline_keys(tree):
    main = _func(tree, "main")
    return [_keys(d) for d in ast.walk(main) if isinstance(d, ast.Dict)
            and "metric" in _keys(d)]


def _multi_k_keys(tree):
    fn = _func(tree, "multi_k_main")
    cell = _keys(_assigned(fn, "cell"))
    for c in _calls(fn, "update"):
        cell += _keys(c.args[0])
    metrics = [_keys(d) for d in ast.walk(fn) if isinstance(d, ast.Dict)
               and "metric" in _keys(d)]
    return cell, metrics


def _summary_keys(tree):
    fn = _func(tree, "main")
    keys = _keys(_assigned(fn, "summary"))
    for a in ast.walk(fn):
        if isinstance(a, ast.Assign) and isinstance(a.targets[0],
                                                    ast.Subscript):
            t = a.targets[0]
            if isinstance(t.value, ast.Name) and t.value.id == "summary":
                keys.append(ast.literal_eval(t.slice))
    config = _keys(_keys_value(_assigned(fn, "summary"), "config"))
    return keys, config


def _keys_value(d: ast.Dict, key: str):
    return d.values[_keys(d).index(key)]


@pytest.mark.parametrize("what", ["headline", "stages", "stages_out",
                                  "multi_k", "flagship_summary"])
def test_output_keys_are_the_jax_keys(what):
    if what == "headline":
        get, files = _headline_keys, (BENCH, PORT)
    elif what == "stages":
        get = lambda t: _keys(_assigned(_func(t, "stages_main"), "stages"))
        files = (BENCH, PORT)
    elif what == "stages_out":
        get = lambda t: _keys(_assigned(_func(t, "stages_main"), "out"))
        files = (BENCH, PORT)
    elif what == "multi_k":
        get, files = _multi_k_keys, (BENCH, PORT)
    else:
        get, files = _summary_keys, FLAGSHIP
    jax_keys, port_keys = get(_tree(files[0])), get(_tree(files[1]))
    assert port_keys == jax_keys


def _arguments(tree) -> dict:
    """``--name`` → the keywords of its ``add_argument``."""
    return {c.args[0].value: _keywords(c)
            for c in _calls(tree, "add_argument")}


def test_flagship_script_is_the_jax_script():
    jax_t, port_t = _tree(FLAGSHIP[0]), _tree(FLAGSHIP[1])
    assert (_keywords(_one(_calls(port_t, "OCPConfig")), drop=("out_dir",))
            == _keywords(_one(_calls(jax_t, "OCPConfig")),
                         drop=("out_dir",)))
    jax_run = _keywords(_one(_calls(jax_t, "run")))
    port_run = _keywords(_one(_calls(port_t, "run")))
    assert {k: port_run[k] for k in jax_run} == jax_run
    jax_args, port_args = _arguments(jax_t), _arguments(port_t)
    assert set(port_args) == set(jax_args) | {"--device"}
    assert port_args["--iters"] == jax_args["--iters"]
    assert ast.literal_eval(_assigned(jax_t, "OUT")) == "results/flagship_10k"
    assert "flagship_10k_torch" in ast.dump(_assigned(port_t, "OUT"))


def test_lshape_script_is_the_jax_script():
    jax_t, port_t = _tree(LSHAPE[0]), _tree(LSHAPE[1])
    jax_cfg = _keywords(_one(_calls(jax_t, "OCPConfig")), drop=("out_dir",))
    assert (_keywords(_one(_calls(port_t, "OCPConfig")), drop=("out_dir",))
            == jax_cfg)
    # LSHAPE_STEPS, default 30
    assert "Constant(value='LSHAPE_STEPS'), Constant(value='30')" in (
        jax_cfg["num_steps"])
    jax_run = _keywords(_one(_calls(jax_t, "run")))
    port_run = _keywords(_one(_calls(port_t, "run")))
    assert {k: port_run[k] for k in jax_run} == jax_run
    assert set(_arguments(port_t)) == {"--out", "--device"}


def _timings_probes(path: Path) -> tuple:
    return tuple(int(line.split(":")[1])
                 for line in path.read_text().splitlines()
                 if "inner loop iterations" in line)


@pytest.mark.parametrize("record", ["flagship_10k", "lshape_res50"])
def test_chip_smoke_holds_the_records(record):
    """The J and probe counts that ``chip_smoke.py``'s path 14 holds the
    production runs to are the records' files; its key lists are
    ``bench.py``'s."""
    smoke = _tree("chip_smoke.py")
    tag = "FLAGSHIP" if record == "flagship_10k" else "LSHAPE"
    j = ast.literal_eval(_assigned(smoke, f"{tag}_J"))
    probes = ast.literal_eval(_assigned(smoke, f"{tag}_PROBES"))
    base = ROOT / "results" / record
    assert np.array_equal(np.asarray(j), np.load(base / "J_array.npy"))
    assert probes == _timings_probes(base / "timings.txt")
    bench = _tree(BENCH)
    assert list(ast.literal_eval(_assigned(smoke, "STAGE_KEYS"))) == _keys(
        _assigned(_func(bench, "stages_main"), "stages"))
    assert list(ast.literal_eval(_assigned(smoke, "STAGES_OUT_KEYS"))) == (
        _keys(_assigned(_func(bench, "stages_main"), "out")))
    assert [list(ast.literal_eval(_assigned(smoke, "BENCH_KEYS")))] == (
        _headline_keys(bench))


# --- (b) the three modes on the CPU at Nx=8 ----------------------------------

SMALL = dict(unit_square_resolution=8)


@pytest.fixture(scope="module")
def ud_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ud_torch"))


@pytest.fixture
def bench(ud_cache, monkeypatch):
    monkeypatch.setattr(bench_torch, "UD_CACHE", ud_cache)
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.delenv("BENCH_PROFILE_DIR", raising=False)
    return bench_torch


def _finite(*xs) -> bool:
    return all(math.isfinite(x) for x in xs)


def test_main_prints_the_headline(bench, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_PROFILE_DIR", str(tmp_path / "trace"))
    rec, res = bench.main(device="cpu", ud_experiment="100_buoys", **SMALL)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rec
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "gd_iteration_seconds_10000_buoys"
    assert rec["unit"] == "s" and rec["value"] > 0
    assert rec["vs_baseline"] == 1500.0 / rec["value"]
    assert res.fwd.u_values.shape == (100, 200, 2)
    assert _finite(float(res.J)) and not res.diverged
    trace = json.loads((tmp_path / "trace" /
                        "bench_torch_trace.json").read_text())
    assert trace["traceEvents"]


def test_stages_writes_the_stage_record(bench, tmp_path):
    out = bench.stages_main(str(tmp_path), device="cpu",
                            ud_experiment="100_buoys", **SMALL)
    assert json.loads((tmp_path / "stages.json").read_text()) == out
    assert list(out) == ["K", "ndof", "backend", "stages_seconds",
                         "stages_sum_seconds",
                         "full_fused_gd_iteration_seconds", "lu_tflops_est",
                         "note"]
    assert list(out["stages_seconds"]) == [
        "ns_newton_solve", "primal_ode_scan", "gradu_projection",
        "adjoint_ode", "point_sources", "adjoint_assemble_solve",
        "micro_eval_p1_tensor_2e6pts", "micro_eval_velocity_2e6pts"]
    assert out["K"] == 100 and out["ndof"] == 659 and out["backend"] == "cpu"
    secs = list(out["stages_seconds"].values())
    assert _finite(*secs, out["full_fused_gd_iteration_seconds"],
                   out["lu_tflops_est"]) and min(secs) > 0
    assert out["stages_sum_seconds"] == sum(secs)
    n = out["ndof"]
    assert out["lu_tflops_est"] == pytest.approx(
        (2.0 / 3.0) * n ** 3 / out["stages_seconds"]["adjoint_assemble_solve"]
        / 1e12, rel=1e-15)


def test_multi_k_amortized_equals_the_host_loop(bench, tmp_path, capsys):
    cells = {"10_buoys": 0.10, "100_buoys": 11.98}
    got = bench.multi_k_main(str(tmp_path), device="cpu", cells=cells,
                             amortize={"10_buoys": 2, "100_buoys": 2},
                             **SMALL)
    assert json.loads((tmp_path / "multi_k.json").read_text()) == got
    assert list(got) == list(cells)
    for k_exp, cell in got.items():
        assert list(cell) == ["seconds", "baseline_seconds", "vs_baseline",
                              "seconds_amortized", "amortized_steps",
                              "vs_baseline_amortized",
                              "scan_vs_host_J_max_rel_diff_3it"]
        assert cell["baseline_seconds"] == cells[k_exp]
        assert cell["vs_baseline"] == cells[k_exp] / cell["seconds"]
        assert cell["amortized_steps"] == 2
        assert cell["scan_vs_host_J_max_rel_diff_3it"] == 0.0
    metrics = [json.loads(line)["metric"]
               for line in capsys.readouterr().out.strip().splitlines()]
    assert metrics == ["gd_iteration_seconds_10_buoys_amortized2",
                       "gd_iteration_seconds_10_buoys",
                       "gd_iteration_seconds_100_buoys_amortized2",
                       "gd_iteration_seconds_100_buoys"]


# --- (c) no JAX, and the card by default --------------------------------------

NO_JAX_NEED_CARD = r"""
import os, sys
root, out = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, os.path.join(root, "scripts")]
import bench_torch, flagship_refresh_torch, lshape_production_torch

def jax_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ocean_jax",
                                         "bench", "flagship_refresh",
                                         "lshape_production"))

assert not jax_modules(), jax_modules()
calls = [bench_torch.main, lambda: bench_torch.stages_main(out),
         lambda: bench_torch.multi_k_main(out),
         lambda: flagship_refresh_torch.main(["--out", out]),
         lambda: lshape_production_torch.main(["--out", out])]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("ran without a card")
assert not os.path.exists(out), os.listdir(out)
assert not jax_modules(), jax_modules()
print("ok")
"""


def test_entry_points_import_no_jax_and_need_the_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", NO_JAX_NEED_CARD, str(ROOT),
         str(tmp_path / "out")], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
