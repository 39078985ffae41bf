"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a cell is found by name: the cell's file
``workloads/<cell>.json`` names its configuration (``configs/``) and its
traffic (``traffic/``) and holds the limits of its comparison; each
per-layer metric that ``BENCHMARK.json`` lists for the cell is read by
``metrics/<metric>.py``.

A job is one whole optimisation, ``run_gradient_descent`` from the
initial control to the GD loop's exit. The window runs jobs back to back
(a closed loop, one client) and ends at the first iteration boundary
after ``seconds``, cutting the job in flight; if no job has ended by
then, it runs on until the first one does.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Optional

import torch

from . import check, inputs, tracing
from .reference.ocp import Reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ocean_jax")


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fh:
        return json.load(fh)


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_names() -> list:
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "workloads"))
                  if f.endswith(".json"))


def load_cell(name: str, overrides: Optional[dict] = None):
    """(cell, configuration, traffic); ``overrides`` replace keys of the
    configuration (the tests' small sizes)."""
    cell = load("workloads", name)
    cfg = dict(load("configs", cell["config"]), **(overrides or {}))
    return cell, cfg, load("traffic", cell["traffic"])


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _of_cell(metrics: list, spec: dict, cell: str) -> list:
    return [m for m in metrics
            if cell in m.get("workloads", [w["name"]
                                           for w in spec["workloads"]])]


def per_layer_metrics(spec: dict, cell: str) -> list:
    return _of_cell(spec["per_layer"], spec, cell)


def end_to_end_metrics(spec: dict, cell: str) -> list:
    return _of_cell(spec["end_to_end"], spec, cell)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def port_config(cfg: dict):
    """The system's own configuration object for a benchmark
    configuration."""
    from ocean_torch.config import OCPConfig
    square = cfg["domain"] == "square"
    return OCPConfig(
        viscosity=cfg["viscosity"], t0=cfg["t0"], T=cfg["T"], dt=cfg["dt"],
        alpha=cfg["alpha"], ud_experiment=f"{cfg['alpha_buoys']}_buoys",
        num_steps=cfg["num_steps"], L_shape=not square,
        L_shape_resolution=cfg["resolution"],
        unit_square_resolution=cfg["resolution"], use_line_search=True,
        tau=cfg["tau"], c_armijo=cfg["c_armijo"], LR_MIN=cfg["LR_MIN"],
        LR_MAX=cfg["LR"], LR=cfg["LR"], conv_crit=cfg["conv_crit"],
        max_line_search_iters=cfg["max_line_search_iters"],
        newton_continuation=cfg.get("continuation", 0), **cfg["program"])


class _StopWindow(Exception):
    pass


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""
    cell: str
    cfg: dict
    K: int
    window: dict
    solve_log: list
    setup_seconds: dict
    trace: Optional[tracing.Trace]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", overrides: Optional[dict] = None,
             control: bool = False, on_problem=None) -> dict:
    """Run a cell and return the result's fields. ``control=True`` also
    computes the lower-precision control's numbers (``calibrate.py``);
    ``on_problem(prob)`` may break the program under test (the tests'
    planted faults)."""
    from ocean_torch import system
    from ocean_torch.opt.driver import run_gradient_descent

    cell, cfg, traffic = load_cell(name, overrides)
    dev = torch.device(device)
    marks = {"imports": time.perf_counter() - t_start}
    x0, u_d = inputs.make(cfg, traffic, seed, dev)
    _sync(dev)
    marks["inputs"] = time.perf_counter() - t_start
    pcfg = port_config(cfg)
    prob = system.build_problem(pcfg, u_d=u_d, x0=x0, device=dev)
    marks["build"] = time.perf_counter() - t_start
    log = []
    prob = dataclasses.replace(prob, solve_log=log)
    if on_problem is not None:
        on_problem(prob)
    f0 = system.initial_control(prob, cfg["program_initial_case"])
    threshold = cfg.get("escape_threshold")

    def job(cfg_, hook):
        return run_gradient_descent(cfg_, prob, f0, escape_threshold=threshold,
                                    on_iteration=hook, grad_check_dir=None,
                                    verbose=False)

    # warm-up: iteration 0 with its probes and one later iteration
    job(dataclasses.replace(pcfg, num_steps=traffic["warmup_iterations"]),
        None)
    sample = check.draw_iterations(seed, traffic)
    cap = check.Capture(system, sample)
    _sync(dev)
    log.clear()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start

    times, inner, jobs = [], [], []
    state = {"prev": t_w0, "job_start": t_w0}

    def hook(i, f, fwd, z, j_array):
        _sync(dev)
        now = time.perf_counter()
        times.append(now - state["prev"])
        state["prev"] = now
        cap.on_iteration(i, f, fwd, z, j_array)
        if now - t_w0 >= seconds and jobs:
            raise _StopWindow

    prof = traced = None
    spans = tracing.Spans(system) if trace else None
    while True:
        first = not jobs and state["prev"] == t_w0
        if first:
            cap.start(f0.quad)
        if first and trace:
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(
                activities=[act.CUDA if dev.type == "cuda" else act.CPU])
            prof.start()
            wall0, t_p0 = time.time_ns(), time.perf_counter()
            spans.active = True
        try:
            res = job(pcfg, hook)
        except _StopWindow:
            break
        finally:
            cap.stop()
            if prof is not None and traced is None:
                _sync(dev)
                traced = time.perf_counter() - t_p0
                spans.active = False
                prof.stop()
        if not jobs:
            first_probes = list(res.inner_iterations)
        jobs.append(state["prev"] - state["job_start"])
        inner.extend(res.inner_iterations)
        state["job_start"] = state["prev"]
        if state["prev"] - t_w0 >= seconds:
            break
    _sync(dev)
    t_end = state["prev"]
    n_iter = len(times)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    setup_parts = dict(prob.setup_seconds)
    if spans is not None:
        spans.restore()
    cap.restore()

    window = {"seconds": t_end - t_w0, "iterations": n_iter,
              "iteration_times": times, "jobs": jobs,
              "inner_iterations": inner}
    trace_obj = (tracing.read(prof, spans, traced, wall0)
                 if prof is not None else None)
    del prof, spans

    # the program's state goes before the reference runs
    prog = check.program_readings(cap, cfg)
    n_p2 = prob.space.n_p2
    j_first = cap.j
    del prob, f0, cap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = Reference(cfg, x0, u_d, dev)
    ref_out = check.reference_readings(ref, prog)
    gaps = check.compare(prog, ref_out, n_p2, sample)
    numbers = check.worst(gaps)
    correct, table = check.judge(numbers, cell["limits"])
    out = {"correct": correct, "table": table, "numbers": numbers,
           "failed": check.failed_iterations(gaps, cell["limits"]),
           "sample": sample, "reference_s": time.perf_counter() - t_ref,
           "setup_s": setup_s, "peak_bytes": peak, "window": window,
           "solve_log": log, "setup_parts": setup_parts,
           "trace": trace_obj, "cell": cell, "cfg": cfg, "K": len(x0),
           "probes_first_job": first_probes,
           "J_first_job": j_first, "setup_marks": marks}
    if control:
        low = check.lower_precision(Reference, cfg, x0, u_d, dev, prog)
        out["control_numbers"] = check.worst(check.compare(low, ref_out,
                                                           n_p2, sample))
    return out


def window_times(w: dict) -> dict:
    """The window's timings on the host clock: seconds an iteration over
    all of it, the 90th percentile of the iterations' own times, seconds
    a whole job."""
    return {
        "iter_s": w["seconds"] / w["iterations"],
        "iter_p90_s": statistics.quantiles(w["iteration_times"], n=10,
                                           method="inclusive")[8],
        "solve_s": sum(w["jobs"]) / len(w["jobs"]),
    }


def end_to_end(r: dict) -> dict:
    return dict(window_times(r["window"]),
                peak_mem_gib=r["peak_bytes"] / 2 ** 30,
                setup_s=r["setup_s"])


def result_line(r: dict, name: str, trace: bool, units: dict) -> dict:
    """The contract's last line."""
    if trace:
        spec = benchmark_spec()
        ctx = Context(name, r["cfg"], r["K"], r["window"], r["solve_log"],
                      r["setup_parts"], r["trace"])
        metrics = {}
        for m in per_layer_metrics(spec, name):
            v = load_metric(m["name"]).read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in end_to_end(r).items() if k in units}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu",
           "count": 1, "memory_peak_bytes": r["peak_bytes"]}
    line = {"correct": r["correct"], "attempted": len(r["sample"]),
            "failed": r["failed"], "metrics": metrics,
            "device": dev}
    if trace and r["trace"] is not None:
        tr = r["trace"]
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        line["breakdown"] = tracing.breakdown(tr)
    line["check"] = r["table"]
    return line
