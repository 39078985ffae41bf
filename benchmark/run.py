"""Run one cell of the benchmark on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, ``breakdown`` when traced, and last ``check``: each number
compared beside its limit, which also ends standard error. Without a card
the run fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    sys.path[0] = ROOT

    import torch
    from benchmark import check, harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    r = harness.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that must not load: {found}", file=sys.stderr)
        return 4
    w = r["window"]
    print(f"window: {w['iterations']} iterations, {len(w['jobs'])} whole "
          f"jobs, {w['seconds']!r} s; first job's probes "
          f"{r['probes_first_job']}; compared iterations {r['sample']}; "
          f"reference {r['reference_s']:.1f} s", file=sys.stderr)
    print(f"first job's J: {r['J_first_job']}", file=sys.stderr)
    ts = sorted(w["iteration_times"])
    print(f"iteration seconds: min {ts[0]!r} median {ts[len(ts) // 2]!r} "
          f"max {ts[-1]!r}; whole jobs {w['jobs']}; set-up by then "
          f"{r['setup_marks']}, build parts {r['setup_parts']}",
          file=sys.stderr)
    if r["trace"] is not None and r["trace"].lu:
        lu = sorted(d for _, _, d in r["trace"].lu)
        print(f"traced LUs: {len(lu)} of order "
              f"{sorted({n for n, _, _ in r['trace'].lu})}, device seconds "
              f"min {lu[0]!r} median {lu[len(lu) // 2]!r} max {lu[-1]!r}",
              file=sys.stderr)
    units = {m["name"]: m["unit"]
             for m in harness.end_to_end_metrics(spec, args.workload)}
    line = harness.result_line(r, args.workload, bool(args.trace), units)
    check.print_table(r["table"], r["correct"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
