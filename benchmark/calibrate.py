"""The readings that the limits of ``correct`` are set from, on the card.

For each seed, in one process: the cell's set-up and one whole job with
the comparison (a window of 0 seconds runs until the first job ends),
and for the seeds given to ``--control`` also the lower-precision
control, the reference in float32 put in the program's place. Prints one
JSON line a seed and, last, the largest program reading and the smallest
control reading of each number. The benchmark's own runs never run it.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...
                                   [--control 1 2 3]
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0] = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    from benchmark import check, harness
    lower, upper = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, 0.0, False, t0,
                             control=seed in args.control)
        row = {"seed": seed, "program": r["numbers"],
               "probes": r["probes_first_job"], "J": r["J_first_job"][:3],
               "iterations": r["sample"], "seconds": time.perf_counter() - t0}
        for k in check.NUMBERS:
            lower[k] = max(lower.get(k, 0.0), r["numbers"][k])
        if "control_numbers" in r:
            row["control"] = r["control_numbers"]
            for k in check.NUMBERS:
                upper[k] = min(upper.get(k, math.inf),
                               r["control_numbers"][k])
        print(json.dumps(row), flush=True)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
