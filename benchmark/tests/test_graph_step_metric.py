"""``newton.graph_step_pct`` on synthetic solve logs: all steps replayed,
some, none recorded, and a program that records no ``graph_steps``."""

from types import SimpleNamespace

import pytest

from benchmark import harness


def _ns(iterations, graph_steps=None):
    rec = {"solve": "ns_newton", "iterations": iterations}
    if graph_steps is not None:
        rec["graph_steps"] = graph_steps
    return rec


RUNG = {"solve": "ns_rung", "iterations": 7}
ADJOINT = {"solve": "adjoint", "rounds": 3}


@pytest.mark.parametrize("log,want", [
    ([_ns(5, 5), _ns(4, 4), RUNG, ADJOINT], 100.0),
    ([_ns(5, 5), _ns(3, 0), ADJOINT], 62.5),
    ([_ns(5, 0), _ns(2, 0)], 0.0),
    ([_ns(0, 0), _ns(4, 1)], 25.0),
    ([], None),
    ([RUNG, ADJOINT], None),
    ([_ns(0, 0)], None),
    ([_ns(5), _ns(4)], None),
], ids=["all", "mixed", "none_replayed", "no_steps_in_one", "empty",
        "no_ns_newton", "no_steps", "no_graph_steps"])
def test_graph_step_pct(log, want):
    read = harness.load_metric("newton.graph_step_pct").read
    assert read(SimpleNamespace(solve_log=log)) == want


def test_it_is_read_in_the_square_cell_only():
    spec = harness.benchmark_spec()
    cells = [w["name"] for w in spec["workloads"]
             if "newton.graph_step_pct" in
             {m["name"] for m in harness.per_layer_metrics(spec, w["name"])}]
    assert cells == ["square_k10000.armijo"]
