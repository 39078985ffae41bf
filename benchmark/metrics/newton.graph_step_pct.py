"""Share of the window's Newton iterations that ran as a replay of the
chord's CUDA graph (``solve/newton.py::ChordGraph``): 100 × the
``graph_steps`` over the ``iterations`` of the ``ns_newton`` records
that the program appends to ``prob.solve_log``. Nothing to read where no
record carries ``graph_steps`` (a program without the graph) or no solve
took a step."""


def read(ctx):
    recs = [r for r in ctx.solve_log
            if r.get("solve") == "ns_newton" and "graph_steps" in r]
    its = sum(r["iterations"] for r in recs)
    return 100.0 * sum(r["graph_steps"] for r in recs) / its if its else None
