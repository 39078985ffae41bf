"""Newton iterations a primal solve: the mean of the ``ns_newton``
records the program appends to ``prob.solve_log`` during the window."""


def read(ctx):
    its = [r["iterations"] for r in ctx.solve_log
           if r.get("solve") == "ns_newton"]
    return sum(its) / len(its) if its else None
