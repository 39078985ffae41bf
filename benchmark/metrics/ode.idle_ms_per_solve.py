"""Device idle a primal ODE solve: milliseconds in which no device
operation ran inside the program's ``primal_ode`` spans of the traced
job (``system._primal_ode``), over their number."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.idle_ms(ctx, "primal_ode")
    return None if got is None else got[0] / len(got[1])
