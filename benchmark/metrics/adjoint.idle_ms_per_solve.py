"""Device idle an adjoint solve: milliseconds in which no device
operation ran inside the program's ``adjoint`` spans of the traced job
(``system._solve_adjoint_flagged``: the right-hand side, the operator's
assembly and the solve), over their number."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.idle_ms(ctx, "adjoint")
    return None if got is None else got[0] / len(got[1])
