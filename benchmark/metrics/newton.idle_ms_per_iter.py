"""Device idle a Newton iteration: milliseconds in which no device
operation ran inside the program's ``ns_newton`` spans of the traced job
(``system.solve_ns``), over the Newton iterations those spans carry
(``iterations``, continuation rungs included)."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.idle_ms(ctx, "ns_newton")
    if got is None:
        return None
    ms, spans = got
    iterations = sum(s.attrs.get("iterations", 0) for s in spans)
    return ms / iterations if iterations else None
