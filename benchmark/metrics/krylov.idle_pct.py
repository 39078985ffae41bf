"""Share of the program's ``fgmres`` spans (``solve/krylov.py``) of the
traced job in which no operation ran on the device: the idle inside
their union over its length. Nothing to read where the program records
no such span."""

from benchmark import program_spans, tracing


def read(ctx):
    job = program_spans.traced_job(ctx.trace)
    if job is None:
        return None
    tr = ctx.trace
    spans = [[max(s, 0.0), min(e, tr.window_s)]
             for s, e in tracing.merge(job.placed("fgmres"))]
    length = sum(e - s for s, e in spans if e > s)
    if length <= 0:
        return None
    idle = program_spans.idle_inside(tr.busy_intervals(), spans, tr.window_s)
    return 100.0 * idle / length
