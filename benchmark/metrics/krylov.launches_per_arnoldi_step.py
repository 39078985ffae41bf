"""Kernel launches an Arnoldi step of the Krylov layer: the device
kernels of the traced job that start inside the program's ``fgmres``
spans (``solve/krylov.py``), placed on the trace's axis, over the
``arnoldi_steps`` of the outermost of those spans. Memory copies and
sets are not kernels and are left out.

``tracing.Trace`` keeps the device's operations, not the host's runtime
calls; each kernel of the port is its own launch, so the kernels that
start inside a span are the launches made in it: an ``fgmres`` span
opens and closes with a host read of a norm, which drains the device.
Nothing to read where the program records no such span."""

import bisect

from benchmark import program_spans

NOT_KERNELS = ("Memcpy", "Memset")


def outermost(spans):
    """The spans (SpanRecords, in the order they opened) that no other
    of them encloses."""
    out, end = [], None
    for s in spans:
        if end is None or s.end_ns > end:
            out.append(s)
            end = s.end_ns
    return out


def read(ctx):
    job = program_spans.traced_job(ctx.trace)
    if job is None:
        return None
    outer = outermost(job.named("fgmres"))
    steps = sum(s.attrs.get("arnoldi_steps", 0) for s in outer)
    if not steps:
        return None
    ivs = sorted(((s.start_ns - job.offset_ns) * 1e-9,
                  (s.end_ns - job.offset_ns) * 1e-9) for s in outer)
    starts = [s for s, _ in ivs]
    launches = 0
    for name, t, _ in ctx.trace.kernels:
        if name.startswith(NOT_KERNELS):
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ivs[i][1]:
            launches += 1
    return launches / steps
