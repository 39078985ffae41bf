"""The program's own spans of the traced job, on the device trace's axis.

``ocean_torch.utils.timing`` records the program's spans while a
``torch.profiler`` session runs: the harness's traced job. They are on
the wall clock (``time.time_ns``, integer ns); ``tracing.Trace`` holds
device operations and the benchmark's own spans in seconds from the
profiler's start. Each of the benchmark's ``ns_newton`` spans (around
``system.solve_ns``) encloses exactly one of the program's, so the
median of the pairs' start offsets places the program's spans on the
trace's axis; the offsets' spread (max − min, the misfit) goes to
standard error.

The record may hold several jobs (cells traced one after the other in
one process): the traced job is the ``gd_job`` whose ``ns_newton`` spans
pair one to one with the benchmark's, with the smallest misfit (the
latest of equal ones: a job repeated exactly fits as well at any shift),
and a misfit under the shortest benchmark span. Nothing to read (None)
where the program records no spans, or where no job pairs so.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
import sys
from typing import List, Optional

from benchmark import tracing


def program_record() -> list:
    """The program's span record, empty where the program keeps none."""
    try:
        from ocean_torch.utils import timing
        return timing.recorded()
    except (ImportError, AttributeError):
        return []


@dataclasses.dataclass
class Job:
    spans: list          # the job's SpanRecords, in the order they opened
    offset_ns: int       # a program time minus this is trace time (ns)
    misfit_ns: int
    pairs: int

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name and s.end_ns]

    def placed(self, name: str) -> list:
        """(start_s, end_s) of the spans called ``name``, trace axis."""
        return [((s.start_ns - self.offset_ns) * 1e-9,
                 (s.end_ns - self.offset_ns) * 1e-9)
                for s in self.named(name)]


def traced_job(trace: Optional[tracing.Trace],
               record: Optional[list] = None) -> Optional[Job]:
    """The traced job of ``record`` (the program's, by default) joined to
    ``trace``; None where nothing pairs."""
    if trace is None:
        return None
    record = program_record() if record is None else record
    bench = sorted((s, e) for name, s, e in trace.spans
                   if name == "ns_newton")
    if not record or not bench:
        return None
    jobs = {}
    for s in record:
        if s.job >= 0:
            jobs.setdefault(s.job, []).append(s)
    best = None
    for spans in jobs.values():
        prog = sorted(s.start_ns for s in spans
                      if s.name == "ns_newton" and s.end_ns)
        if len(prog) != len(bench):
            continue
        offsets = [p - round(b * 1e9) for p, (b, _) in zip(prog, bench)]
        misfit = max(offsets) - min(offsets)
        if best is None or misfit <= best.misfit_ns:
            best = Job(spans, statistics.median_low(offsets), misfit,
                       len(prog))
    shortest = min(e - s for s, e in bench) * 1e9
    if best is None or best.misfit_ns >= shortest:
        return None
    print(f"program spans: {best.pairs} ns_newton pairs, misfit "
          f"{best.misfit_ns * 1e-3:.1f} us", file=sys.stderr)
    return best


def idle_inside(busy: List[list], intervals, window_s: float) -> float:
    """Seconds of the union of ``intervals`` (clipped to [0, window_s])
    in which no device operation ran; ``busy`` is the trace's merged,
    sorted busy intervals."""
    starts = [b[0] for b in busy]
    idle = 0.0
    for s, e in tracing.merge((max(s, 0.0), min(e, window_s))
                              for s, e in intervals if e > 0.0
                              and s < window_s):
        covered = 0.0
        for bs, be in busy[max(0, bisect.bisect_right(starts, s) - 1):
                           bisect.bisect_left(starts, e)]:
            covered += max(0.0, min(e, be) - max(s, bs))
        idle += (e - s) - covered
    return idle


def idle_ms(ctx, name: str) -> Optional[tuple]:
    """(device idle inside the traced job's ``name`` spans in ms, the
    spans); None where nothing pairs or no such span ran."""
    job = traced_job(ctx.trace)
    if job is None:
        return None
    spans = job.named(name)
    if not spans:
        return None
    tr = ctx.trace
    return (1e3 * idle_inside(tr.busy_intervals(), job.placed(name),
                              tr.window_s), spans)
