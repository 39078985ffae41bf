"""The traced job: the device timeline from ``torch.profiler`` (CUDA
activity only, so that the host runs at its own pace), and the
benchmark's own spans around the calls into each layer of
``ocean_torch.system`` and around every dense LU factorization (host
clock, with the matrix order).

From them: the device's busy time, kernel time by name, each LU's order
and device time, and the device's idle gaps by the innermost stage span
the host was in ("gd_loop" outside every span). An LU's device time is
that of the device operations it launched: the CUDA runtime calls that
the trace records inside the LU's host span give their correlation ids,
and those ids the kernels and memsets of the factorization. The
profiler's host clock is the wall clock (``time.time_ns``). Times are in
seconds from the profiler's start.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import List

import torch

# the stage functions of ``ocean_torch.system`` a span is put around,
# by the name of the span
STAGES = {"solve_ns": "ns_newton", "_primal_ode": "primal_ode",
          "adjoint_rhs": "adjoint_rhs", "_adjoint_mu": "adjoint_ode",
          "_adjoint_sources": "point_sources",
          "adjoint_operators": "adjoint_assemble",
          "solve_adjoint_system": "adjoint_solve", "cost": "cost",
          "reduced_gradient": "gradient"}


class Spans:
    """Host spans around the stage functions and around
    ``torch.linalg.lu_factor_ex``, recorded while ``active``."""

    def __init__(self, system):
        self.system = system
        self.active = False
        self.host = []            # (name, start_s, end_s), wall clock
        self.lu = []              # (n, batch, start_ns, end_ns)
        self._orig = {}
        for fn_name, span in STAGES.items():
            fn = getattr(system, fn_name, None)
            if fn is not None:
                self._orig[fn_name] = fn
                setattr(system, fn_name, self._wrap(span, fn))
        self._lu = torch.linalg.lu_factor_ex
        torch.linalg.lu_factor_ex = self._wrap_lu(self._lu)

    def _wrap(self, span, fn):
        def timed(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            t0 = time.time_ns()
            try:
                return fn(*args, **kw)
            finally:
                self.host.append((span, t0, time.time_ns()))
        return timed

    def _wrap_lu(self, fn):
        def lu(a, *args, **kw):
            if not (self.active and a.is_cuda):
                return fn(a, *args, **kw)
            t0 = time.time_ns()
            try:
                return fn(a, *args, **kw)
            finally:
                n = int(a.shape[-1])
                self.lu.append((n, a.numel() // (n * n), t0, time.time_ns()))
        return lu

    def restore(self):
        for name, fn in self._orig.items():
            setattr(self.system, name, fn)
        torch.linalg.lu_factor_ex = self._lu


def merge(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [s, e]."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def lu_device_seconds(lu_spans, launches, device_ops) -> list:
    """(n, batch, device seconds) of each LU: ``lu_spans`` (n, batch,
    start_ns, end_ns) on the host clock, ``launches`` (start_ns,
    correlation id) of the runtime calls, sorted, and ``device_ops``
    correlation id → [(start_s, end_s)] of the device operations."""
    starts = [t for t, _ in launches]
    out = []
    for n, batch, a, b in lu_spans:
        ivs = [iv for _, c in launches[bisect.bisect_left(starts, a):
                                       bisect.bisect_right(starts, b)]
               for iv in device_ops.get(c, ())]
        out.append((n, batch, sum(e - s for s, e in merge(ivs))))
    return out


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: list            # (name, start_s, end_s)
    spans: list              # (name, start_s, end_s)
    lu: list                 # (n, batch, device seconds)

    def busy_intervals(self) -> list:
        return merge((k[1], k[2]) for k in self.kernels)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def time_by_kernel(self) -> dict:
        out = {}
        for name, s, e in self.kernels:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def kernels_named(self, names: List[str]) -> dict:
        """Device seconds and launches of each kernel whose name contains
        one of ``names``: name → (seconds, launches)."""
        out = {}
        for name, s, e in self.kernels:
            for n in names:
                if n in name:
                    sec, cnt = out.get(n, (0.0, 0))
                    out[n] = (sec + e - s, cnt + 1)
        return out

    def idle_gaps(self) -> dict:
        """Seconds the device sat idle inside the window, by the innermost
        span the host was in at each gap's midpoint."""
        busy = self.busy_intervals()
        edges = ([(0.0, 0.0)] + [tuple(b) for b in busy]
                 + [(self.window_s, self.window_s)])
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        out = {}
        for (_, e0), (s1, _) in zip(edges[:-1], edges[1:]):
            e0, s1 = max(e0, 0.0), min(s1, self.window_s)
            if s1 <= e0:
                continue
            mid = 0.5 * (e0 + s1)
            name = "gd_loop"
            for sp in reversed(spans[max(0, bisect.bisect_right(starts, mid)
                                         - 64):
                                     bisect.bisect_right(starts, mid)]):
                if sp[2] >= mid:
                    name = sp[0]
                    break
            out[name] = out.get(name, 0.0) + (s1 - e0)
        return out


def read(prof, spans: Spans, window_s: float, wall0_ns: int) -> Trace:
    """A Trace from a stopped profiler and the spans of the same job;
    ``wall0_ns`` is the wall clock at the profiler's start."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    kernels, launches, device_ops = [], [], {}
    for ev in res.events():
        if str(ev.device_type()).endswith("CUDA"):
            k = (ev.name(), (ev.start_ns() - t0) * 1e-9,
                 (ev.end_ns() - t0) * 1e-9)
            kernels.append(k)
            device_ops.setdefault(ev.correlation_id(), []).append(k[1:])
        elif ev.correlation_id():
            launches.append((ev.start_ns(), ev.correlation_id()))
    launches.sort()
    host = [(n, (a - wall0_ns) * 1e-9, (b - wall0_ns) * 1e-9)
            for n, a, b in spans.host]
    lu = lu_device_seconds(spans.lu, launches, device_ops)
    return Trace(window_s, kernels, host, lu)


def breakdown(tr: Trace) -> dict:
    top = sorted(tr.time_by_kernel().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}

