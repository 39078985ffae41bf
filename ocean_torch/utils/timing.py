"""Timing utilities (port of ``ocean_jax/utils/timing.py``), and the
program's own spans and host-sync counter.

CUDA work is asynchronous: ``sync`` waits for the devices that the
tensors of a nested structure live on, so a host clock read after it
includes their work. ``Timer`` wraps the reference's wall-clock spans.

Spans and syncs. ``span(name, **attrs)`` marks a stage of the program,
as a context manager (``with span("ns_newton") as s: ...;
s.set(iterations=n)``) or as a decorator (``@span("cost")``).
``count(rounds=n)`` adds to an attribute of every open span.
``to_host(t)`` is the one way the hot path reads a device value on the
host, and ``sync`` the one way it waits for the device: each call counts
as one host sync of the innermost open span, on the CPU too, where it
waits for nothing. ``to_host_async(t)`` queues a copy into page-locked
host memory and does not wait: its values may be read only after a
``sync`` of the device. Recording is on exactly while a ``torch.profiler``
session runs (``torch.autograd._profiler_enabled()``): then each span is
kept as a ``SpanRecord``, opens a ``torch.profiler.record_function``
range of the same name, and Python's garbage collections inside a span
are recorded as ``gc`` spans. Off, a span costs that one check and
records nothing; one opened without attributes allocates nothing.
``recorded()`` returns the record, ``clear()`` empties it. The record
lives in this module, for the one thread that drives the program.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import time
from typing import List, Optional

import numpy as np
import torch

_recording = torch.autograd._profiler_enabled


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):          # NamedTuples too
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync(tree) -> None:
    """Wait for the CUDA devices that the tensors of ``tree`` (a tensor,
    or dicts, lists, tuples and dataclasses of them) live on, or for
    ``tree`` itself where it is a ``torch.device``; nothing to wait for
    on the CPU. Counted as one host sync."""
    _RECORD.count_sync()
    if isinstance(tree, torch.device):
        devs = {tree} if tree.type == "cuda" else set()
    else:
        devs = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in devs:
        torch.cuda.synchronize(dev)


def to_host(t: torch.Tensor):
    """``t`` on the host, counted as one host sync: a 0-d tensor as a
    Python number (``t.item()``: float, int or bool by dtype), any other
    as ``t.cpu().numpy()`` (which shares a CPU tensor's memory)."""
    _RECORD.count_sync()
    return t.item() if t.dim() == 0 else t.cpu().numpy()


def to_host_async(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array, without a host sync (not
    counted). A CUDA tensor is copied into a block of page-locked memory
    from PyTorch's caching host allocator, queued on the current stream:
    the values are there once the device has reached the copy, so read
    them after a ``sync`` of the device. The allocator hands the block
    back only once the copy is done, and stream order keeps later writes
    to ``t``'s memory behind it. A CPU tensor is ``t.numpy()``, sharing
    its memory, as ``to_host`` gives it."""
    if not t.is_cuda:
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host.numpy()


class Timer:
    """Context manager: ``with Timer() as t: ...; t.elapsed`` (seconds)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@dataclasses.dataclass
class SpanRecord:
    """One recorded span. ``start_ns`` and ``end_ns`` (0 while open) are
    ``time.time_ns()``, the clock of ``torch.profiler``'s host events;
    ``parent`` is the index of the enclosing span in the record (-1 at a
    root); ``job`` numbers the enclosing ``gd_job`` in the order the
    record saw them, and ``iteration`` is the ``i`` of the enclosing
    ``gd_iteration`` (-1 outside one), so the spans of one GD iteration
    share (job, iteration); ``syncs`` counts the host syncs made while it
    was the innermost open span."""
    name: str
    start_ns: int
    parent: int
    job: int
    iteration: int
    attrs: dict
    end_ns: int = 0
    syncs: int = 0


class _Record:
    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.open: list = []        # (index, SpanRecord), innermost last
        self.jobs = 0
        self.gc_open: Optional[tuple] = None

    def push(self, name: str, attrs: dict) -> tuple:
        start = time.time_ns()
        if self.open:
            parent, p = self.open[-1]
            job, it = p.job, p.iteration
        else:
            parent, job, it = -1, -1, -1
            if name != "gc" and _on_gc not in gc.callbacks:
                gc.callbacks.append(_on_gc)
        if name == "gd_job":
            job, self.jobs = self.jobs, self.jobs + 1
        elif name == "gd_iteration":
            it = attrs.get("i", -1)
        # made before its index is taken: a collection it triggers
        # records its own span first, inside this one's time
        rec = SpanRecord(name, start, parent, job, it, attrs)
        entry = (len(self.spans), rec)
        self.spans.append(rec)
        self.open.append(entry)
        return entry

    def pop(self, entry: tuple) -> None:
        entry[1].end_ns = time.time_ns()
        if entry in self.open:
            del self.open[self.open.index(entry):]
        if not self.open and _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)

    def count_sync(self) -> None:
        if self.open:
            self.open[-1][1].syncs += 1

    def clear(self) -> None:
        self.spans, self.open, self.jobs, self.gc_open = [], [], 0, None
        if _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)


_RECORD = _Record()


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start" and _recording() and _RECORD.open:
        _RECORD.gc_open = _RECORD.push("gc",
                                       {"generation": info["generation"]})
    elif phase == "stop" and _RECORD.gc_open is not None:
        _RECORD.pop(_RECORD.gc_open)
        _RECORD.gc_open = None


class _Decorates:
    __slots__ = ()

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kw):
            with span(name, **attrs):
                return fn(*args, **kw)
        return spanned


class _Span(_Decorates):
    __slots__ = ("name", "attrs", "_entry", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._entry = _RECORD.push(self.name, dict(self.attrs))
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _RECORD.pop(self._entry)
        return False

    def set(self, **attrs) -> None:
        """Set small integer attributes of the open span."""
        self._entry[1].attrs.update(attrs)


class _Idle(_Decorates):
    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_IDLE = {}        # name → the idle span of that name without attributes


def span(name: str, **attrs):
    """A span named ``name`` with small integer attributes, as a context
    manager or a decorator; recorded only while a ``torch.profiler``
    session runs."""
    if _recording():
        return _Span(name, attrs)
    if attrs:
        return _Idle(name, attrs)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Idle(name, attrs)
    return idle


def count(**counts) -> None:
    """Add each count to the attribute of that name of every open span:
    the work done inside each (the adjoint's refinement rounds)."""
    for _, rec in _RECORD.open:
        for k, n in counts.items():
            rec.attrs[k] = rec.attrs.get(k, 0) + n


def recorded() -> List[SpanRecord]:
    """The spans recorded since the last ``clear``, in the order they
    opened (the record itself is kept)."""
    return list(_RECORD.spans)


def clear() -> None:
    """Empty the record."""
    _RECORD.clear()
