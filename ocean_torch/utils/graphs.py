"""The CUDA-graph capture policy of the replayed solver loops: the chord
Newton step (``solve/newton.py::ChordGraph``) and the FGMRES cycle
(``solve/krylov.py::_CycleGraph``).

A graph replays its kernels on the tensors it read when it was captured,
so it serves only the objects it was made from and the constants it was
made at. ``cached`` keeps each consumer's newest graph on each device,
keyed by those objects, held by weak reference (a new object that reuses
a dead one's id is not served), and those constants. A new capture takes
the private memory pool and the side stream of the graph it replaces,
and is made before that one is freed, so the pool stays alive and is
reused by every capture of the consumer. Each consumer has a pool and a
stream of its own, so each capture stream holds its own cuBLAS
workspace. Off a CUDA device nothing is captured and the bodies run
eagerly; the newest value is kept all the same, and with it the tensors
it reads (a problem's dense factor), until a new one replaces it or
``release`` drops it: a gradient-descent job on the CPU releases the
CPU's values when it ends.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple, Sequence

import torch


class _Held(NamedTuple):
    value: object
    refs: tuple              # weak references to the objects it read
    consts: tuple
    pool: object
    stream: object


_NEWEST: dict = {}           # (consumer, torch.device) → _Held


def cached(consumer: str, device: torch.device, objs: tuple, consts: tuple,
           make: Callable):
    """The newest value ``consumer`` made on ``device``, or a new one,
    ``make(capture)``, unless that one was made from these very objects
    and at these constants. ``capture(bodies, warm_up)`` returns one
    replay callable per body (``_capture``), the bodies themselves off a
    CUDA device."""
    key = (consumer, device)
    old = _NEWEST.get(key)
    if (old is not None and old.consts == consts
            and all(ref() is o for ref, o in zip(old.refs, objs))):
        return old.value
    pool = stream = None
    if device.type == "cuda":
        pool = old.pool if old is not None else torch.cuda.graph_pool_handle()
        stream = old.stream if old is not None else torch.cuda.Stream(device)

        def capture(bodies, warm_up):
            return _capture(bodies, warm_up, pool, stream, device)
    else:
        def capture(bodies, warm_up):
            return tuple(bodies)
    _NEWEST[key] = _Held(make(capture), tuple(weakref.ref(o) for o in objs),
                         consts, pool, stream)
    return _NEWEST[key].value


def newest(consumer: str, device: torch.device):
    """The value ``cached`` holds for ``consumer`` on ``device``."""
    return _NEWEST[(consumer, device)].value


def release(device: torch.device) -> None:
    """Drop every value ``cached`` holds on ``device``."""
    for key in [k for k in _NEWEST if k[1] == device]:
        del _NEWEST[key]


def _capture(bodies: Sequence[Callable], warm_up: Callable, pool,
             stream: torch.cuda.Stream, device: torch.device) -> tuple:
    """Capture each body as a CUDA graph in ``pool`` on ``stream``, after
    one eager ``warm_up`` there, and return the graphs' replays."""
    stream.wait_stream(torch.cuda.current_stream(device))
    replays = []
    with torch.cuda.stream(stream):
        # cuBLAS binds its workspace (32 MiB on Hopper, outside the
        # graph's pool) to a stream on first use, which a capture forbids
        warm_up()
        for body in bodies:
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            body()
            g.capture_end()
            replays.append(g.replay)
    torch.cuda.current_stream(device).wait_stream(stream)
    return tuple(replays)
