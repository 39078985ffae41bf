"""Timing utilities (port of ``ocean_jax/utils/timing.py``).

CUDA work is asynchronous: ``sync`` waits for the devices that the
tensors of a nested structure live on, so a host clock read after it
includes their work. ``Timer`` wraps the reference's wall-clock spans.
"""

from __future__ import annotations

import dataclasses
import time

import torch


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
    or dicts, lists, tuples and dataclasses of them) live on; nothing to
    wait for on the CPU."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Context manager: ``with Timer() as t: ...; t.elapsed`` (seconds)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
