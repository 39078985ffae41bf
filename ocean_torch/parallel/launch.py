"""Start a group of ranks on one host: what ``jax.devices()`` gives a JAX
program for free.

    results = spawn(fn, world_size)                 # nccl, a card a rank
    results = spawn(fn, world_size, "gloo", "cpu")  # gloo on the CPU

runs ``fn(rank, world_size, device, *args)`` in ``world_size`` processes
(``torch.multiprocessing``, spawn start method) with the default process
group initialized, and returns every rank's return value, in rank order.
The rendezvous is a file in a temporary directory (``file://``), so no
TCP port is taken and parallel launches cannot collide. Rank r runs on
``cuda:{r % device_count}`` with ``device="cuda"`` (ranks may share a card
on gloo; nccl refuses two ranks on one card, so ``spawn`` raises first),
the default, which raises without a card; and on the CPU, one thread
each, with ``device="cpu"`` and ``backend="gloo"``. The group is
destroyed when ``fn`` returns or raises; a rank that raises fails the
launch (the others are stopped). ``fn`` must be a top-level function of
an importable module; its return value is saved with ``torch.save`` and
read with ``weights_only=True``, so it holds tensors, numbers, strings,
lists, tuples and dicts.

On several cards with ``torchrun --nproc_per_node=N``, each rank calls
``torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))`` and
``dist.init_process_group("nccl")`` itself, then the step builders of
``sharding.py``.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 600.0


def rank_device(rank: int, world_size: int, backend: str,
                device: str = "cuda") -> torch.device:
    """The device of ``rank``: ``cuda:{rank % device_count}`` or the CPU.
    nccl needs a card of its own for each rank."""
    kind = torch.device(device).type
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices only")
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("ocean_torch: CUDA is not available; pass "
                           "device='cpu' with the gloo backend")
    n = torch.cuda.device_count()
    if backend == "nccl" and world_size > n:
        raise ValueError(f"nccl: {world_size} ranks on {n} card(s); nccl "
                         "refuses two ranks on one card (use gloo)")
    return torch.device("cuda", rank % n)


def _worker(rank, fn, world_size, backend, device, args, tmp, timeout_s):
    dev = rank_device(rank, world_size, backend, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    # the timeout makes ranks that wait in different collectives fail
    # instead of hanging
    dist.init_process_group(
        backend=backend, init_method="file://" + os.path.join(tmp, "rv"),
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str = "nccl", device: str = "cuda",
          args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks
    and return their results, in rank order (see the module docstring)."""
    rank_device(0, world_size, backend, device)      # refuse before starting
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(fn, world_size, backend, device, args, tmp,
                                timeout_s), nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world_size)]
