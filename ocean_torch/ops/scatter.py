"""Segment reductions for the point-source accumulation (port of
``ocean_jax/ops/scatter.py``).

The adjoint RHS sums per-point, basis-weighted contributions (M, 12) into
per-cell sums (S, 12). Three reductions, each with the JAX package's
contract (ids in [0, S]; id == S is a dropped padding bin):

* ``binned_segment_sum``: chunked one-hot products (``torch.matmul``, as
  the JAX package leaves them to XLA),
* ``sorted_segment_sum``: sort + float64 ``torch.cumsum`` + differences at
  the segment boundaries. The JAX package needs a triangular-matmul
  ``exact_cumsum`` because the TPU's cumsum is not float64; PyTorch's is,
  on the CPU and the card,
* ``ozaki_segment_sum``: exact integer sums of 8 slices of each value,
  recombined in float64; the sums run in the CUDA kernel
  ``csrc/segment_sum.cu`` on the card (``ops/psum_cuda.py``).
"""

from __future__ import annotations

import torch

from .psum_cuda import SLICES, ozaki_slice_sums, slice_weight


def pow2_scale(values: torch.Tensor) -> torch.Tensor:
    """Per-column power of two ≥ max|values| (1 for an all-zero column):
    dividing by it is exact and leaves every entry in [-1, 1]."""
    maxabs = values.abs().amax(dim=0)
    return torch.exp2(torch.ceil(torch.log2(
        torch.where(maxabs > 0, maxabs, torch.ones_like(maxabs)))))


def binned_segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                       num_segments: int, chunk: int = 8192) -> torch.Tensor:
    """Segment sum through chunked one-hot contractions: (S, D)."""
    m, d = values.shape
    bins = torch.arange(num_segments + 1, device=values.device)
    acc = values.new_zeros(num_segments + 1, d)
    for i in range(0, m, chunk):
        onehot = (seg_ids[i:i + chunk, None] == bins[None, :]).to(
            values.dtype)
        acc = acc + onehot.T @ values[i:i + chunk]
    return acc[:num_segments]


def sorted_segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum through sort + float64 cumulative sum: (S, D)."""
    d = values.shape[1]
    ids_s, order = torch.sort(seg_ids, stable=True)
    csum = torch.cumsum(values[order], dim=0)
    csum = torch.cat([values.new_zeros(1, d), csum])
    bins = torch.arange(num_segments + 1, dtype=ids_s.dtype,
                        device=values.device)
    starts = torch.searchsorted(ids_s, bins)               # (S+1,)
    return csum[starts[1:]] - csum[starts[:-1]]


def ozaki_segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Exact segment sum of (M, D) values → (S, D) in the values' dtype.

    Each value is divided by its column's power-of-two ``scale`` and cut
    into 8 integer slices c_k = round(r·2^(7+8k)) (round half to even);
    the per-segment sums of each slice are exact integers, and only the
    float64 recombination Σ_k acc_k·2^-(7+8k)·scale rounds. The slicing
    leaves ≤ 2^-64·scale per value. Bit-reproducible on the card."""
    v = values.to(torch.float64)
    scale = pow2_scale(v)
    acc = ozaki_slice_sums(seg_ids, v, scale, num_segments)   # (S, 8, D)
    out = acc[:, 0].to(torch.float64) * slice_weight(0)
    for k in range(1, SLICES):
        out = out + acc[:, k].to(torch.float64) * slice_weight(k)
    return (out * scale).to(values.dtype)
