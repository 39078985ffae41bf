"""Exact slice sums of the Ozaki segment sum through the CUDA kernel
``csrc/segment_sum.cu`` (the port of ``ocean_jax/ops/psum_pallas.py``).

``ozaki_slice_sums`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs ``ozaki_slice_sums_plain``, the
same slicing with integer ``index_add_``. Both return the exact int64
per-segment sums of the 8 slices; ``ops.scatter.ozaki_segment_sum``
recombines them in float64.
"""

from __future__ import annotations

import torch

from .. import kernels

SLICES = 8

# int segment_sum_launch(ids, values, scale, acc, M, D, S, stream)
_ARGTYPES = ([kernels.VOIDP] * 4 + [kernels.LONG, kernels.INT, kernels.INT,
                                    kernels.VOIDP])


def slice_weight(k: int) -> float:
    """The weight 2^-(7+8k) of slice k."""
    return 2.0 ** -(7 + 8 * k)


def ozaki_slice_sums_plain(seg_ids: torch.Tensor, values: torch.Tensor,
                           scale: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (S, 8, D) int64."""
    M, D = values.shape
    ids = seg_ids.to(torch.int64)
    acc = torch.zeros(num_segments + 1, SLICES, D, dtype=torch.int64,
                      device=values.device)
    r = values / scale
    for k in range(SLICES):
        g = 2.0 ** (7 + 8 * k)
        c = torch.round(r * g)                 # round half to even
        acc[:, k].index_add_(0, ids, c.to(torch.int64))
        r = r - c / g                          # exact
    return acc[:num_segments]


def ozaki_slice_sums(seg_ids: torch.Tensor, values: torch.Tensor,
                     scale: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums of the 8 integer slices of values / scale.

    seg_ids (M,) int in [0, S] (S = num_segments: dropped padding bin);
    values (M, D) float64; scale (D,) float64 powers of two ≥ max|values|
    per column → acc (S, 8, D) int64 with
    Σ_k acc[:, k] · 2^-(7+8k) · scale = the segment sums to 2^-64·scale
    per value."""
    if all(t.device.type == "cpu" for t in (seg_ids, values, scale)):
        return ozaki_slice_sums_plain(seg_ids, values, scale, num_segments)
    ids = seg_ids.to(torch.int64).contiguous()
    values, scale = values.contiguous(), scale.contiguous()
    kernels.require_cuda("segment_sum", ids, values, scale)
    if values.dtype != torch.float64 or scale.dtype != torch.float64:
        raise ValueError("segment_sum: float64 values and scale required")
    M, D = values.shape
    if ids.shape != (M,) or scale.shape != (D,):
        raise ValueError("segment_sum: bad shapes")
    fn = kernels.function("segment_sum", "segment_sum_launch", _ARGTYPES)
    acc = torch.zeros(num_segments, SLICES, D, dtype=torch.int64,
                      device=values.device)
    status = fn(ids.data_ptr(), values.data_ptr(), scale.data_ptr(),
                acc.data_ptr(), M, D, num_segments,
                kernels.stream_ptr(values.device))
    kernels.check_launch("segment_sum", status)
    kernels.LAUNCHES["segment_sum"] += 1
    return acc
