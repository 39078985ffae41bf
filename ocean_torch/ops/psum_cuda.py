"""Exact slice sums of the Ozaki segment sum through the CUDA kernel
``csrc/segment_sum.cu`` (the port of ``ocean_jax/ops/psum_pallas.py``).

``ozaki_slice_sums`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs ``ozaki_slice_sums_plain``, the
same slicing with integer ``index_add_``. Both return the exact int64
per-segment sums of the 8 slices; ``ops.scatter.ozaki_segment_sum``
recombines them in float64.

The kernel does not evaluate the plain version's formula literally: it
multiplies by exact reciprocals instead of dividing, rounds by adding and
subtracting 1.5·2^52, packs two slices into one int for its warp sums and
sums each (32 consecutive points, id) group before it adds to a counter.
``slices_by_reciprocal``, ``pack_slices``/``unpack_slice_sums`` and
``ozaki_slice_sums_grouped`` are that arithmetic in plain PyTorch, so
that tests without a card can hold it to the plain version bit for bit.
Nothing on the paths calls them.
"""

from __future__ import annotations

import torch

from .. import kernels

SLICES = 8

_ROUND = 1.5 * 2.0 ** 52        # x + _ROUND - _ROUND = rint(x), |x| < 2^51

# int segment_sum_launch(ids, values, scale, inv_scale, acc, M, D, S, stream)
_ARGTYPES = ([kernels.VOIDP] * 5 + [kernels.LONG, kernels.INT, kernels.INT,
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


def slices_by_reciprocal(values: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """The 8 slices of values / scale as the kernel computes them:
    (8, M, D) int32. Multiplication by the exact reciprocal of each power
    of two replaces the division (a column whose scale has no finite
    reciprocal is divided), and x + 1.5·2^52 - 1.5·2^52 replaces
    round(x)."""
    inv = 1.0 / scale
    r = torch.where(torch.isinf(inv), values / scale, values * inv)
    out = []
    for k in range(SLICES):
        t = r * 2.0 ** (7 + 8 * k) + _ROUND
        # the kernel reads the low 32 bits of t: the integer, two's
        # complement
        out.append(t.view(torch.int64).to(torch.int32))
        r = r - (t - _ROUND) * slice_weight(k)
    return torch.stack(out)


def pack_slices(c: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 slices → (4, ...) int32, slices 2i and 2i+1 in one
    int: c[2i] + c[2i+1]·2^16."""
    return c[0::2] + c[1::2] * 65536


def unpack_slice_sums(p: torch.Tensor) -> torch.Tensor:
    """Sums of up to 32 packed ints (4, ...) int32 → the 8 slice sums
    (8, ...) int32. |Σ c| ≤ 32·129 < 2^15, so the low 16 bits, read as a
    signed number, are Σ c[2i], and the rest is Σ c[2i+1]·2^16."""
    low = ((p & 0xFFFF) ^ 0x8000) - 0x8000           # sign-extend 16 bits
    high = (p - low) // 65536
    return torch.stack([low, high], dim=1).reshape((SLICES,) + p.shape[1:])


def ozaki_slice_sums_grouped(seg_ids: torch.Tensor, values: torch.Tensor,
                             scale: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """The kernel's order of summation in plain PyTorch: the packed slices
    of each (32 consecutive points, id) group are summed in int32 first,
    unpacked, and the group sums added to the int64 counters second:
    (S, 8, D) int64, equal to ``ozaki_slice_sums_plain``."""
    M, D = values.shape
    S = num_segments
    ids = seg_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < S)
    packed = pack_slices(slices_by_reciprocal(values, scale))[:, valid]
    tile = torch.arange(M, device=values.device)[valid] // kernels.WARP
    keys, group = torch.unique(tile * S + ids[valid], return_inverse=True)
    sums = torch.zeros(4, keys.numel(), D, dtype=torch.int32,
                       device=values.device)
    sums.index_add_(1, group, packed)
    acc = torch.zeros(S, SLICES, D, dtype=torch.int64, device=values.device)
    acc.index_add_(0, keys % S,
                   unpack_slice_sums(sums).to(torch.int64).transpose(0, 1))
    return acc


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
    inv_scale = 1.0 / scale          # exact: scale is a power of two
    fn = kernels.function("segment_sum", "segment_sum_launch", _ARGTYPES)
    acc = torch.zeros(num_segments, SLICES, D, dtype=torch.int64,
                      device=values.device)
    status = fn(ids.data_ptr(), values.data_ptr(), scale.data_ptr(),
                inv_scale.data_ptr(), acc.data_ptr(), M, D, num_segments,
                kernels.stream_ptr(values.device))
    kernels.check_launch("segment_sum", status)
    kernels.LAUNCHES["segment_sum"] += 1
    return acc
